"""Instant-NGP-class model: CP-grid encoder + small MLPs.

    Density model: 3 --[CP grid L levels x C]--> L*C --[MLP]--> density_out
    Color model:   3 --[SH deg 4]--> 16, concat density feats --[MLP]--> 3

Density sigma = exp(clamped first channel); RGB = sigmoid of the returned
logits (applied by the compositing).

This module is the unfused path: the occupancy sweep, ``density_grid`` and
the ``ngp.fused: off`` train step use it. The render path goes through the fused kernels
(``ops/ngp_fused_cuda.py``). The two differ numerically on purpose, as in
the reference: here every ``Dense`` layer with a bf16 compute type rounds
its output to bf16; the fused kernels keep f32 accumulators.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch
from torch import nn

from ..ops.cp_grid import CPGridConfig, init_stacked_lines
from ..ops.cp_grid_cuda import cp_encode_cuda
from ..ops.sh import sh_encode


@dataclass(frozen=True)
class HashGridConfig:
    """Dimensions of the hash-grid encoder (``encoder: hash``). The encoder
    itself is not ported yet; the fields are kept so every YAML config loads
    to the same values in both packages."""

    n_levels: int = 8
    n_features: int = 4
    log2_table_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


@dataclass(frozen=True)
class NGPConfig:
    # Positional encoder: "auto" (the kernel-backed CP encoder when a CUDA
    # device exists, the plain one otherwise), "cp" / "cp_pallas" (the CP
    # grid; both names select the stacked (L, 3, T, C) table here, and the
    # second keeps the reference's spelling so its YAML files load
    # unchanged), "hash" (not ported yet).
    encoder: str = "cp"
    grid: HashGridConfig = field(default_factory=HashGridConfig)
    cp: CPGridConfig = field(default_factory=CPGridConfig)
    density_width: int = 64
    density_layers: int = 3  # layers of the density MLP, output included
    density_out: int = 16
    color_width: int = 64
    color_layers: int = 4
    sh_degree: int = 4
    # Occupancy acceleration (ops/occupancy.py).
    use_occupancy: bool = False
    occ_resolution: int = 96
    occ_update_every: int = 256
    # Proposal lookup: "hull" (visual-hull proxy from the three 2D
    # pair-projections), "grid", "projected". Only "hull" is ported.
    occ_proposal: str = "hull"
    occ_bins: int = 64
    occ_floor: float = 1e-2
    occ_incremental_cells: int = 65536
    occ_full_every: int = 2048
    # Scene contraction for scene bounds above 2: "auto" | "on" | "off".
    # Contracted scenes are not ported yet.
    contraction: str = "auto"
    contract_inner: float = 0.0
    # Compute type of the unfused MLPs ("float32" | "bfloat16"); params f32.
    compute_dtype: str = "float32"
    # Fused point pipeline: "auto" = on whenever the cp_pallas encoder is
    # active; "on" / "off" force it.
    fused: str = "auto"
    fused_block: int = 0  # a tile size of the reference's kernels; unused here
    # One-call train objective (ops/ngp_fused_cuda.py::ngp_fused_train_cf):
    # "auto" = on whenever the step shape is eligible, "on" = require it,
    # "off" = always autograd, "full" = the whole-step kernel (not ported).
    fused_train: str = "auto"

    @classmethod
    def from_cfg(cls, d: dict) -> "NGPConfig":
        d = dict(d)
        grid_keys = set(HashGridConfig.__dataclass_fields__)
        grid = HashGridConfig(**{k: v for k, v in d.items() if k in grid_keys})
        cp_keys = set(CPGridConfig.__dataclass_fields__) - grid_keys
        cp_kwargs = {k: v for k, v in d.items() if k in cp_keys}
        # Shared names (n_levels, base_resolution, max_resolution) configure
        # both encoders.
        shared = set(CPGridConfig.__dataclass_fields__) & grid_keys
        cp_kwargs.update({k: v for k, v in d.items() if k in shared})
        cp = CPGridConfig(**cp_kwargs)
        # Optional nested ``grid:`` / ``cp:`` sections override per encoder.
        if isinstance(d.get("grid"), dict):
            grid = dataclasses.replace(
                grid, **{k: v for k, v in d["grid"].items() if k in grid_keys}
            )
        if isinstance(d.get("cp"), dict):
            all_cp = set(CPGridConfig.__dataclass_fields__)
            cp = dataclasses.replace(
                cp, **{k: v for k, v in d["cp"].items() if k in all_cp}
            )
        own = set(cls.__dataclass_fields__) - {"grid", "cp"}
        return cls(grid=grid, cp=cp, **{k: v for k, v in d.items() if k in own})

    def resolved_encoder(self) -> str:
        if self.encoder != "auto":
            return self.encoder
        return "cp_pallas" if torch.cuda.is_available() else "cp"

    @property
    def encoding_dim(self) -> int:
        if self.resolved_encoder() == "hash":
            return self.grid.out_dim
        return self.cp.out_dim


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with the kernel stored (in, out), the
    reference's layout. With a bf16 compute type the operands are rounded to
    bf16, the products summed in f32, and both the product and the sum with
    the bias are rounded to bf16, as a bf16 dense layer does."""

    def __init__(self, in_features: int, out_features: int, bf16: bool = False,
                 generator=None):
        super().__init__()
        self.bf16 = bf16
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        # lecun-normal, the reference layer's default: a normal truncated at
        # +-2 sigma and rescaled so that its standard deviation is in^-1/2
        # (0.8796... is the standard deviation of the unit normal so cut).
        sigma = in_features**-0.5 / 0.87962566103423978
        nn.init.trunc_normal_(self.kernel, std=sigma, a=-2 * sigma, b=2 * sigma,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.bf16:
            return x @ self.kernel + self.bias
        r = lambda t: t.to(torch.bfloat16).to(torch.float32)
        y = r(r(x) @ r(self.kernel))
        return (y + r(self.bias)).to(torch.bfloat16)


class NGPModel(nn.Module):
    """(xyz in [0,1]^3, viewdir) -> (rgb logits, sigma). Parameter names
    follow the reference's tree: ``cp_lines``, ``density_{i}``,
    ``density_out``, ``color_{i}``, ``color_out`` (each with ``kernel`` and
    ``bias``)."""

    def __init__(self, config: NGPConfig = NGPConfig(), generator=None):
        super().__init__()
        self.config = cfg = config
        enc = cfg.resolved_encoder()
        if enc == "hash":
            raise NotImplementedError(
                "encoder: hash is not ported yet (ROADMAP: the hash encoder "
                "and contracted scenes)"
            )
        if enc not in ("cp", "cp_pallas"):
            raise ValueError(f"unknown encoder {enc!r}")
        self.cp_lines = nn.Parameter(init_stacked_lines(cfg.cp, generator))
        bf16 = cfg.compute_dtype == "bfloat16"
        widths = [cfg.cp.out_dim] + [cfg.density_width] * (cfg.density_layers - 1)
        self.density_names = [f"density_{i}" for i in range(cfg.density_layers - 1)]
        self.density_names.append("density_out")
        outs = widths[1:] + [cfg.density_out]
        for name, i, o in zip(self.density_names, widths, outs):
            self.add_module(name, Dense(i, o, bf16, generator))
        c_in = cfg.density_out + cfg.sh_degree**2
        widths = [c_in] + [cfg.color_width] * (cfg.color_layers - 1)
        self.color_names = [f"color_{i}" for i in range(cfg.color_layers - 1)]
        self.color_names.append("color_out")
        outs = widths[1:] + [3]
        for name, i, o in zip(self.color_names, widths, outs):
            self.add_module(name, Dense(i, o, bf16, generator))

    def encode(self, xyz: torch.Tensor) -> torch.Tensor:
        return cp_encode_cuda(self.cp_lines, xyz, self.config.cp)

    def density(self, xyz: torch.Tensor):
        """sigma and the geometry feature vector at unit-cube points."""
        h = self.encode(xyz)
        for name in self.density_names[:-1]:
            h = torch.relu(getattr(self, name)(h))
        h = getattr(self, self.density_names[-1])(h)
        # Log-space density, clamped (exp(15) ~ 3.3e6); f32 whatever the
        # MLP's compute type.
        sigma = torch.exp(torch.clamp(h[..., 0].to(torch.float32), -15.0, 15.0))
        return sigma, h

    def forward(self, xyz: torch.Tensor, viewdirs=None):
        sigma, feat = self.density(xyz)
        if viewdirs is None:
            viewdirs = torch.zeros_like(xyz)
            viewdirs[..., 2] = 1.0
        sh = sh_encode(viewdirs, self.config.sh_degree)
        h = torch.cat([feat.to(torch.float32), sh], dim=-1)
        for name in self.color_names[:-1]:
            h = torch.relu(getattr(self, name)(h))
        rgb = getattr(self, self.color_names[-1])(h).to(torch.float32)
        return rgb, sigma  # rgb: pre-sigmoid logits
