"""Classic-NeRF view-dependent MLP ("FlexibleNeRF") as an ``nn.Module``.

The submodules carry the names of the reference's torch checkpoints, so a
nerf-pytorch ``state_dict`` loads with ``load_state_dict`` as it is. For
``num_layers: 8, hidden_size: 128, skip_connect_every: 3, L_xyz=10,
L_dir=4``:

    layer1.weight        (128, 63)
    layers_xyz.{0,1,2}   (128, 128)
    fc_alpha             (1, 128)
    fc_feat              (128, 128)
    layers_dir.0         (64, 155)      # 155 = 128 feat + 27 dir
    fc_rgb               (3, 64)

and ``fc_out (4, 128)`` in place of the last four without view directions.
The xyz trunk has ``num_layers // 2`` layers; trunk layer i > 0
concatenates gamma(xyz) to its input when ``i % skip_connect_every == 0``,
which never fires at this depth.

This is the module route (``fused: off`` and configs the fused kernel does
not take). With a bf16 compute type it rounds the encoding and every layer's
output to bf16, as a bf16 dense layer does; the fused kernel
(``ops/classic_fused_cuda.py``) keeps f32 accumulators and rounds operands
only. The reference has both routes, and the port mirrors each.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.positional_encoding import positional_encoding
from ..train.config import FlexibleNeRFConfig

__all__ = ["FlexibleNeRF", "FlexibleNeRFConfig", "dense_layer"]


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def dense_layer(in_features: int, out_features: int, generator=None) -> nn.Linear:
    """An ``nn.Linear`` initialised as the reference's dense layer: a
    lecun-normal weight (a normal truncated at +-2 sigma and rescaled so that
    its standard deviation is in^-1/2; 0.8796... is the standard deviation of
    the unit normal so cut) and a zero bias."""
    lin = nn.Linear(in_features, out_features)
    sigma = in_features**-0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=sigma, a=-2 * sigma, b=2 * sigma,
                              generator=generator)
        lin.bias.zero_()
    return lin


class FlexibleNeRF(nn.Module):
    """(xyz (..., 3), viewdirs (..., 3)) -> (rgb logits (..., 3), raw sigma
    (...,)), f32 whatever the compute type."""

    def __init__(self, config: FlexibleNeRFConfig = FlexibleNeRFConfig(),
                 generator=None):
        super().__init__()
        self.config = cfg = config
        h = cfg.hidden_size
        self.layer1 = dense_layer(cfg.dim_xyz, h, generator)
        self.layers_xyz = nn.ModuleList()
        for i in range(cfg.trunk_depth - 1):
            width = h + cfg.dim_xyz if self._skip(i) else h
            self.layers_xyz.append(dense_layer(width, h, generator))
        if cfg.use_viewdirs:
            self.fc_alpha = dense_layer(h, 1, generator)
            self.fc_feat = dense_layer(h, h, generator)
            self.layers_dir = nn.ModuleList(
                [dense_layer(h + cfg.dim_dir, h // 2, generator)])
            self.fc_rgb = dense_layer(h // 2, 3, generator)
        else:
            self.fc_out = dense_layer(h, 4, generator)

    def _skip(self, i: int) -> bool:
        return i % self.config.skip_connect_every == 0 and i > 0

    @property
    def linears(self):
        """The layers in the fused kernel's order: layer1, layers_xyz.*,
        fc_alpha, fc_feat, layers_dir.0, fc_rgb."""
        return [self.layer1, *self.layers_xyz, self.fc_alpha, self.fc_feat,
                self.layers_dir[0], self.fc_rgb]

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.config.compute_dtype != "bfloat16":
            return x @ lin.weight.T + lin.bias
        r = _round_bf16
        return r(r(r(x) @ r(lin.weight).T) + r(lin.bias))

    def forward(self, xyz: torch.Tensor, viewdirs=None):
        cfg = self.config
        bf16 = cfg.compute_dtype == "bfloat16"
        enc_xyz = positional_encoding(xyz, cfg.num_encoding_fn_xyz,
                                      cfg.include_input_xyz, cfg.log_sampling_xyz)
        if bf16:
            enc_xyz = _round_bf16(enc_xyz)
        x = torch.relu(self._dense(self.layer1, enc_xyz))
        for i, lin in enumerate(self.layers_xyz):
            if self._skip(i):
                x = torch.cat([x, enc_xyz], dim=-1)
            x = torch.relu(self._dense(lin, x))
        if cfg.use_viewdirs:
            if viewdirs is None:
                raise ValueError("use_viewdirs=True requires viewdirs input")
            enc_dir = positional_encoding(viewdirs, cfg.num_encoding_fn_dir,
                                          cfg.include_input_dir,
                                          cfg.log_sampling_dir)
            if bf16:
                enc_dir = _round_bf16(enc_dir)
            sigma = self._dense(self.fc_alpha, x)
            feat = torch.relu(self._dense(self.fc_feat, x))
            y = torch.cat([feat, enc_dir], dim=-1)
            y = torch.relu(self._dense(self.layers_dir[0], y))
            rgb = self._dense(self.fc_rgb, y)
        else:
            out = self._dense(self.fc_out, x)
            rgb, sigma = out[..., :3], out[..., 3:]
        return rgb, sigma[..., 0]
