"""Stand-alone CP-grid encoder: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``nerf_kinematics_tpu/ops/cp_grid_pallas.py::cp_encode_pallas``,
forward and VJP. The occupancy sweep, ``density_grid`` and the unfused train
step reach it through ``NGPModel.encode``. Kernel source:
``csrc/cp_encode.cu``.

Gradient contract (the reference's): the exact gradient for ``lines``, none
for the positions, on both devices. The lines gradient lands in parameter
layout: the wrap tap of a periodic folded level adds into row 0, a row F < T
gets nothing from its own level, and a hash fold that sends both cells to one
row adds both weights there.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cp_grid import CPGridConfig, _round_bf16, cp_encode_stacked, level_taps

REF_CHUNK = 1 << 18  # points per chunk of the plain version


def _check_lines(lines, cfg: CPGridConfig):
    shape = (cfg.n_levels, 3, cfg.table_size, cfg.n_components)
    if tuple(lines.shape) != shape:
        raise ValueError(f"lines: shape {tuple(lines.shape)}, expected {shape}")


def cp_encode_cuda_ref(lines: torch.Tensor, x: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`cp_encode_cuda`, in chunks so the
    ``(N, C)`` temporaries stay small."""
    _check_lines(lines, cfg)
    orig = x.shape[:-1]
    flat = x.reshape(-1, 3)
    outs = [
        cp_encode_stacked(lines, flat[s : s + REF_CHUNK], cfg)
        for s in range(0, flat.shape[0], REF_CHUNK)
    ]
    if not outs:
        return flat.new_zeros((*orig, cfg.out_dim))
    return torch.cat(outs).reshape(*orig, cfg.out_dim)


def _encode(lines, x, cfg: CPGridConfig) -> torch.Tensor:
    if not x.is_cuda:
        return cp_encode_cuda_ref(lines, x, cfg)
    _check_lines(lines, cfg)
    orig = x.shape[:-1]
    flat = x.reshape(-1, 3).contiguous()
    cuda_lib.check_tensor(flat, "x", (None, 3))
    cuda_lib.check_tensor(lines, "lines", tuple(lines.shape), flat.device)
    n = flat.shape[0]
    out = torch.empty((n, cfg.out_dim), dtype=torch.float32, device=flat.device)
    if n:
        lib = cuda_lib.load_library()
        cp = cuda_lib.cp_levels(cfg)
        code = lib.nkt_cp_encode(
            flat.data_ptr(), lines.data_ptr(), out.data_ptr(), n,
            ctypes.byref(cp), cuda_lib.sm_count(flat.device),
            cuda_lib.current_stream(flat.device),
        )
        cuda_lib.LAUNCHES["cp_encode"] += 1
        cuda_lib.raise_on_error(code, "cp_encode")
    return out.reshape(*orig, cfg.out_dim)


@torch.no_grad()
def cp_encode_cuda_bwd_ref(lines: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, cfg: CPGridConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`cp_encode_cuda_bwd`: the cotangent
    ``g`` (..., L*C) of the encoding of ``x`` (..., 3) -> ``dlines``
    (L, 3, T, C). Per level and axis the cotangent times the other two axes'
    line features is rounded to bf16 (when ``cfg.use_bf16``) and added,
    weighted by the two tent weights, to the two tapped rows."""
    _check_lines(lines, cfg)
    C = cfg.n_components
    flat = torch.clamp(x.reshape(-1, 3).to(torch.float32), 0.0, 1.0)
    gf = g.reshape(-1, cfg.out_dim)
    tables = _round_bf16(lines) if cfg.use_bf16 else lines.to(torch.float32)
    dl = torch.zeros_like(tables)
    for s in range(0, flat.shape[0], REF_CHUNK):
        xs, gs = flat[s : s + REF_CHUNK], gf[s : s + REF_CHUNK]
        for l in range(cfg.n_levels):
            taps, us = [], []
            for a in range(3):
                r0, r1, w0, w1 = level_taps(xs[:, a], cfg, l, a)
                tab = tables[l, a]
                taps.append((r0, r1, w0, w1))
                us.append(w0[:, None] * tab[r0] + w1[:, None] * tab[r1])
            g_l = gs[:, l * C : (l + 1) * C]
            others = [us[1] * us[2], us[0] * us[2], us[0] * us[1]]
            for a in range(3):
                gu = g_l * others[a]
                if cfg.use_bf16:
                    gu = _round_bf16(gu)
                r0, r1, w0, w1 = taps[a]
                # r1 of a periodic folded level has wrapped to row 0; a hash
                # fold onto one row has w1 = 0 and both weights in w0.
                dl[l, a].index_add_(0, r0, w0[:, None] * gu)
                dl[l, a].index_add_(0, r1, w1[:, None] * gu)
    return dl


@torch.no_grad()
def cp_encode_cuda_bwd(lines: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """The VJP of :func:`cp_encode_cuda` in ``lines``: (L, 3, T, C). A CUDA
    tensor goes through the kernel; a CPU tensor through the plain version."""
    if not x.is_cuda:
        return cp_encode_cuda_bwd_ref(lines, x, g, cfg)
    _check_lines(lines, cfg)
    flat = x.reshape(-1, 3).contiguous()
    n = flat.shape[0]
    gf = g.reshape(-1, cfg.out_dim).contiguous()
    cuda_lib.check_tensor(flat, "x", (None, 3))
    cuda_lib.check_tensor(gf, "g", (n, cfg.out_dim), flat.device)
    cuda_lib.check_tensor(lines, "lines", tuple(lines.shape), flat.device)
    dl = torch.zeros_like(lines)
    if n:
        lib = cuda_lib.load_library()
        cp = cuda_lib.cp_levels(cfg)
        code = lib.nkt_cp_encode_bwd(
            flat.data_ptr(), lines.data_ptr(), gf.data_ptr(), dl.data_ptr(), n,
            ctypes.byref(cp), cuda_lib.sm_count(flat.device),
            cuda_lib.current_stream(flat.device),
        )
        cuda_lib.LAUNCHES["cp_encode_bwd"] += 1
        cuda_lib.raise_on_error(code, "cp_encode_bwd")
    return dl


class _CPEncode(torch.autograd.Function):
    """:func:`cp_encode_cuda` under autograd: exact ``dlines``, no gradient
    for the positions."""

    @staticmethod
    def forward(ctx, lines, x, cfg):
        ctx.cfg = cfg
        ctx.save_for_backward(lines, x)
        return _encode(lines, x, cfg)

    @staticmethod
    def backward(ctx, g):
        lines, x = ctx.saved_tensors
        return cp_encode_cuda_bwd(lines, x, g, ctx.cfg), None, None


def cp_encode_cuda(lines: torch.Tensor, x: torch.Tensor,
                   cfg: CPGridConfig) -> torch.Tensor:
    """Encode ``x`` in [0,1]^3, shape ``(..., 3)`` -> ``(..., L*C)`` f32.
    ``lines``: stacked ``(L, 3, T, C)``. A CUDA tensor goes through the
    kernel; a CPU tensor through the plain version. Differentiable in
    ``lines`` only."""
    if torch.is_grad_enabled() and lines.requires_grad:
        return _CPEncode.apply(lines, x.detach(), cfg)
    with torch.no_grad():
        return _encode(lines, x, cfg)
