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

from ..utils import profiling
from . import cuda_lib
from .cp_grid import (CPGridConfig, _round_bf16, contraction, cp_encode_stacked,
                      level_taps, nonfinite_dlines, poison_features)

REF_CHUNK = 1 << 18  # points per chunk of the plain version
DLINES_PARTIAL_BYTES = 1 << 28  # cap of the line-table gradient's chunk sums
DLINES_MIN_POINTS = 512         # points a chunk of that kernel takes at least
# what the kernels refuse (cudaErrorInvalidValue), for the error message
ENCODE_REFUSED = "no channel slice of a level's three tables fits one block's shared memory"
DLINES_REFUSED = ("the line-table gradient takes an even number of components "
                  "and tables of which a 16-channel slice fits one block's "
                  "shared memory")


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
        cp_encode_stacked(lines, flat[s : s + REF_CHUNK], cfg, contract="level")
        for s in range(0, flat.shape[0], REF_CHUNK)
    ]
    if not outs:
        return flat.new_zeros((*orig, cfg.out_dim))
    return torch.cat(outs).reshape(*orig, cfg.out_dim)


def _encode(lines, x, cfg: CPGridConfig) -> torch.Tensor:
    if not x.is_cuda:
        return cp_encode_cuda_ref(lines, x, cfg)
    sp = profiling.begin("launch.cp_encode")
    _check_lines(lines, cfg)
    orig = x.shape[:-1]
    flat = x.reshape(-1, 3).contiguous()
    cuda_lib.check_tensor(flat, "x", (None, 3))
    cuda_lib.check_tensor(lines, "lines", tuple(lines.shape), flat.device)
    n = flat.shape[0]
    sc = profiling.begin("launch.scratch")
    out = torch.empty((n, cfg.out_dim), dtype=torch.float32, device=flat.device)
    profiling.end(sc)
    if not n:
        profiling.end(sp)
        return out.reshape(*orig, cfg.out_dim)
    lib = cuda_lib.load_library()
    cp = cuda_lib.cp_levels(cfg)
    sc = profiling.begin("launch.scratch")
    scratch = cuda_lib.nonfinite_scratch(cp, flat.device)
    profiling.end(sc)
    call = profiling.begin("launch.call")
    code = lib.nkt_cp_encode(
        flat.data_ptr(), lines.data_ptr(), out.data_ptr(), n,
        ctypes.byref(cp), cuda_lib.sm_count(flat.device),
        cuda_lib.current_stream(flat.device),
    )
    profiling.end(call)
    cuda_lib.launched(sp, "cp_encode", "bf16" if cfg.use_bf16 else "f32", n)
    cuda_lib.raise_on_error(code, "cp_encode", ENCODE_REFUSED)
    return out.reshape(*orig, cfg.out_dim)


@torch.no_grad()
def cp_encode_cuda_bwd_ref(lines: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, cfg: CPGridConfig,
                           contract: str = "level") -> torch.Tensor:
    """Plain PyTorch version of :func:`cp_encode_cuda_bwd`: the cotangent
    ``g`` (..., L*C) of the encoding of ``x`` (..., 3) -> ``dlines``
    (L, 3, T, C). Per level and axis the cotangent times the other two axes'
    line features is rounded to bf16 (when ``cfg.use_bf16``) and added,
    weighted by the two tent weights, to the two tapped rows. Non-finite
    values take the classes of the reference's dense contraction over the
    rows ``contract`` names (``cp_grid.CONTRACTS``): the stand-alone
    kernel's by default, ``"dup"`` for the fused kernels' gradients."""
    _check_lines(lines, cfg)
    C = cfg.n_components
    flat = torch.clamp(x.reshape(-1, 3).to(torch.float32), 0.0, 1.0)
    gf = g.reshape(-1, cfg.out_dim)
    tables = _round_bf16(lines) if cfg.use_bf16 else lines.to(torch.float32)
    dl = torch.zeros_like(tables)
    for s in range(0, flat.shape[0], REF_CHUNK):
        xs, gs = flat[s : s + REF_CHUNK], gf[s : s + REF_CHUNK]
        for l in range(cfg.n_levels):
            rows, dup = contraction(cfg, l, contract)
            taps, us = [], []
            for a in range(3):
                r0, r1, w0, w1 = level_taps(xs[:, a], cfg, l, a)
                tab = tables[l, a]
                taps.append((r0, r1, w0, w1))
                u = w0[:, None] * tab[r0] + w1[:, None] * tab[r1]
                us.append(poison_features(u, tab, r0, r1, rows, dup))
            g_l = gs[:, l * C : (l + 1) * C]
            others = [us[1] * us[2], us[0] * us[2], us[0] * us[1]]
            for a in range(3):
                gu = g_l * others[a]
                if cfg.use_bf16:
                    gu = _round_bf16(gu)
                r0, r1, w0, w1 = taps[a]
                # r1 of a periodic folded level has wrapped to row 0; a hash
                # fold onto one row has w1 = 0 and both weights in w0.
                part = torch.zeros_like(dl[l, a])
                part.index_add_(0, r0, w0[:, None] * gu)
                part.index_add_(0, r1, w1[:, None] * gu)
                nonfinite_dlines(part, gu, r0, r1, w0, w1, rows, dup)
                dl[l, a] += part
    return dl


def dlines_chunks(n: int, cfg: CPGridConfig, n_sm: int) -> int:
    """Point chunks of the line-table gradient kernel (``nkt_dlines_launch``):
    about one of its blocks (a chunk's level) an SM, at least
    ``DLINES_MIN_POINTS`` points a chunk, and the chunk sums
    (chunks x L x 3 x T x C f32) under ``DLINES_PARTIAL_BYTES``."""
    table = 3 * cfg.n_levels * cfg.table_size * cfg.n_components * 4
    want = max(1, -(-n_sm // cfg.n_levels))
    by_points = max(1, -(-n // DLINES_MIN_POINTS))
    by_memory = max(1, DLINES_PARTIAL_BYTES // table)
    return min(want, by_points, by_memory)


def dlines_scratch(n: int, cfg: CPGridConfig, device):
    """The chunk-sum scratch of the line-table gradient kernel over ``n``
    points and its chunk count (the kernel may take fewer chunks)."""
    chunks = dlines_chunks(n, cfg, cuda_lib.sm_count(device))
    rows = chunks if chunks > 1 else 0
    shape = (rows, cfg.n_levels, 3, cfg.table_size, cfg.n_components)
    return torch.empty(shape, dtype=torch.float32, device=device), chunks


@torch.no_grad()
def cp_encode_cuda_bwd(lines: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """The VJP of :func:`cp_encode_cuda` in ``lines``: (L, 3, T, C). A CUDA
    tensor goes through the kernel (the contraction of the tent with the
    cotangent on the tensor cores, its sum over the points in a fixed order:
    two calls give the same bits); a CPU tensor through the plain version."""
    if not x.is_cuda:
        return cp_encode_cuda_bwd_ref(lines, x, g, cfg)
    sp = profiling.begin("launch.cp_encode_bwd")
    _check_lines(lines, cfg)
    flat = x.reshape(-1, 3).contiguous()
    n = flat.shape[0]
    gf = g.reshape(-1, cfg.out_dim).contiguous()
    cuda_lib.check_tensor(flat, "x", (None, 3))
    cuda_lib.check_tensor(gf, "g", (n, cfg.out_dim), flat.device)
    cuda_lib.check_tensor(lines, "lines", tuple(lines.shape), flat.device)
    if not n:
        profiling.end(sp)
        return torch.zeros_like(lines)
    lib = cuda_lib.load_library()
    cp = cuda_lib.cp_levels(cfg)
    sc = profiling.begin("launch.scratch")
    dl = torch.empty_like(lines)
    partial, chunks = dlines_scratch(n, cfg, flat.device)
    scratch = cuda_lib.nonfinite_scratch(cp, flat.device)
    profiling.end(sc)
    call = profiling.begin("launch.call")
    code = lib.nkt_cp_encode_bwd(
        flat.data_ptr(), lines.data_ptr(), gf.data_ptr(), partial.data_ptr(),
        dl.data_ptr(), n, ctypes.byref(cp), chunks,
        cuda_lib.current_stream(flat.device),
    )
    profiling.end(call)
    cuda_lib.launched(sp, "cp_encode_bwd", "bf16" if cfg.use_bf16 else "f32", n)
    cuda_lib.raise_on_error(code, "cp_encode_bwd", DLINES_REFUSED)
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
