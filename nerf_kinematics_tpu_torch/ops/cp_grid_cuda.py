"""Stand-alone CP-grid encoder: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``nerf_kinematics_tpu/ops/cp_grid_pallas.py::cp_encode_pallas``
(forward). The occupancy sweep and ``density_grid`` reach it through
``NGPModel.encode``. Kernel source: ``csrc/cp_encode.cu``. Forward only: the
gradient kernel is ported with training.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cp_grid import CPGridConfig, cp_encode_stacked

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


def cp_encode_cuda(lines: torch.Tensor, x: torch.Tensor,
                   cfg: CPGridConfig) -> torch.Tensor:
    """Encode ``x`` in [0,1]^3, shape ``(..., 3)`` -> ``(..., L*C)`` f32.
    ``lines``: stacked ``(L, 3, T, C)``. A CUDA tensor goes through the
    kernel; a CPU tensor through the plain version."""
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
