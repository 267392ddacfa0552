"""Multiresolution hash-grid encoding, the Instant-NGP encoder
(tiny-cuda-nn's GridEncoding: Nmin 16, F 4, T 2^19, L 8). A level whose
dense grid fits in the table is indexed densely (row-major
``x + n (y + n z)``, n = res + 1); finer levels use the spatial hash
``x ^ y * 2654435761 ^ z * 805459861 (mod T)``.

Counterpart of ``nerf_kinematics_tpu/ops/hashgrid.py``, whose encoder is an
XLA gather and not a Pallas kernel; this one is plain PyTorch. The hash is
computed in int64: the primes are below 2^32 and the corner coordinates
below 2^12, so the products are exact, and since T divides 2^32 their low
log2(T) bits are those of the reference's wrapping uint32 arithmetic.

The table's gradient is summed in a fixed order (:class:`_Gather`): the
taps sorted by table row with a stable sort, each row's taps added in point
order by a segmented sum. A gather's backward through ``index_add_`` would
accumulate with atomics on a GPU, and two steps from one state would not
give the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

# Spatial-hash multipliers (dimension 0 is the identity).
_PRIMES = (1, 2654435761, 805459861)

# Corner offsets of the unit cube: (8, 3).
_CORNERS = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], dtype=np.int64)


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 8  # L
    n_features: int = 4  # F
    log2_table_size: int = 19  # T = 2^19
    base_resolution: int = 16  # Nmin
    max_resolution: int = 2048  # Nmax

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def per_level_scale(self) -> float:
        """Growth factor b = exp((ln Nmax - ln Nmin) / (L - 1))."""
        if self.n_levels == 1:
            return 1.0
        return math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1))

    @property
    def resolutions(self) -> Sequence[int]:
        b = self.per_level_scale
        return [int(math.floor(self.base_resolution * (b**l)))
                for l in range(self.n_levels)]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def n_params(self) -> int:
        return self.n_levels * self.table_size * self.n_features


def init_table(cfg: HashGridConfig, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
    """(L, T, F) f32 table, uniform in [-1e-4, 1e-4] (the standard NGP
    init), drawn from ``generator`` on its device."""
    dev = generator.device if generator is not None else None
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, device=dev)
    return u * 2e-4 - 1e-4


def _level_indices(c: torch.Tensor, res: int, table_size: int) -> torch.Tensor:
    """Table rows of integer corner coordinates ``c`` (..., 3), int64."""
    n = res + 1
    if n**3 <= table_size:
        return c[..., 0] + n * (c[..., 1] + n * c[..., 2])
    h = c[..., 0] * _PRIMES[0]
    h = h ^ (c[..., 1] * _PRIMES[1])
    h = h ^ (c[..., 2] * _PRIMES[2])
    return h & (table_size - 1)


# A row of 1, 2 or 4 f32 features as one element of this type.
_ROW_TYPES = {4: torch.int32, 8: torch.int64, 16: torch.complex128}


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a (rows, F) f32 tensor: each row moved as one element
    of 4, 8 or 16 bytes where it fits (a 1-D gather), else row by row. On a
    GPU the 16-byte form ran 15 times faster at 67 M taps than the row
    gather of ``t[idx]`` or ``index_select`` (scripts/torch_hash_profile.py).
    The bytes are copied, never computed on."""
    width = t.shape[1] * t.element_size()
    kind = _ROW_TYPES.get(width) if t.dtype == torch.float32 else None
    if kind is None or not t.is_contiguous() or t.data_ptr() % width:
        return t[idx]
    return t.view(kind).reshape(-1)[idx].view(torch.float32).reshape(-1, t.shape[1])


class _Gather(torch.autograd.Function):
    """``table[idx]`` for a (rows, F) table and int64 ``idx`` (M,), whose
    backward sums each row's cotangents in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return take_rows(table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return table_grad(grad, idx, ctx.rows), None


def table_grad(grad: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The transpose of the gather: (rows, F) with row r the sum of the
    ``grad`` rows (M, F) whose ``idx`` is r, in ascending order of their
    position in ``idx``: the same bits on every run."""
    # 32-bit keys halve the radix sort's passes; the rows fit
    order = torch.argsort(idx.to(torch.int32) if rows < 2**31 else idx, stable=True)
    keys, counts = torch.unique_consecutive(idx[order], return_counts=True)
    sums = torch.segment_reduce(take_rows(grad.contiguous(), order), "sum", lengths=counts)
    out = torch.zeros((rows, grad.shape[1]), dtype=grad.dtype, device=grad.device)
    out[keys] = sums
    return out


def hash_encode(table: torch.Tensor, x: torch.Tensor, cfg: HashGridConfig) -> torch.Tensor:
    """Points x in [0, 1]^3 (..., 3) -> (..., L * F) features. ``table``:
    (L, T, F). Points outside the box are clamped onto it; on the box's
    upper face (x = 1) a level takes cell res - 1 with weight 1, so it
    interpolates toward vertex ``res``, as the reference does."""
    orig_shape = x.shape[:-1]
    L, T, F = table.shape
    x = torch.clamp(x.reshape(-1, 3), 0.0, 1.0)
    corners = torch.as_tensor(_CORNERS, device=x.device)  # (8, 3)
    rows, weights = [], []
    for l, res in enumerate(cfg.resolutions):
        xs = x * res
        # clamp before taking the weight: x == 1 gives x0 = res - 1, w = 1
        x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, res - 1)
        w = xs - x0  # (N, 3) in [0, 1]
        idx = _level_indices(x0[:, None, :] + corners[None], res, T)  # (N, 8)
        rows.append(idx + l * T)
        cw = torch.where(corners[None] == 1, w[:, None, :], 1.0 - w[:, None, :])
        weights.append(cw.prod(dim=-1))  # (N, 8)
    idx = torch.stack(rows, dim=1).reshape(-1)  # (N * L * 8,)
    feats = _Gather.apply(table.reshape(L * T, F), idx).reshape(-1, L, 8, F)
    out = (feats * torch.stack(weights, dim=1)[..., None]).sum(dim=2)  # (N, L, F)
    return out.reshape(*orig_shape, L * F)


def hash_encode_ref(table, x, cfg: HashGridConfig) -> np.ndarray:
    """Slow, plainly correct scalar version in numpy (float64), the spec
    :func:`hash_encode` is held to."""
    table = np.asarray(table)
    x = np.clip(np.asarray(x, np.float64).reshape(-1, 3), 0.0, 1.0)
    N = x.shape[0]
    out = np.zeros((N, cfg.out_dim), np.float64)
    for l, res in enumerate(cfg.resolutions):
        n = res + 1
        dense = n**3 <= cfg.table_size
        for i in range(N):
            xs = x[i] * res
            x0 = np.minimum(np.floor(xs).astype(np.int64), res - 1)
            w = xs - x0
            acc = np.zeros(cfg.n_features)
            for c in range(8):
                off = _CORNERS[c]
                cc = x0 + off
                if dense:
                    idx = cc[0] + n * (cc[1] + n * cc[2])
                else:
                    idx = ((cc[0] * _PRIMES[0]) ^ (cc[1] * _PRIMES[1])
                           ^ (cc[2] * _PRIMES[2])) & (cfg.table_size - 1)
                weight = np.prod(np.where(off == 1, w, 1.0 - w))
                acc += weight * table[l, idx]
            out[i, l * cfg.n_features:(l + 1) * cfg.n_features] = acc
    return out
