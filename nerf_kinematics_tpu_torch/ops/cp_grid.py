"""CP-factorized multiresolution grid encoder -- configuration and the plain
PyTorch encoder.

Per level ``l`` and axis ``a`` a line table ``U_la`` of ``table_size`` rows and
``C`` channels; a point's feature at that level is the componentwise product of
the three linearly interpolated line features,

    f_l(x, y, z) = U_lx[x] * U_ly[y] * U_lz[z]   in R^C,

and the levels are concatenated. Levels finer than the table fold their cell
indices into it (periodically, or through an integer hash).

The reference builds ``(N, table_size)`` two-hot operands and contracts them on
a matrix unit because its target has no fast gather. A GPU has one: the encoder
here is two indexed loads per axis and level. The weights, their rounding and
the summation are the reference's, so both produce the same numbers:

    p   = clip(clip(x, 0, 1) * R, 0, R - 1e-4)              (f32)
    pm  = p mod F (folded level) or p (un-folded level)
    t0  = floor(pm);  rows (t0, t0 + 1), the second wrapped to 0 at F
    w0  = 1 - (pm - t0);  w1 = 1 - ((t0 + 1) - pm)          (the tent)

With ``use_bf16`` both weights and the table entries are rounded to bf16 before
the multiply, the two products are summed in f32, and the three axes are
multiplied in f32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class CPGridConfig:
    n_levels: int = 4
    n_components: int = 32  # C, feature channels per level
    base_resolution: int = 64
    max_resolution: int = 512
    # Each level's line table has exactly ``table_size`` rows. Levels whose
    # resolution R_l reaches it wrap their cell index into the table.
    table_size: int = 256
    # Points per chunk of the plain encoder (bounds its temporaries).
    chunk_size: int = 16384
    # bf16 weights and table entries, f32 accumulation.
    use_bf16: bool = True
    # Fold mode for levels finer than the table: "periodic" wraps indices
    # mod the fold width; "hash" sends each cell through an integer mix so
    # colliding cells are pseudo-random instead of periodic.
    fold: str = "periodic"
    # Per-level fold-width cap (0 = off): a level with R >= fold_cap folds
    # into min(table_size, fold_cap rounded up to 16) rows.
    fold_cap: int = 0

    @property
    def resolutions(self) -> Sequence[int]:
        if self.n_levels == 1:
            return [self.base_resolution]
        b = math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )
        return [
            int(round(self.base_resolution * (b**l))) for l in range(self.n_levels)
        ]

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_components

    def level_rows(self, R: int) -> int:
        """Line-table rows reachable at level resolution ``R`` (rounded up to
        a multiple of 16, as the reference's kernels slice them)."""
        if self.fold_cap and R >= self.fold_cap:
            return min(self.table_size, -(-self.fold_cap // 16) * 16)
        if R >= self.table_size:
            return self.table_size
        return min(self.table_size, -(-(R + 1) // 16) * 16)

    def level_fold(self, R: int) -> int:
        """Fold modulus for level resolution ``R``: 0 if the level never
        wraps, else the row count its indices wrap into."""
        rows = self.level_rows(R)
        return rows if R >= rows else 0

    def level_rows_dup(self, R: int) -> int:
        """Row count of the reference kernels' duplicated-wrap-row operand
        (row F a copy of row 0). The port indexes the parameter table
        directly and wraps the index instead; kept so that both packages
        describe a configuration identically."""
        F = self.level_fold(R)
        if F and self.fold == "periodic":
            return -(-(F + 1) // 16) * 16
        return self.level_rows(R)

    @property
    def dup_rows(self) -> int:
        return max(
            self.table_size,
            max(self.level_rows_dup(R) for R in self.resolutions),
        )

    @property
    def n_params(self) -> int:
        return self.n_levels * 3 * self.table_size * self.n_components


def fold_salt(level: int, axis: int) -> int:
    """Per-(level, axis) hash salt, wrapped to signed int32."""
    v = ((3 * level + axis + 1) * 374761393) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def level_clip_max(R: int) -> float:
    """Upper clip of a level coordinate, ``R - 1e-4`` rounded to f32 (what
    the reference's f32 clip compares against)."""
    return float(np.float32(R - 1e-4))


def hash_fold_indices(i0: torch.Tensor, table: int, salt: int) -> torch.Tensor:
    """Integer cell index -> hashed table row (int64 tensor in [0, table)).

    ``i0``: tensor of non-negative integer-valued cell indices (any dtype).
    Knuth multiplicative mix + xor-shift in wrapping int32, low 24 bits,
    mod ``table``.
    """
    h = (i0.to(torch.int32) + salt) * (-1640531527)
    h = h ^ (h >> 15)
    h = h * (-2048144789)
    h = h ^ (h >> 13)
    return ((h & 0xFFFFFF) % table).to(torch.int64)


def _hash_fold_ref(i0: int, table: int, salt: int) -> int:
    """Scalar python mirror of :func:`hash_fold_indices` (exact)."""

    def i32(v: int) -> int:
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= (1 << 31) else v

    h = i32((int(i0) + salt) * -1640531527)
    h = i32(h ^ (h >> 15))
    h = i32(h * -2048144789)
    h = i32(h ^ (h >> 13))
    return (h & 0xFFFFFF) % table


def _round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def level_taps(x_axis: torch.Tensor, cfg: CPGridConfig, level: int, axis: int):
    """Rows and weights of the two taps of one level and axis.

    ``x_axis``: (N,) f32 unit coordinates, already clipped to [0, 1]. Returns
    ``(r0, r1, w0, w1)``: int64 rows and f32 weights (bf16-rounded when
    ``cfg.use_bf16``)."""
    R = cfg.resolutions[level]
    F = cfg.level_fold(R)
    p = torch.clamp(x_axis * float(R), 0.0, level_clip_max(R))
    if F and cfg.fold == "hash":
        i0 = torch.floor(p)
        w = p - i0
        salt = fold_salt(level, axis)
        r0 = hash_fold_indices(i0, F, salt)
        r1 = hash_fold_indices(i0 + 1.0, F, salt)
        # Both cells on one row: the reference's two-hot operand adds the
        # two weights in f32 before it is rounded.
        same = r0 == r1
        w0 = torch.where(same, (1.0 - w) + w, 1.0 - w)
        w1 = torch.where(same, torch.zeros_like(w), w)
    else:
        pm = torch.fmod(p, float(F)) if F else p
        t0 = torch.floor(pm)
        w0 = 1.0 - (pm - t0)
        w1 = 1.0 - ((t0 + 1.0) - pm)
        r0 = t0.to(torch.int64)
        r1 = r0 + 1
        if F:
            r1 = torch.where(r1 >= F, r1 - F, r1)
    if cfg.use_bf16:
        w0, w1 = _round_bf16(w0), _round_bf16(w1)
    return r0, r1, w0, w1


def cp_encode_stacked(stacked: torch.Tensor, x: torch.Tensor,
                      cfg: CPGridConfig, point_grads: bool = False) -> torch.Tensor:
    """Plain PyTorch encoder over the stacked ``(L, 3, T, C)`` table:
    ``x`` in [0,1]^3, shape ``(..., 3)`` -> ``(..., L*C)`` f32.

    As in the reference, the tent weights are computed from a detached ``x``
    unless ``point_grads`` is set: by default no gradient reaches the points
    (training treats them as data), and ``point_grads=True`` keeps the tents
    differentiable in ``x`` (pose refinement). The tables' gradient is the
    same either way."""
    orig = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, 3).to(torch.float32), 0.0, 1.0)
    if not point_grads:
        x = x.detach()
    tables = _round_bf16(stacked) if cfg.use_bf16 else stacked.to(torch.float32)
    feats = []
    for l in range(cfg.n_levels):
        us = []
        for a in range(3):
            r0, r1, w0, w1 = level_taps(x[:, a], cfg, l, a)
            tab = tables[l, a]
            us.append(w0[:, None] * tab[r0] + w1[:, None] * tab[r1])
        feats.append(us[0] * us[1] * us[2])
    return torch.cat(feats, dim=-1).reshape(*orig, cfg.out_dim)


def init_stacked_lines(cfg: CPGridConfig, generator=None,
                       device=None) -> torch.Tensor:
    """``(L, 3, T, C)`` table initialised 0.5 +- 0.1 so the three-way product
    starts near 0.1 with sign diversity."""
    shape = (cfg.n_levels, 3, cfg.table_size, cfg.n_components)
    noise = torch.randn(shape, generator=generator, dtype=torch.float32)
    return (0.5 + 0.1 * noise).to(device)


def cp_encode_ref(lines, x, cfg: CPGridConfig) -> np.ndarray:
    """Scalar numpy oracle in float64 (folded / periodic / hash semantics,
    no bf16 rounding). ``lines``: (L, 3, T, C) array or list of (3, T, C)."""
    T = cfg.table_size
    x = np.clip(np.asarray(x, np.float64).reshape(-1, 3), 0.0, 1.0)
    out = np.zeros((x.shape[0], cfg.out_dim))
    for l, R in enumerate(cfg.resolutions):
        tab = np.asarray(lines[l], np.float64)
        F = cfg.level_fold(R)
        m = F or T
        hashed = cfg.fold == "hash" and F
        for i, p in enumerate(x):
            prod = np.ones(cfg.n_components)
            for a in range(3):
                pos = min(p[a] * R, R - 1e-4)
                i0 = int(np.floor(pos))
                w = pos - i0
                if hashed:
                    s = fold_salt(l, a)
                    r0 = _hash_fold_ref(i0, m, s)
                    r1 = _hash_fold_ref(i0 + 1, m, s)
                else:
                    r0, r1 = i0 % m, (i0 + 1) % m
                prod = prod * ((1 - w) * tab[a, r0] + w * tab[a, r1])
            out[i, l * cfg.n_components : (l + 1) * cfg.n_components] = prod
    return out
