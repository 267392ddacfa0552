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
    ``cfg.use_bf16``). A NaN coordinate taps the rows of cell 0 with NaN
    weights: the reference's tent of a NaN is NaN on every row, and no index
    is made from a NaN. On a hash-folded level the reference makes an
    integer of the NaN (0) for both cells instead, so both taps are that
    cell's hashed row: its tent is NaN on that row only."""
    R = cfg.resolutions[level]
    F = cfg.level_fold(R)
    p = torch.clamp(x_axis * float(R), 0.0, level_clip_max(R))
    nan = torch.isnan(p)
    p = torch.where(nan, torch.zeros_like(p), p)
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
    if nan.any():
        w0 = torch.where(nan, torch.full_like(w0, float("nan")), w0)
        w1 = torch.where(nan, torch.full_like(w1, float("nan")), w1)
        if F and cfg.fold == "hash":
            r1 = torch.where(nan, r0, r1)
    return r0, r1, w0, w1


# -- non-finite values: what the reference's dense contractions give --------
#
# The reference contracts a tent over a level's rows with the table (forward)
# and with the cotangent (the tables' gradient): every point meets every row,
# with a weight of 0 where it does not tap it. So a non-finite value spreads
# where 0 * inf and 0 * NaN are NaN. The gathers here touch the two tapped
# rows only and then apply that rule. Which rows a level contracts over
# depends on the reference function (``contract``):
#
#   "table"  the XLA mirror ``cp_encode_stacked``: all T rows;
#   "level"  the stand-alone encoder kernel: ``level_rows(R)`` rows;
#   "dup"    the fused kernels: ``level_rows_dup(R)`` rows of the operand in
#            which a periodic folded level's row F is a copy of row 0 (rows
#            past T are zero), its gradient folded back into row 0 and
#            rows >= T dropped.

CONTRACTS = ("table", "level", "dup")


def contraction(cfg: CPGridConfig, level: int, contract: str):
    """``(rows, dup)``: rows the reference contracts level ``level`` over,
    and ``F`` where row F of that operand is a copy of row 0 (else 0)."""
    R = cfg.resolutions[level]
    if contract == "table":
        return cfg.table_size, 0
    if contract == "level":
        return cfg.level_rows(R), 0
    if contract != "dup":
        raise ValueError(f"contract: one of {CONTRACTS}, got {contract!r}")
    F = cfg.level_fold(R) if cfg.fold == "periodic" else 0
    return cfg.level_rows_dup(R), F


def _operand_rows(rows: int, dup: int, table: int, device):
    """Operand row j -> (parameter row, whether it is one): row ``dup`` is
    row 0, rows past the table are padding."""
    j = torch.arange(rows, device=device)
    real = j < table
    if dup:
        real = real | (j == dup)
        j = torch.where(j == dup, torch.zeros_like(j), j)
    return j, real


def _operand_taps(r0, r1, dup: int):
    """The taps as operand rows: the wrap tap of a ``dup`` level is row F."""
    return r0, (r0 + 1 if dup else r1)


def poison_features(u: torch.Tensor, tab: torch.Tensor, r0, r1, rows: int,
                    dup: int) -> torch.Tensor:
    """``u`` (N, C): the tap sums of one level and axis over ``tab`` (T, C).
    Where a column of the contracted rows holds a non-finite entry, a point
    that does not tap every such row meets one with a weight of 0: its value
    in that column is NaN. A point that taps them all keeps its tap sum."""
    src, real = _operand_rows(rows, dup, tab.shape[0], tab.device)
    bad = ~torch.isfinite(tab[src[real]])
    if not bad.any():
        return u
    ops = torch.arange(rows, device=tab.device)[real]
    t0, t1 = _operand_taps(r0, r1, dup)
    u = u.clone()
    nan = torch.full_like(u[:, 0], float("nan"))
    for c in bad.any(dim=0).nonzero().flatten().tolist():
        z = ops[bad[:, c]]
        keep = torch.zeros_like(t0, dtype=torch.bool)
        if len(z) <= 2:
            keep = ~keep
            for j in z.tolist():
                keep &= (t0 == j) | (t1 == j)
        u[:, c] = torch.where(keep, u[:, c], nan)
    return u


def nonfinite_dlines(dl: torch.Tensor, G: torch.Tensor, r0, r1, w0, w1,
                     rows: int, dup: int) -> None:
    """Give ``dl`` (T, C), the tap sums of the gradient of one level and
    axis, the classes of the reference's dense ``tent^T G``: in a column
    where some point has a non-finite ``G`` or NaN weights (a NaN
    coordinate), every contracted row is NaN, except the rows that every such
    point taps with a weight above 0 with an inf of one sign (those are that
    inf). A NaN coordinate whose two taps are one row (a hash-folded level,
    :func:`level_taps`) has a tent that is NaN on that row only: with a
    finite ``G`` it makes that row NaN in every column, which the tap sums
    already hold, and leaves the other rows alone. In place; nothing to do
    on finite inputs."""
    nanw = torch.isnan(w0)
    one = nanw & (r0 == r1)
    bad = ~torch.isfinite(G) | (nanw & ~one)[:, None]
    if not bad.any():
        return
    t0, t1 = _operand_taps(r0, r1, dup)
    src, real = _operand_rows(rows, dup, dl.shape[0], dl.device)
    nan, inf = float("nan"), float("inf")
    for c in bad.any(dim=0).nonzero().flatten().tolist():
        b = bad[:, c]
        g = G[b, c]
        d = torch.full((rows,), nan, dtype=dl.dtype, device=dl.device)
        if not (torch.isnan(g).any() or nanw[b].any()):
            pos = torch.zeros(rows, dtype=torch.int64, device=dl.device)
            neg = torch.zeros_like(pos)
            for t, w in ((t0[b], w0[b]), (t1[b], w1[b])):
                live = w > 0
                pos.index_add_(0, t[live], (g[live] > 0).long())
                neg.index_add_(0, t[live], (g[live] < 0).long())
            n = int(b.sum())
            d = torch.where(pos == n, inf, d)
            d = torch.where(neg == n, -inf, d)
        # fold the operand rows into the parameter rows: the classes add
        col = torch.zeros(dl.shape[0], dtype=dl.dtype, device=dl.device)
        col.index_add_(0, src[real], d[real])
        hit = torch.zeros(dl.shape[0], dtype=torch.bool, device=dl.device)
        hit[src[real]] = True
        dl[hit, c] = col[hit]
        dl[r0[one], c] = nan


class _TapSum(torch.autograd.Function):
    """``w0 * tab[r0] + w1 * tab[r1]`` with the reference's non-finite
    classes (:func:`poison_features`, :func:`nonfinite_dlines`) forward and
    backward; differentiable in ``tab`` and in the weights."""

    @staticmethod
    def forward(ctx, tab, w0, w1, r0, r1, rows, dup):
        ctx.save_for_backward(tab, w0, w1, r0, r1)
        ctx.rows, ctx.dup = rows, dup
        u = w0[:, None] * tab[r0] + w1[:, None] * tab[r1]
        return poison_features(u, tab, r0, r1, rows, dup)

    @staticmethod
    def backward(ctx, du):
        tab, w0, w1, r0, r1 = ctx.saved_tensors
        dtab = dw0 = dw1 = None
        if ctx.needs_input_grad[0]:
            dtab = (torch.zeros_like(tab).index_add_(0, r0, w0[:, None] * du)
                    + torch.zeros_like(tab).index_add_(0, r1, w1[:, None] * du))
            nonfinite_dlines(dtab, du, r0, r1, w0, w1, ctx.rows, ctx.dup)
        if ctx.needs_input_grad[1]:
            dw0 = (du * tab[r0]).sum(dim=1)
        if ctx.needs_input_grad[2]:
            dw1 = (du * tab[r1]).sum(dim=1)
        return dtab, dw0, dw1, None, None, None, None


def cp_encode_stacked(stacked: torch.Tensor, x: torch.Tensor,
                      cfg: CPGridConfig, point_grads: bool = False,
                      contract: str = "table") -> torch.Tensor:
    """Plain PyTorch encoder over the stacked ``(L, 3, T, C)`` table:
    ``x`` in [0,1]^3, shape ``(..., 3)`` -> ``(..., L*C)`` f32.

    As in the reference, the tent weights are computed from a detached ``x``
    unless ``point_grads`` is set: by default no gradient reaches the points
    (training treats them as data), and ``point_grads=True`` keeps the tents
    differentiable in ``x`` (pose refinement). The tables' gradient is the
    same either way. Non-finite values take the classes of the reference
    function that ``contract`` names (see :data:`CONTRACTS`): the XLA mirror
    by default; finite values do not depend on it."""
    orig = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, 3).to(torch.float32), 0.0, 1.0)
    if not point_grads:
        x = x.detach()
    tables = _round_bf16(stacked) if cfg.use_bf16 else stacked.to(torch.float32)
    feats = []
    for l in range(cfg.n_levels):
        rows, dup = contraction(cfg, l, contract)
        us = []
        for a in range(3):
            r0, r1, w0, w1 = level_taps(x[:, a], cfg, l, a)
            us.append(_TapSum.apply(tables[l, a], w0, w1, r0, r1, rows, dup))
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
