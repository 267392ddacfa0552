"""CP-grid encoder parity: the JAX package's Pallas kernel (interpret mode)
against the port's encoder (on the CPU the CUDA wrapper takes its plain
version), periodic and hash fold, bf16 and f32 operands.

Tolerances: f32 mode atol 1e-6 (same formula, fused multiply-adds may differ
in the last bit); bf16 mode atol 1e-5 (same roundings: the products of
bf16 operands are exact in f32, only the order of two sums can differ)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu.ops.cp_grid import cp_encode_stacked as j_stacked
from nerf_kinematics_tpu.ops.cp_grid import hash_fold_indices as j_hash
from nerf_kinematics_tpu.ops.cp_grid_pallas import cp_encode_pallas
from nerf_kinematics_tpu_torch.ops.cp_grid import (
    CPGridConfig, cp_encode_ref, cp_encode_stacked, fold_salt, hash_fold_indices, level_taps)
from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
    DLINES_MIN_POINTS, DLINES_PARTIAL_BYTES, cp_encode_cuda, cp_encode_cuda_bwd_ref,
    cp_encode_cuda_ref, dlines_chunks)

# levels 8 (un-folded), 32 and 128 (folded into the 32-row table)
BASE = dict(n_levels=3, n_components=8, base_resolution=8, max_resolution=128,
            table_size=32)


def _inputs(seed, kw, n=777):
    rng = np.random.default_rng(seed)
    lines = (0.5 + 0.3 * rng.standard_normal((kw["n_levels"], 3, kw["table_size"],
                                              kw["n_components"]))).astype(np.float32)
    x = rng.uniform(-0.05, 1.05, (n, 3)).astype(np.float32)
    x[:8] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 0.125], [1, 0, 0.5],
             [0.999999, 1e-7, 0.5], [0.25, 0.75, 1.0], [2, -1, 0.3], [0.125, 0.125, 0.125]]
    return lines, x


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("fold,fold_cap", [("periodic", 0), ("hash", 0), ("periodic", 16)])
def test_encoder_matches_pallas_interpret(fold, fold_cap, use_bf16):
    kw = dict(BASE, fold=fold, fold_cap=fold_cap, use_bf16=use_bf16)
    lines, x = _inputs(11, kw)
    want = np.asarray(cp_encode_pallas(jnp.asarray(lines), jnp.asarray(x), JCP(**kw), 256, True))
    cfg = CPGridConfig(**kw)
    got = cp_encode_cuda(torch.tensor(lines), torch.tensor(x), cfg).numpy()
    atol = 1e-5 if use_bf16 else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    # wrapper on the CPU == its plain version == the stacked encoder
    assert np.array_equal(got, cp_encode_cuda_ref(torch.tensor(lines), torch.tensor(x), cfg).numpy())
    assert np.array_equal(got, cp_encode_stacked(torch.tensor(lines), torch.tensor(x), cfg).numpy())


@pytest.mark.parametrize("fold", ["periodic", "hash"])
def test_encoder_matches_xla_stacked_and_oracle(fold):
    kw = dict(BASE, fold=fold, use_bf16=False)
    lines, x = _inputs(5, kw, n=200)
    cfg = CPGridConfig(**kw)
    got = cp_encode_stacked(torch.tensor(lines), torch.tensor(x).reshape(10, 20, 3), cfg)
    assert got.shape == (10, 20, 24)
    want = np.asarray(j_stacked(jnp.asarray(lines), jnp.asarray(x), JCP(**kw)))
    np.testing.assert_allclose(got.reshape(200, 24).numpy(), want, rtol=0, atol=1e-6)
    # scalar float64 oracle; the f32 coordinate at R = 128 carries ~1e-5
    oracle = cp_encode_ref(lines, x, cfg)
    np.testing.assert_allclose(got.reshape(200, 24).numpy(), oracle, rtol=0, atol=2e-4)


def test_hash_fold_indices_match():
    i0 = np.arange(0, 5000, dtype=np.float32)
    for table, salt in [(32, 374761393), (192, -1148435428), (100, 7)]:
        want = np.asarray(j_hash(jnp.asarray(i0), table, salt)).astype(np.int64)
        got = hash_fold_indices(torch.tensor(i0), table, salt).numpy()
        assert np.array_equal(got, want)


def test_flagship_shape_small_batch():
    """The flagship table shape (L=4, C=64, T=192; levels 2-3 fold) on a few
    points."""
    kw = dict(n_levels=4, n_components=64, base_resolution=32, max_resolution=1024,
              table_size=192)
    lines, x = _inputs(3, kw, n=130)
    want = np.asarray(cp_encode_pallas(jnp.asarray(lines), jnp.asarray(x), JCP(**kw), 256, True))
    got = cp_encode_cuda(torch.tensor(lines), torch.tensor(x), CPGridConfig(**kw)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _dlines_f64(lines, x, g, cfg):
    """The line tables' gradient of an f32-mode encoding, summed in float64
    over the plain version's taps: per level and axis, the cotangent times
    the other two axes' line features, weighted by the two tent weights,
    added to the two tapped rows."""
    C = cfg.n_components
    x = torch.clamp(x.to(torch.float32), 0.0, 1.0)
    dl = torch.zeros_like(lines)
    for l in range(cfg.n_levels):
        taps, us = [], []
        for a in range(3):
            r0, r1, w0, w1 = level_taps(x[:, a], cfg, l, a)
            w0, w1 = w0.double()[:, None], w1.double()[:, None]
            taps.append((r0, r1, w0, w1))
            us.append(w0 * lines[l, a][r0] + w1 * lines[l, a][r1])
        gl = g[:, l * C : (l + 1) * C]
        for a, (b, c) in enumerate(((1, 2), (0, 2), (0, 1))):
            gu = gl * us[b] * us[c]
            r0, r1, w0, w1 = taps[a]
            dl[l, a].index_add_(0, r0, w0 * gu)
            dl[l, a].index_add_(0, r1, w1 * gu)
    return dl


def _dlines_f64_by_chunks(lines, x, g, cfg, chunks):
    """:func:`_dlines_f64` summed as the kernel sums it: the points in
    ``chunks`` consecutive chunks of ``ceil(n / chunks)``, one table per
    chunk, the tables added in chunk order."""
    chunk = max(1, -(-x.shape[0] // chunks))
    out = torch.zeros_like(lines)
    for s in range(0, x.shape[0], chunk):
        out = out + _dlines_f64(lines, x[s : s + chunk], g[s : s + chunk], cfg)
    return out


@pytest.mark.parametrize("fold", ["periodic", "hash"])
@pytest.mark.parametrize("n,n_sm", [(777, 132), (6000, 132), (6000, 4), (8, 132)])
def test_dlines_chunk_sums_equal_the_plain_version_in_float64(fold, n, n_sm):
    """The line-table gradient kernel sums its points chunk by chunk, one
    table per chunk, and adds the chunk tables in order. That sum, taken in
    float64 over the host's own chunking (and over 7 chunks), equals the
    float64 sum in one pass to float64 rounding, and the plain version's f32
    sum to f32 rounding, on random taps of both fold modes."""
    kw = dict(BASE, use_bf16=False)
    cfg = CPGridConfig(**kw, fold=fold)
    lines, x = _inputs(21, kw, n)
    g = np.random.default_rng(22).standard_normal((n, cfg.out_dim))
    chunks = dlines_chunks(n, cfg, n_sm)
    table = cfg.n_levels * 3 * cfg.table_size * cfg.n_components * 4
    assert 1 <= chunks <= max(1, -(-n // DLINES_MIN_POINTS))
    assert chunks * table <= max(DLINES_PARTIAL_BYTES, table)
    tl, tx, tg = torch.tensor(lines, dtype=torch.float64), torch.tensor(x), torch.tensor(g)
    whole = _dlines_f64(tl, tx, tg, cfg)
    scale = whole.abs().max().item()
    assert scale > 0.0
    for k in (chunks, 7):
        parts = _dlines_f64_by_chunks(tl, tx, tg, cfg, k)
        np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0, atol=1e-13 * scale)
    plain = cp_encode_cuda_bwd_ref(torch.tensor(lines), tx, tg.float(), cfg)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.double().numpy(), parts.numpy(), rtol=0, atol=1e-5 * scale)


def test_dlines_chunks_at_the_flagship_shape():
    """The flagship step's 8192 x 48 fine points on a 132-SM card: one block
    of the line-table gradient (a level's three axes) an SM, the chunk sums
    well under the cap; a short call takes one chunk (the kernel writes
    dlines itself). The kernel's own constants, as its sources define them:
    64-point batches; 12 product warps, one 16-row tile each, so the 192
    rows of a flagship level take one block; 8 producer warps that hand
    their registers to the product warps (setmaxnreg) within the block's 96
    a thread at launch; a forward block stages 128 points' taps. The
    layouts themselves live in csrc/cp_encode.cu only: its launchers refuse
    what does not fit."""
    from pathlib import Path

    from nerf_kinematics_tpu_torch.ops import cuda_lib

    cfg = CPGridConfig(n_levels=4, n_components=64, table_size=192,
                       base_resolution=32, max_resolution=1024)
    assert dlines_chunks(8192 * 48, cfg, 132) == 33
    assert 33 * 4 * 3 * 192 * 64 * 4 <= DLINES_PARTIAL_BYTES
    assert dlines_chunks(100, cfg, 132) == 1
    assert dlines_chunks(1 << 30, cfg, 10000) * 4 * 3 * 192 * 64 * 4 <= DLINES_PARTIAL_BYTES
    src = (Path(cuda_lib.CSRC_DIR) / "cp_encode.cu").read_text()
    defines = dict(
        line.split()[1:3] for line in src.splitlines() if line.startswith("#define NKT_"))
    assert defines["NKT_DL_BATCH"] == "64"
    assert defines["NKT_DL_MAX_WARPS"] == "12" and 12 * 16 == 192
    assert (defines["NKT_DL_PWARPS"], defines["NKT_DL_PREGS"], defines["NKT_DL_QREGS"]) == (
        "8", "32", "136")
    assert 8 * 32 * 32 + 12 * 32 * 136 <= 20 * 32 * 96
    assert defines["NKT_FW_BATCH"] == "128"
    assert "NKT_DL_AXES" not in src  # a level's three axes a block, always


# ---- the plain encoder's point gradient (the reference's point_grads) -----

def _point_inputs(seed, kw, n=150):
    lines, x = _inputs(seed, kw, n)
    # inside the cube and off the cell edges, where the tents are smooth
    x = np.clip(x, 0.02, 0.98).astype(np.float32)
    w = np.random.default_rng(seed + 1).standard_normal((n, kw["n_levels"] * kw["n_components"]))
    return lines, x, w.astype(np.float32)


@pytest.mark.parametrize("fold", ["periodic", "hash"])
def test_point_gradient_is_stopped_by_default(fold):
    """``point_grads=False`` (the default): no gradient reaches the points,
    where ``jax.grad`` of the reference gives zeros; the tables' gradient is
    the same with the switch on, and the reference's to f32 rounding."""
    kw = dict(BASE, fold=fold, use_bf16=False)
    lines, x, w = _point_inputs(41, kw)
    cfg, jcfg = CPGridConfig(**kw), JCP(**kw)

    def jloss(s, xx):
        return jnp.sum(jnp.asarray(w) * j_stacked(s, xx, jcfg))

    jdl, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(lines), jnp.asarray(x))
    assert not np.asarray(jdx).any()
    grads = {}
    for on in (False, True):
        tl = torch.tensor(lines, requires_grad=True)
        tx = torch.tensor(x, requires_grad=True)
        loss = (torch.tensor(w) * cp_encode_stacked(tl, tx, cfg, point_grads=on)).sum()
        grads[on] = torch.autograd.grad(loss, (tl, tx), allow_unused=True)
    assert grads[False][1] is None
    assert grads[True][1] is not None and grads[True][1].abs().max() > 0
    assert torch.equal(grads[False][0], grads[True][0])
    scale = np.abs(np.asarray(jdl)).max()
    np.testing.assert_allclose(grads[False][0].numpy(), np.asarray(jdl), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("fold", ["periodic", "hash"])
def test_point_gradient_matches_jax_when_asked(fold):
    """``point_grads=True``: the tents stay differentiable in the points, and
    the gradient matches ``jax.grad`` of the reference with
    ``point_grads=True`` at f32 tolerance (1e-5 of the largest entry: the
    same products, sums in another order)."""
    kw = dict(BASE, fold=fold, use_bf16=False)
    lines, x, w = _point_inputs(43, kw)
    cfg, jcfg = CPGridConfig(**kw), JCP(**kw)
    jdx = jax.grad(lambda xx: jnp.sum(jnp.asarray(w) * j_stacked(
        jnp.asarray(lines), xx, jcfg, point_grads=True)))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    loss = (torch.tensor(w) * cp_encode_stacked(torch.tensor(lines), tx, cfg,
                                                point_grads=True)).sum()
    (dx,) = torch.autograd.grad(loss, tx)
    jdx = np.asarray(jdx)
    scale = np.abs(jdx).max()
    assert scale > 0
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=0, atol=1e-5 * scale)


# ---- row 5's kernel (the line tables' gradient), emulated -----------------

def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).to(torch.float32).numpy()


def _tf32_rna(x):
    """cvt.rna.tf32.f32, as the kernel takes it: (bits + 0x1000) & 0xFFFFE000."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna((np.asarray(x, np.float32) - hi).astype(np.float32))


def _tile_partial(A, Bop, bf16):
    """One k-tile's products, from zero: A (16 rows x 16 entries) times the
    entries' B operand rows (16 x C). bf16: every product exact, the sum
    rounded to f32 once. f32: per k8 half, the 3xTF32 terms a_lo b_hi, a_hi
    b_lo, a_hi b_hi, each adding its exact 8-product dot with one f32
    rounding."""
    if bf16:
        return (A.astype(np.float64) @ Bop.astype(np.float64)).astype(np.float32)
    out = np.zeros((A.shape[0], Bop.shape[1]), np.float32)
    for h in (slice(0, 8), slice(8, 16)):
        (ah, al), (bh, bl) = _split(A[:, h]), _split(Bop[h])
        s = np.zeros_like(out)
        for a, b in ((al, bh), (ah, bl), (ah, bh)):
            s = (s.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
        out = (out + s).astype(np.float32)
    return out


def _dlines_kernel_emulated(lines, x, g, cfg, n_sm):
    """Row 5's kernel as it sums: the points in ``dlines_chunks`` chunks, each
    in batches (64 points, 32 in f32 mode); per level, axis and 16-row tile,
    the batch's points with a tap in the tile, in point order, 16 at a time
    (the k-tiles; the tail padded with zero entries): the tent A (row r,
    entry k) = w0 if r == r0, else w1 if r == r1, else 0, times the entries'
    B operand rows grad_u = round(g (u_b u_c)); each k-tile's products summed
    from zero (``_tile_partial``) and added to the tile's f32 sum; the chunk
    tables added in chunk order."""
    L, T, C = cfg.n_levels, cfg.table_size, cfg.n_components
    bf16 = cfg.use_bf16
    batch = 64 if bf16 else 32
    n = x.shape[0]
    chunks = dlines_chunks(n, cfg, n_sm)
    chunk = -(-n // chunks)
    tx = torch.clamp(torch.tensor(x), 0.0, 1.0)
    tabs = _bf16(lines) if bf16 else np.asarray(lines, np.float32)
    total = None
    for c0 in range(0, n, chunk):
        part = np.zeros((L, 3, T, C), np.float32)
        for l in range(L):
            R = cfg.resolutions[l]
            rows = cfg.level_fold(R) or min(R + 1, T)
            for p0 in range(c0, min(c0 + chunk, n), batch):
                sl = slice(p0, min(p0 + batch, c0 + chunk, n))
                taps = [[t.numpy() for t in level_taps(tx[sl, a], cfg, l, a)] for a in range(3)]
                us = [w0[:, None] * tabs[l, a][r0] + w1[:, None] * tabs[l, a][r1]
                      for a, (r0, r1, w0, w1) in enumerate(taps)]
                gl = np.asarray(g[sl, l * C:(l + 1) * C], np.float32)
                for a, (b_, c_) in enumerate(((1, 2), (0, 2), (0, 1))):
                    gu = gl * (us[b_] * us[c_])
                    gu = _bf16(gu) if bf16 else gu.astype(np.float32)
                    r0, r1, w0, w1 = taps[a]
                    for rt in range(-(-rows // 16)):
                        tile = np.arange(rt * 16, rt * 16 + 16)
                        pts = np.nonzero(((r0 >= rt * 16) & (r0 < rt * 16 + 16))
                                         | ((r1 >= rt * 16) & (r1 < rt * 16 + 16)))[0]
                        acc = part[l, a, rt * 16:rt * 16 + 16]
                        for k0 in range(0, len(pts), 16):
                            e = pts[k0:k0 + 16]
                            A = np.zeros((16, 16), np.float32)
                            Bop = np.zeros((16, C), np.float32)
                            A[:, :len(e)] = np.where(tile[:, None] == r0[e], w0[e],
                                                     np.where(tile[:, None] == r1[e], w1[e], 0.0))
                            Bop[:len(e)] = gu[e]
                            acc[:] = (acc + _tile_partial(A, Bop, bf16))[:len(acc)]
        total = part if total is None else (total + part).astype(np.float32)
    return total


def _special_points(cfg):
    """Points whose taps include the wrap of a periodic folded level (r0 =
    F - 1, r1 = 0) and, for the hash fold, a cell pair that hashes onto one
    row (w1 = 0, both weights in w0)."""
    pts = []
    for l, R in enumerate(cfg.resolutions):
        F = cfg.level_fold(R)
        if not F:
            continue
        if cfg.fold == "periodic":
            pts.append([(F - 0.5) / R, (2 * F - 0.25) / R, 0.3])
        else:
            for a in range(3):
                i0 = np.arange(R - 1)
                rows = hash_fold_indices(torch.tensor(i0, dtype=torch.float32), F,
                                         fold_salt(l, a)).numpy()
                same = i0[rows == hash_fold_indices(torch.tensor(i0 + 1.0), F,
                                                    fold_salt(l, a)).numpy()]
                for c in same[:2]:
                    p = [0.4, 0.6, 0.5]
                    p[a] = (c + 0.3) / R
                    pts.append(p)
    return np.asarray(pts, np.float32)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("fold", ["periodic", "hash"])
@pytest.mark.parametrize("n,n_sm", [(777, 132), (300, 1)])
def test_dlines_kernel_emulated_matches_pallas_and_plain(fold, use_bf16, n, n_sm):
    """Row 5's tiling (bf16 tent x grad_u products, or the 3xTF32 split in
    f32 mode, summed k-tile by k-tile over each tile's points in point order,
    chunk tables added in order), emulated in numpy, against the Pallas VJP
    in interpret mode and the plain version: within 2e-6 of the leaf's
    largest entry (the same products in bf16 mode, the same grad_u; sums in
    another order, and in f32 mode the split's 2^-21). Ragged n (a short last
    batch), one chunk and many, the wrap tap of a periodic folded level and
    a hash fold onto one row."""
    kw = dict(BASE, fold=fold, use_bf16=use_bf16)
    cfg = CPGridConfig(**kw)
    lines, x = _inputs(51, kw, n)
    special = _special_points(cfg)
    assert len(special)
    x[8:8 + len(special)] = special
    g = np.random.default_rng(52).standard_normal((n, cfg.out_dim)).astype(np.float32)
    tx = torch.tensor(x)
    hits = {"wrap": False, "one_row": False}
    for l in range(cfg.n_levels):
        for a in range(3):
            r0, r1, w0, w1 = level_taps(torch.clamp(tx[:, a], 0, 1), cfg, l, a)
            hits["wrap"] |= bool(((r1 == 0) & (r0 > 0)).any())
            hits["one_row"] |= bool(((w1 == 0) & (w0 > 0.99)).any())
    assert hits["wrap" if fold == "periodic" else "one_row"], hits
    got = _dlines_kernel_emulated(lines, x, g, cfg, n_sm)
    plain = cp_encode_cuda_bwd_ref(torch.tensor(lines), tx, torch.tensor(g), cfg).numpy()
    _, vjp = jax.vjp(lambda t: cp_encode_pallas(t, jnp.asarray(x), JCP(**kw), 256, True),
                     jnp.asarray(lines))
    pallas = np.asarray(vjp(jnp.asarray(g))[0])
    scale = np.abs(plain).max()
    for want in (plain, pallas):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * scale)


def test_plain_dlines_keeps_a_nan_cotangent_to_its_taps():
    """The pattern of the reference's dense ``tent^T grad_u`` on a
    non-finite cotangent (``cp_grid_pallas.py``'s backward), which the plain
    version gives: a NaN makes its column NaN on every row below
    ``level_rows(R)``; an inf leaves the rows its point taps with a weight
    above 0 at +-inf and every other row below ``level_rows`` NaN; rows
    at or past ``level_rows`` stay 0."""
    kw = dict(BASE, use_bf16=False)
    cfg = CPGridConfig(**kw)
    lines, x = _inputs(61, kw, 40)
    C = cfg.n_components
    g = np.ones((40, cfg.out_dim), np.float32)
    g[5, 3::C] = np.nan      # channel 3 of every level
    g[9, 6::C] = np.inf      # channel 6 of every level
    dl = cp_encode_cuda_bwd_ref(torch.tensor(lines), torch.tensor(x), torch.tensor(g), cfg)
    tx = torch.clamp(torch.tensor(x[9:10]), 0, 1)
    for l, R in enumerate(cfg.resolutions):
        rows = cfg.level_rows(R)
        for a in range(3):
            d = dl[l, a]
            assert torch.isnan(d[:rows, 3]).all()
            r0, r1, w0, w1 = level_taps(tx[:, a], cfg, l, a)
            taps = {int(r) for r, w in ((r0, w0), (r1, w1)) if float(w) > 0}
            assert taps
            for r in range(rows):  # the inf's sign is that of grad_u
                assert (torch.isinf if r in taps else torch.isnan)(d[r, 6]), (l, a, r)
            assert torch.isfinite(d[:, [0, 1, 2, 4, 5, 7]]).all()
            assert not d[rows:].any()
