"""CP-grid encoder parity: the JAX package's Pallas kernel (interpret mode)
against the port's encoder (on the CPU the CUDA wrapper takes its plain
version), periodic and hash fold, bf16 and f32 operands.

Tolerances: f32 mode atol 1e-6 (same formula, fused multiply-adds may differ
in the last bit); bf16 mode atol 1e-5 (same roundings: the products of
bf16 operands are exact in f32, only the order of two sums can differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu.ops.cp_grid import cp_encode_stacked as j_stacked
from nerf_kinematics_tpu.ops.cp_grid import hash_fold_indices as j_hash
from nerf_kinematics_tpu.ops.cp_grid_pallas import cp_encode_pallas
from nerf_kinematics_tpu_torch.ops.cp_grid import (
    CPGridConfig, cp_encode_ref, cp_encode_stacked, hash_fold_indices, level_taps)
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
    """The flagship step's 8192 x 48 fine points on a 132-SM card: about two
    waves of the (level, axis) blocks, the chunk sums well under the cap; a
    short call takes one chunk (the kernel writes dlines itself)."""
    cfg = CPGridConfig(n_levels=4, n_components=64, table_size=192,
                       base_resolution=16, max_resolution=2048)
    assert dlines_chunks(8192 * 48, cfg, 132) == 22
    assert 22 * 4 * 3 * 192 * 64 * 4 <= DLINES_PARTIAL_BYTES
    assert dlines_chunks(100, cfg, 132) == 1
    assert dlines_chunks(1 << 30, cfg, 10000) * 4 * 3 * 192 * 64 * 4 <= DLINES_PARTIAL_BYTES
    # one block's shared memory, as the kernel lays it out
    from pathlib import Path

    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import DLINES_BATCH, dlines_smem_bytes

    src = (Path(cuda_lib.CSRC_DIR) / "cp_encode.cu").read_text()
    assert f"#define NKT_DL_BATCH {DLINES_BATCH} " in src
    assert dlines_smem_bytes(cfg) == (3 * 192 + 2 * 128) * 64 * 4 + 2 * 128 * (3 * 12 + 4)
    assert dlines_smem_bytes(cfg) <= cuda_lib.SMEM_LIMIT
