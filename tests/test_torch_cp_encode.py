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
    CPGridConfig, cp_encode_ref, cp_encode_stacked, hash_fold_indices)
from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
    cp_encode_cuda, cp_encode_cuda_ref)

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
