"""Fused point pipeline parity: the JAX package's Pallas kernels (interpret
mode) against the port's fused entries (on the CPU the wrappers take their
plain versions).

Tolerances. f32 mode: rtol 1e-4, atol 1e-5 (summation order only). bf16 mode:
rgb logits atol 3e-3, sigma rtol 3e-3: sigma = exp(z0) turns an absolute
error of z0 into a relative one, and a summation-order difference can flip
one bf16 rounding of a hidden activation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops import ngp_fused_pallas as jf
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as tf
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

CP = dict(n_levels=3, n_components=8, base_resolution=8, max_resolution=128,
          table_size=32)


def _params(rng, cp, hidden=32, dout=16, nd=3, nc=3):
    LC = cp["n_levels"] * cp["n_components"]
    dims_d = [LC] + [hidden] * (nd - 1) + [dout]
    dims_c = [dout + 16] + [hidden] * (nc - 1) + [3]
    w = lambda i, o: (rng.standard_normal((i, o)) * (1.5 / np.sqrt(i))).astype(np.float32)
    b = lambda o: (0.1 * rng.standard_normal((o, 1))).astype(np.float32)
    return {
        "lines": (0.5 + 0.3 * rng.standard_normal(
            (cp["n_levels"], 3, cp["table_size"], cp["n_components"]))).astype(np.float32),
        "dW": [w(i, o) for i, o in zip(dims_d[:-1], dims_d[1:])],
        "db": [b(o) for o in dims_d[1:]],
        "cW": [w(i, o) for i, o in zip(dims_c[:-1], dims_c[1:])],
        "cb": [b(o) for o in dims_c[1:]],
    }


def _to(params, fn):
    return {k: fn(v) if k == "lines" else [fn(a) for a in v] for k, v in params.items()}


def _points(rng, n):
    xt = rng.uniform(-0.02, 1.02, (3, n)).astype(np.float32)
    vd = rng.standard_normal((3, n)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=0, keepdims=True)
    return xt, vd


def _check(got, want, use_bf16):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if use_bf16:
        np.testing.assert_allclose(got[:3], want[:3], rtol=0, atol=3e-3)
        np.testing.assert_allclose(got[3], want[3], rtol=3e-3, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("fold", ["periodic", "hash"])
@pytest.mark.parametrize("with_vd", [True, False], ids=["vd", "no_vd"])
def test_apply_cf_matches_pallas_interpret(with_vd, fold, use_bf16):
    cp = dict(CP, fold=fold, use_bf16=use_bf16)
    rng = np.random.default_rng(21)
    params = _params(rng, cp)
    n = 300  # not a multiple of 128
    xt, vd = _points(rng, n)
    if not with_vd:  # a missing direction means (0, 0, 1)
        vd = np.zeros_like(xt)
        vd[2] = 1.0
    want = jf.ngp_fused_apply_cf(_to(params, jnp.asarray), jnp.asarray(xt),
                                 jnp.asarray(vd), JCP(**cp), 128, True)
    got = tf.ngp_fused_apply_cf(_to(params, torch.tensor), torch.tensor(xt),
                                torch.tensor(vd), CPGridConfig(**cp))
    _check(got, want, use_bf16)
    ref = tf.ngp_fused_apply_cf_ref(_to(params, torch.tensor), torch.tensor(xt),
                                    torch.tensor(vd), CPGridConfig(**cp))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("nd", [1, 3])
def test_sigma_cf_matches_pallas_interpret(nd, use_bf16):
    cp = dict(CP, use_bf16=use_bf16)
    rng = np.random.default_rng(22)
    params = _params(rng, cp, nd=nd)
    xt, _ = _points(rng, 257)
    want = jf.ngp_fused_sigma_cf(_to(params, jnp.asarray), jnp.asarray(xt),
                                 JCP(**cp), 128, True)
    got = tf.ngp_fused_sigma_cf(_to(params, torch.tensor), torch.tensor(xt),
                                CPGridConfig(**cp))
    _check(got, want, use_bf16)
    assert float(got[:3].abs().max()) == 0.0
    assert torch.equal(got, tf.ngp_fused_sigma_cf_ref(
        _to(params, torch.tensor), torch.tensor(xt), CPGridConfig(**cp)))


def test_sigma_row_of_apply_equals_sigma_kernel_and_clamps():
    cp = dict(CP)
    rng = np.random.default_rng(23)
    params = _params(rng, cp)
    params["db"][-1][0] = 40.0  # z0 far above the clamp for every point
    xt, vd = _points(rng, 64)
    p = _to(params, torch.tensor)
    full = tf.ngp_fused_apply_cf(p, torch.tensor(xt), torch.tensor(vd), CPGridConfig(**cp))
    sig = tf.ngp_fused_sigma_cf(p, torch.tensor(xt), CPGridConfig(**cp))
    assert torch.equal(full[3], sig[3])
    np.testing.assert_allclose(sig[3].numpy(), np.exp(np.float32(15.0)), rtol=1e-6)


def test_channels_last_wrapper_matches():
    cp = dict(CP)
    rng = np.random.default_rng(24)
    params = _params(rng, cp)
    xt, vd = _points(rng, 6 * 7)
    x, v = xt.T.reshape(6, 7, 3), vd.T.reshape(6, 7, 3)
    rgb_j, sig_j = jf.ngp_fused_apply(_to(params, jnp.asarray), jnp.asarray(x),
                                      jnp.asarray(v), JCP(**cp), 128, True)
    rgb_t, sig_t = tf.ngp_fused_apply(_to(params, torch.tensor), torch.tensor(x),
                                      torch.tensor(v), CPGridConfig(**cp))
    assert rgb_t.shape == (6, 7, 3) and sig_t.shape == (6, 7)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), rtol=0, atol=3e-3)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=3e-3, atol=0)


def test_chunked_plain_version_is_chunk_independent(monkeypatch):
    cp = dict(CP)
    rng = np.random.default_rng(25)
    p = _to(_params(rng, cp), torch.tensor)
    xt, vd = _points(rng, 1000)
    a = tf.ngp_fused_apply_cf_ref(p, torch.tensor(xt), torch.tensor(vd), CPGridConfig(**cp))
    monkeypatch.setattr(tf, "REF_CHUNK", 128)
    b = tf.ngp_fused_apply_cf_ref(p, torch.tensor(xt), torch.tensor(vd), CPGridConfig(**cp))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert tf.ngp_fused_apply_cf_ref(p, torch.zeros(3, 0), torch.zeros(3, 0),
                                     CPGridConfig(**cp)).shape == (4, 0)
