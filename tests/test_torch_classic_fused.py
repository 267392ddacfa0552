"""The fused classic point pipeline's plain versions against the reference
kernel, on the CPU: ``classic_fused_apply_cf_ref`` and its VJP against
``classic_fused_apply_cf(..., interpret=True)`` and ``jax.vjp`` of it, in f32
and bf16; the autograd wrapper; the ``fused_supported`` gates and their
warning; the kernels' host-side buffer layout.

Tolerances. f32 forward rtol 2e-5 / atol 2e-6 and gradients rtol 5e-4 /
atol 5e-6, the reference's own (``tests/test_classic_fused.py``). bf16: both
sides round the same operands, but a sum taken in another order can flip the
bf16 rounding of one activation, one bf16 step (2^-8) of one input of the
next layer, so forward atol 2e-2 and gradients atol 2e-2 of the leaf's
largest entry (``ROADMAP.md`` section C).
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRF as JFlexibleNeRF
from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRFConfig as JFCfg
from nerf_kinematics_tpu.ops.classic_fused_pallas import classic_fused_apply_cf as j_apply
from nerf_kinematics_tpu.ops.classic_fused_pallas import fused_supported as j_supported
from nerf_kinematics_tpu_torch.ops import cuda_lib
from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import (
    _Layout, classic_fused_apply_cf, classic_fused_apply_cf_bwd,
    classic_fused_apply_cf_bwd_ref, classic_fused_apply_cf_ref, fused_supported)
from nerf_kinematics_tpu_torch.train.config import Config, FlexibleNeRFConfig
from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

SMALL = dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
NAMES = lambda t: (["layer1"] + [f"layers_xyz_{i}" for i in range(t - 1)]
                   + ["fc_alpha", "fc_feat", "layers_dir_0", "fc_rgb"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setup(n=200, seed=0, **kw):
    """Reference weights (biases given values) in the kernel's structure,
    numpy; points with |x| up to 4 and unit directions, channels-first."""
    cfg = JFCfg(**{**SMALL, **kw})
    x0 = np.zeros((1, 3), np.float32)
    tree = jax.tree_util.tree_map(np.asarray, JFlexibleNeRF(cfg).init(
        jax.random.PRNGKey(seed), x0, x0))["params"]
    rng = np.random.default_rng(seed + 1)
    names = NAMES(cfg.trunk_depth)
    W = [tree[n]["kernel"] for n in names]
    b = [(0.1 * rng.standard_normal((w.shape[1], 1))).astype(np.float32) for w in W]
    x = rng.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
    vd = rng.standard_normal((3, n)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=0, keepdims=True)
    return cfg, {"W": W, "b": b}, x, vd


def _t(params):
    return {k: [torch.tensor(a) for a in v] for k, v in params.items()}


def _j(params):
    return {k: [jnp.asarray(a) for a in v] for k, v in params.items()}


def _tcfg(jcfg):
    return FlexibleNeRFConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(jcfg)})


FWD_CASES = {"f32": ({}, 2e-5, 2e-6), "bf16": ({"compute_dtype": "bfloat16"}, 0.0, 2e-2),
             "f32_full_width": ({"hidden_size": 128, "num_encoding_fn_xyz": 10,
                                 "num_encoding_fn_dir": 4}, 2e-5, 2e-6)}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_forward_ref_matches_the_reference_kernel(case):
    kw, rtol, atol = FWD_CASES[case]
    cfg, params, x, vd = _setup(n=256 if "full" in case else 200, **kw)
    want = np.asarray(j_apply(_j(params), jnp.asarray(x), jnp.asarray(vd), cfg, 128, True))
    got = classic_fused_apply_cf_ref(_t(params), torch.tensor(x), torch.tensor(vd), _tcfg(cfg))
    assert got.shape == want.shape == (4, x.shape[1])
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # row 3 is the raw sigma: negative values survive
    assert (got[3] < 0).any() and (got[3] > 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"], ids=["f32", "bf16"])
def test_vjp_ref_matches_the_reference_kernel(dtype):
    cfg, params, x, vd = _setup(n=300, compute_dtype=dtype)
    rng = np.random.default_rng(9)
    g = rng.standard_normal((4, x.shape[1])).astype(np.float32)
    out, vjp = jax.vjp(lambda p, a, d: j_apply(p, a, d, cfg, 128, True),
                       _j(params), jnp.asarray(x), jnp.asarray(vd))
    dp, dx, dvd = vjp(jnp.asarray(g))
    assert not np.asarray(dx).any() and not np.asarray(dvd).any()
    got = classic_fused_apply_cf_bwd_ref(_t(params), torch.tensor(x), torch.tensor(vd),
                                         torch.tensor(g), _tcfg(cfg))
    bf16 = dtype == "bfloat16"
    for key in ("W", "b"):
        for i, (a, w) in enumerate(zip(got[key], dp[key])):
            w = np.asarray(w)
            assert tuple(a.shape) == w.shape, (key, i)
            atol = 2e-2 * np.abs(w).max() if bf16 else 5e-6
            np.testing.assert_allclose(a.numpy(), w, rtol=5e-4, atol=atol,
                                       err_msg=f"{key}[{i}]")
            assert np.abs(w).max() > 0, f"{key}[{i}] is all zero"


def test_autograd_wrapper_on_cpu():
    """On CPU tensors the wrapper is differentiable in the parameters only:
    the leaves get the plain VJP, points and directions nothing; the CUDA
    library is never asked for."""
    cfg, params, x, vd = _setup(n=150)
    tcfg = _tcfg(cfg)
    live = {k: [t.clone().requires_grad_() for t in v] for k, v in _t(params).items()}
    xg = torch.tensor(x).requires_grad_()
    before = dict(cuda_lib.LAUNCHES)
    out = classic_fused_apply_cf(live, xg, torch.tensor(vd), tcfg)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    (out * g).sum().backward()
    assert xg.grad is None
    want = classic_fused_apply_cf_bwd(_t(params), torch.tensor(x), torch.tensor(vd), g, tcfg)
    for key in ("W", "b"):
        for a, w in zip(live[key], want[key]):
            assert torch.allclose(a.grad, w, rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        again = classic_fused_apply_cf(live, torch.tensor(x), torch.tensor(vd), tcfg)
    assert torch.equal(again, out.detach())
    assert dict(cuda_lib.LAUNCHES) == before
    # empty input
    assert classic_fused_apply_cf_ref(_t(params), torch.zeros(3, 0), torch.zeros(3, 0),
                                      tcfg).shape == (4, 0)


def test_fused_supported_gates_match_the_reference():
    for kw in ({}, dict(num_layers=12), dict(use_viewdirs=False), dict(num_layers=10),
               dict(num_layers=10, skip_connect_every=4), dict(num_layers=2)):
        assert fused_supported(FlexibleNeRFConfig(**kw)) == j_supported(JFCfg(**kw)), kw
    assert not fused_supported(FlexibleNeRFConfig(num_layers=12))


def test_engine_gates_and_warning(caplog):
    """auto / on (YAML booleans too) take the fused entry, off the module; an
    unsupported config logs the reason and falls back; one supported network
    beside an unsupported one leaves both unfused."""
    small = FlexibleNeRFConfig(**SMALL)

    def fns(coarse, fine):
        return ClassicNerf(Config(model_coarse=coarse, model_fine=fine),
                           device="cpu").cf_apply_fns()

    for mode in ("auto", "on", True):
        c, f = fns(dataclasses.replace(small, fused=mode), dataclasses.replace(small, fused=mode))
        assert c is not None and f is not None and c is not f
    for mode in ("off", False):
        m = dataclasses.replace(small, fused=mode)
        assert fns(m, m) == (None, None)
    c, f = fns(small, None)
    assert c is not None and c is f  # no fine network: one entry for both passes
    deep = dataclasses.replace(small, num_layers=12)
    with caplog.at_level(logging.WARNING, "nerf_kinematics_tpu_torch.train"):
        assert fns(deep, None) == (None, None)
    assert any("skip connection" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, "nerf_kinematics_tpu_torch.train"):
        assert fns(small, deep) == (None, None)
        assert fns(dataclasses.replace(small, use_viewdirs=False), None) == (None, None)
    assert any("use_viewdirs" in r.message for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING, "nerf_kinematics_tpu_torch.train"):
        assert fns(dataclasses.replace(deep, fused="off"), None) == (None, None)
    assert not caplog.records


def test_fused_entry_matches_the_module_in_f32():
    """The engine's fused entry and the module route compute the same
    function in f32, forward and parameter gradients."""
    eng = ClassicNerf(Config(model_coarse=FlexibleNeRFConfig(**SMALL), model_fine=None),
                      device="cpu")
    eng.init_state(seed=4)
    cf, _ = eng.cf_apply_fns()
    rng = np.random.default_rng(5)
    pts = torch.tensor(rng.uniform(-3, 3, (7, 9, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(torch.tensor(
        rng.standard_normal((7, 9, 3)).astype(np.float32)), dim=-1)
    out = cf(pts, vd)
    rgb, sigma = eng.apply_coarse(pts, vd)
    np.testing.assert_allclose(out[:3].T.reshape(7, 9, 3).detach().numpy(),
                               rgb.detach().numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out[3].reshape(7, 9).detach().numpy(),
                               sigma.detach().numpy(), rtol=2e-5, atol=2e-6)
    leaves = list(eng.model.parameters())
    g1 = torch.autograd.grad((out ** 2).sum(), leaves)
    g2 = torch.autograd.grad((torch.cat([rgb.reshape(-1, 3).T, sigma.reshape(1, -1)]) ** 2
                              ).sum(), leaves)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4, atol=5e-6)


def test_kernel_layout_of_the_main_config():
    """The host-side offsets the kernels read: rows of the saved inputs and
    cotangents, the flat gradient (the model's 84 548 parameters), and the
    wrapper's refusals."""
    cfg = FlexibleNeRFConfig()
    model = ClassicNerf(Config(model_coarse=cfg, model_fine=None), device="cpu")
    params = ClassicNerf._fused_params(model.model_coarse)
    lay = _Layout(params, cfg)
    assert lay.nw == 8 and lay.ins == [63, 128, 128, 128, 128, 128, 155, 64]
    assert lay.outs == [128, 128, 128, 128, 1, 128, 64, 3]
    assert lay.grad_total == 84548 == sum(p.numel() for p in model.model_coarse.parameters())
    assert lay.act_rows == 63 + 3 * 128 + 128 + 155 + 64 == 794
    assert lay.gs_rows == 4 * 128 + 128 + 64 == 704
    assert lay.act_row[4] == lay.act_row[5] == 63 + 3 * 128
    assert lay.wf_ld == [128] * 4 + [64, 128, 64, 64]
    assert lay.wb_cols == [0, 128, 128, 128, 0, 128, 128, 64]
    assert lay.buf_rows == 155 and 2 * lay.buf_rows * 64 * 4 <= cuda_lib.SMEM_LIMIT
    assert all(o % 4 == 0 for o in lay.wf_off + lay.wb_off)
    assert all(a < b for a, b in zip(lay.dw_off, lay.db_off))
    assert lay.rnd == [False] * 8
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert _Layout(params, bf).rnd == [True] * 4 + [False, True, True, False]
    with pytest.raises(ValueError, match="do not match"):
        _Layout(params, dataclasses.replace(cfg, hidden_size=64))
    wide = FlexibleNeRFConfig(hidden_size=256)
    wide_params = ClassicNerf._fused_params(
        ClassicNerf(Config(model_coarse=wide, model_fine=None), device="cpu").model_coarse)
    with pytest.raises(ValueError, match="too large|above the kernel"):
        _Layout(wide_params, wide)
