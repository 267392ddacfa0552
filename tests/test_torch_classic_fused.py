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


# ---- f32 mode on the tensor cores: the 3xTF32 product, emulated ----------

def _tf32_rna(x):
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, ties away from
    zero (the bit pattern rounded at bit 13, the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna((x - hi).astype(np.float32))


def _mma_f32(terms, M, N, K, partial=False):
    """The kernel's k-tile loop: per k-tile of 8, one mma.sync per term in
    the order given, each adding its exact 8-product dot to an f32 sum with
    one f32 rounding. ``partial``: the k-tile's terms go into a sum started
    from zero, which is then added to the accumulator (the tile products of
    rows 9 and 10); else they add to the accumulator itself (the weight
    gradients)."""
    acc = np.zeros((M, N), np.float32)
    for k0 in range(0, K, 8):
        sl = slice(k0, k0 + 8)
        s = np.zeros((M, N), np.float32) if partial else acc
        for a, b in terms:
            dot = a[:, sl].astype(np.float64) @ b[sl].astype(np.float64)
            s = (s.astype(np.float64) + dot).astype(np.float32)
        acc = (acc + s).astype(np.float32) if partial else s
    return acc


def tf32x3_matmul(A, B, partial=False):
    """(M, K) @ (K, N) as the kernels take it: A and B split into TF32 hi and
    lo halves, the small terms (a_lo b_hi, a_hi b_lo) first, then a_hi b_hi."""
    (ah, al), (bh, bl) = _split(A), _split(B)
    return _mma_f32([(al, bh), (ah, bl), (ah, bh)], A.shape[0], B.shape[1], A.shape[1],
                    partial)


def tf32_matmul(A, B):
    """One TF32 product a_hi b_hi, the same f32 accumulation."""
    return _mma_f32([(_tf32_rna(A), _tf32_rna(B))], A.shape[0], B.shape[1], A.shape[1])


@pytest.mark.parametrize("k,j", [(63, 128), (128, 128), (155, 64), (64, 3)],
                         ids=["layer1", "trunk", "layers_dir", "fc_rgb"])
@pytest.mark.parametrize("what", ["forward", "d_inp", "dW"])
def test_tf32x3_products_keep_f32_accuracy_at_the_classic_widths(k, j, what):
    """The three products the f32 kernels take at the classic layer widths
    (machina_classic: hidden 128, gamma(xyz) 63 rows, gamma(dir) 27): the
    forward W^T h and the backward W g (each k-tile's three products summed
    from zero, then added to the f32 sum) and the weight gradient A G^T over
    512 points (the products added to the sum itself). 3xTF32 stays within
    1e-6 of the largest entry of the float64 product; one TF32 product misses that by more than 1e-4, which is why
    the tolerances of rows 9 and 10 (1e-4 of a row, 2e-4 of a leaf) need the
    split."""
    rng = np.random.default_rng(k * 1000 + j)
    P = 512
    W = rng.uniform(-1, 1, (k, j)).astype(np.float32) * np.float32(np.sqrt(6.0 / (k + j)))
    if what == "forward":   # (j, k) @ (k, P): inputs are encodings or ReLU outputs
        A, B = W.T.copy(), np.abs(rng.standard_normal((k, P))).astype(np.float32)
        if k == 63:
            B = np.sin(rng.uniform(-3000, 3000, (k, P))).astype(np.float32)
    elif what == "d_inp":   # (k, j) @ (j, P): masked cotangents of either sign
        A, B = W, (rng.standard_normal((j, P)) * (rng.uniform(size=(j, P)) < 0.6)).astype(np.float32)
    else:                   # (k, P) @ (P, j): saved inputs times cotangents
        A = np.abs(rng.standard_normal((k, P))).astype(np.float32)
        B = rng.standard_normal((P, j)).astype(np.float32) * np.float32(1e-3)
    exact = A.astype(np.float64) @ B.astype(np.float64)
    scale = np.abs(exact).max()
    err3 = np.abs(tf32x3_matmul(A, B, partial=what != "dW") - exact).max() / scale
    err1 = np.abs(tf32_matmul(A, B) - exact).max() / scale
    assert err3 <= 1e-6, err3
    assert err1 > 1e-4, err1


def test_tf32_rounding_and_split():
    """rna rounds ties away from zero at bit 13; the halves add back to the
    operand to about 22 bits, exactly for a value with 11 significant bits."""
    x = np.array([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-11],
                 np.float32)
    assert np.array_equal(_tf32_rna(x), np.array([1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0,
                                                  1.0 + 2.0**-9], np.float32))
    v = np.random.default_rng(0).standard_normal(10000).astype(np.float32)
    hi, lo = _split(v)
    assert np.array_equal(_tf32_rna(hi), hi) and np.array_equal(_tf32_rna(lo), lo)
    rel = np.abs((hi.astype(np.float64) + lo) - v) / np.abs(v)
    assert rel.max() <= 2.0**-21
    assert np.array_equal(_split(x[:2])[0] + _split(x[:2])[1], x[:2])


def test_tensor_core_layout_of_the_main_config():
    """The f32 kernels' host-side layout: whole 16 x 8 A tiles of 256 floats
    (hi and lo), forward W^T of every layer and backward W of the layers
    whose input gets a cotangent, and activation buffers of whole k-tiles
    (the direction layer's 155 inputs -> 160 rows) within one block's shared
    memory, two blocks an SM."""
    from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import FRAG, tile_smem_bytes

    cfg = FlexibleNeRFConfig()
    model = ClassicNerf(Config(model_coarse=cfg, model_fine=None), device="cpu")
    lay = _Layout(ClassicNerf._fused_params(model.model_coarse), cfg)
    ceil = lambda a, b: -(-a // b)
    tiles_f = [ceil(o, 16) * ceil(i, 8) for i, o in zip(lay.ins, lay.outs)]
    assert tiles_f == [64, 128, 128, 128, 16, 128, 80, 8]
    tiles_b = [ceil(c, 16) * ceil(o, 8) if c else 0 for c, o in zip(lay.wb_cols, lay.outs)]
    assert tiles_b == [0, 128, 128, 128, 0, 128, 64, 4]
    assert lay.tf_size == FRAG * sum(tiles_f) and lay.tb_size == FRAG * sum(tiles_b)
    assert lay.tf_off == [FRAG * sum(tiles_f[:L]) for L in range(8)]
    assert lay.tb_off == [FRAG * sum(tiles_b[:L]) for L in range(8)]
    assert lay.tc_rows == 160
    assert tile_smem_bytes(lay, cfg) == 2 * 160 * 72 * 4
    assert 2 * tile_smem_bytes(lay, cfg) <= cuda_lib.SMEM_LIMIT
    bf = dataclasses.replace(cfg, compute_dtype="bfloat16")
    assert tile_smem_bytes(lay, bf) == 2 * 155 * 64 * 4
