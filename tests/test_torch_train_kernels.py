"""Gradient kernels of the port against the JAX package's Pallas kernels
(interpret mode), on the CPU, where the port's wrappers take their plain
versions: the CP encoder's VJP, the fused forward's VJP and the fused fine
train objective.

Tolerances. Both sides round at the same places and differ only in the order
of their f32 sums, so every gradient leaf is held to rtol 1e-3 / atol 1e-6
(what ``tests/test_fused_train.py::test_fused_objective_matches_autodiff``
uses). In bf16 mode a sum that lands on the other side of a bf16 rounding
boundary moves one rounded cotangent by 2^-8 of its value, so the bf16 cases
allow an atol of 2e-3 of the leaf's largest entry instead. The encoder's ``dlines`` in f32 mode: abs 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops import cp_grid_pallas as jcp
from nerf_kinematics_tpu.ops import ngp_fused_pallas as jf
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu_torch.ops import cp_grid_cuda as tcp
from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as tf
from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

CPS = {
    "periodic": dict(n_levels=3, n_components=8, base_resolution=8,
                     max_resolution=128, table_size=32),
    "hash": dict(n_levels=3, n_components=8, base_resolution=8,
                 max_resolution=128, table_size=32, fold="hash"),
    # F = 32 < T = 48: the wrap row lies inside the table, a dead row of its
    # own level (tests/test_fused.py::test_fused_fold_cap_grads_match_unfused)
    "fold_cap": dict(n_levels=3, n_components=16, base_resolution=8,
                     max_resolution=64, table_size=48, fold_cap=32),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _leaves(d):
    out = [("lines", d["lines"])]
    for k in ("dW", "db", "cW", "cb"):
        out += [(f"{k}[{i}]", t) for i, t in enumerate(d[k])]
    return out


def _check_grads(got, want, use_bf16):
    live = 0
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        atol = 2e-3 * scale if use_bf16 else 1e-6
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=atol, err_msg=name)
        live += scale > 0
    assert live >= 5, "too few live gradient leaves to trust parity"


# ---------------------------------------------------------------- row 5

@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("fold", sorted(CPS))
def test_cp_encode_vjp_matches_pallas_interpret(fold, use_bf16):
    cp = dict(CPS[fold], use_bf16=use_bf16)
    rng = np.random.default_rng(31)
    lines = _params(rng, cp)["lines"]
    x = rng.uniform(-0.02, 1.02, (7, 43, 3)).astype(np.float32)  # 301 points
    g = rng.standard_normal((7, 43, cp["n_levels"] * cp["n_components"])).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda l, p: jcp.cp_encode_pallas(l, p, JCP(**cp), 128, True),
        jnp.asarray(lines), jnp.asarray(x))
    dl_j, dx_j = vjp(jnp.asarray(g))
    assert not np.any(np.asarray(dx_j))

    tl = torch.tensor(lines, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out_t = tcp.cp_encode_cuda(tl, tx, CPGridConfig(**cp))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-4, atol=1e-5)
    out_t.backward(torch.tensor(g))
    assert tx.grad is None  # no gradient for the positions
    scale = np.abs(np.asarray(dl_j)).max()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(dl_j), rtol=1e-3,
                               atol=2e-3 * scale if use_bf16 else 1e-5)
    assert scale > 0.1
    direct = tcp.cp_encode_cuda_bwd(tl.detach(), tx.detach(), torch.tensor(g),
                                    CPGridConfig(**cp))
    assert torch.equal(direct, tl.grad)


def test_cp_encode_vjp_fold_semantics():
    """The wrap tap of a periodic folded level adds into row 0, a row F < T
    gets nothing from its own level, and an un-folded level never touches
    rows beyond R + 1."""
    cp = dict(CPS["fold_cap"], use_bf16=False)
    cfg = CPGridConfig(**cp)
    rng = np.random.default_rng(32)
    lines = torch.tensor(_params(rng, cp)["lines"])
    # points whose level-2 (R = 64, F = 32) cell is the last one of a period
    x = torch.tensor(rng.uniform(31.2 / 64, 31.9 / 64, (50, 3)).astype(np.float32))
    g = torch.ones((50, cfg.out_dim))
    dl = tcp.cp_encode_cuda_bwd(lines, x, g, cfg)
    F = cfg.level_fold(64)
    assert F == 32 < cfg.table_size
    assert dl[2, :, 0].abs().sum() > 0 and dl[2, :, F - 1].abs().sum() > 0
    assert dl[2, :, F:].abs().max() == 0  # the dead rows, F included
    assert cfg.level_fold(8) == 0 and dl[0, :, 10:].abs().max() == 0


# ---------------------------------------------------------------- row 6

@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("fold", sorted(CPS))
def test_fused_vjp_matches_pallas_interpret(fold, use_bf16):
    cp = dict(CPS[fold], use_bf16=use_bf16)
    rng = np.random.default_rng(33)
    params = _params(rng, cp)
    n = 300
    xt, vd = _points(rng, n)
    g = rng.standard_normal((4, n)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda p, a, b: jf.ngp_fused_apply_cf(p, a, b, JCP(**cp), 128, True),
        _to(params, jnp.asarray), jnp.asarray(xt), jnp.asarray(vd))
    d_j, dx_j, dv_j = vjp(jnp.asarray(g))
    assert not np.any(np.asarray(dx_j)) and not np.any(np.asarray(dv_j))

    cfg = CPGridConfig(**cp)
    live = _to(params, lambda a: torch.tensor(a, requires_grad=True))
    txt = torch.tensor(xt, requires_grad=True)
    tvd = torch.tensor(vd, requires_grad=True)
    out_t = tf.ngp_fused_apply_cf(live, txt, tvd, cfg)
    out_t.backward(torch.tensor(g))
    assert txt.grad is None and tvd.grad is None
    d_t = _to(live, lambda t: t.grad.numpy())
    _check_grads(d_t, d_j, use_bf16)
    # the wrapper, called directly, is the same function
    d_w = tf.ngp_fused_apply_cf_bwd(_to(params, torch.tensor), torch.tensor(xt),
                                    torch.tensor(vd), torch.tensor(g), cfg)
    for (name, a), (_, b) in zip(_leaves(d_w), _leaves(d_t)):
        assert np.array_equal(a.numpy(), b), name


def test_fused_vjp_sigma_gate_and_chunks(monkeypatch):
    """sigma's cotangent reaches feature 0 only where -15 < z0 < 15, and the
    plain version does not depend on its chunk size."""
    cp = dict(CPS["periodic"], use_bf16=False)
    cfg = CPGridConfig(**cp)
    rng = np.random.default_rng(34)
    params = _params(rng, cp)
    xt, vd = _points(rng, 500)
    g = np.zeros((4, 500), np.float32)
    g[3] = 1.0  # only sigma carries a cotangent
    p = _to(params, torch.tensor)
    args = (torch.tensor(xt), torch.tensor(vd), torch.tensor(g), cfg)
    d = tf.ngp_fused_apply_cf_bwd_ref(p, *args)
    assert d["db"][-1][0].abs() > 0 and d["cW"][0].abs().max() == 0
    monkeypatch.setattr(tf, "REF_CHUNK", 128)
    d2 = tf.ngp_fused_apply_cf_bwd_ref(p, *args)
    for (name, a), (_, b) in zip(_leaves(d), _leaves(d2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
    p["db"][-1][0] = 40.0  # z0 above the clamp everywhere: the gate closes
    d3 = tf.ngp_fused_apply_cf_bwd_ref(p, *args)
    assert all(t.abs().max() == 0 for _, t in _leaves(d3))


# ---------------------------------------------------------------- row 7

def _bsm(a, S, RB=128):
    """Ray-major (C, R*S) -> the reference's block-sample-major lanes."""
    C = a.shape[0]
    return a.reshape(C, -1, RB, S).transpose(0, 1, 3, 2).reshape(C, -1)


@pytest.mark.parametrize("use_bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("white_bg", [True, False], ids=["white", "black"])
@pytest.mark.parametrize("fold", ["periodic", "fold_cap"])
def test_fused_train_matches_pallas_interpret(fold, white_bg, use_bf16):
    cp = dict(CPS[fold], use_bf16=use_bf16)
    rng = np.random.default_rng(35)
    params = _params(rng, cp)
    params["db"][-1][0] += 1.5  # a denser field: transmittance really decays
    R, S = 128, 6
    xt, vd = _points(rng, R * S)
    vd = np.repeat(vd[:, :R], S, axis=1)  # one direction per ray
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    norm = rng.uniform(0.9, 1.1, (R, 1)).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 1e10, np.float32)],
                           axis=1) * norm
    dists = dists.reshape(1, -1).astype(np.float32)
    tgt = rng.uniform(size=(3, R)).astype(np.float32)
    inv = 1.0 / (3.0 * R)

    err_j, maps_j, d_j = jf.ngp_fused_train_cf(
        _to(params, jnp.asarray), jnp.asarray(_bsm(xt, S)), jnp.asarray(_bsm(vd, S)),
        jnp.asarray(_bsm(dists, S)), jnp.asarray(tgt), JCP(**cp), S, white_bg, inv,
        interpret=True)
    d_j = dict(d_j, lines=jf.fold_dlines(d_j["lines"], JCP(**cp)))

    err_t, maps_t, d_t = tf.ngp_fused_train_cf(
        _to(params, torch.tensor), torch.tensor(xt), torch.tensor(vd),
        torch.tensor(dists), torch.tensor(tgt), CPGridConfig(**cp), S, white_bg, inv)
    assert err_t.shape == (1, R) and maps_t.shape == (4, R)
    tol = 3e-3 if use_bf16 else 1e-5
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), rtol=0, atol=tol)
    np.testing.assert_allclose(err_t.numpy(), np.asarray(err_j), rtol=1e-4, atol=tol)
    assert 0.05 < maps_t[3].mean() <= 1.0 + 1e-5
    _check_grads(_to(d_t, lambda t: t.numpy()), d_j, use_bf16)


def test_fused_train_is_the_gradient_of_its_own_loss():
    """In f32 mode the returned gradients are those autograd finds for
    ``sum(err) * inv_denom`` through the plain forward and compositing."""
    from nerf_kinematics_tpu_torch.ops.volume_render import raw2outputs_cf

    cp = dict(CPS["hash"], use_bf16=False)
    cfg = CPGridConfig(**cp)
    rng = np.random.default_rng(36)
    params = _params(rng, cp)
    R, S = 40, 5
    xt, vd = _points(rng, R * S)
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    rays_d = rng.standard_normal((R, 3)).astype(np.float32)
    tgt = rng.uniform(size=(3, R)).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 1e10, np.float32)], 1)
    dists = (dists * np.linalg.norm(rays_d, axis=1, keepdims=True)).reshape(1, -1)

    err, maps, d = tf.ngp_fused_train_cf(
        _to(params, torch.tensor), torch.tensor(xt), torch.tensor(vd),
        torch.tensor(dists.astype(np.float32)), torch.tensor(tgt), cfg, S, True,
        1.0 / (3 * R))
    live = _to(params, lambda a: torch.tensor(a, requires_grad=True))
    raw4 = tf.ngp_fused_apply_cf_ref(live, torch.tensor(xt), torch.tensor(vd), cfg)
    out = raw2outputs_cf(raw4, torch.tensor(z), torch.tensor(rays_d), white_background=True)
    loss = torch.mean((out.rgb - torch.tensor(tgt).T) ** 2)
    loss.backward()
    np.testing.assert_allclose(float(err.sum() / (3 * R)), float(loss.detach()), rtol=1e-5)
    np.testing.assert_allclose(maps[:3].T.numpy(), out.rgb.detach().numpy(), atol=1e-5)
    for (name, a), (_, b) in zip(_leaves(d), _leaves(_to(live, lambda t: t.grad))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-6, err_msg=name)


def test_fused_train_refuses_ragged_inputs():
    cp = dict(CPS["periodic"])
    p = _to(_params(np.random.default_rng(37), cp), torch.tensor)
    x = torch.rand(3, 10)
    with pytest.raises(ValueError, match="multiple of S"):
        tf.ngp_fused_train_cf(p, x, x, torch.rand(1, 10), torch.rand(3, 3),
                              CPGridConfig(**cp), 3, True, 1.0)
    with pytest.raises(ValueError, match="tgt_cf"):
        tf.ngp_fused_train_cf(p, x, x, torch.rand(1, 10), torch.rand(3, 3),
                              CPGridConfig(**cp), 5, True, 1.0)
