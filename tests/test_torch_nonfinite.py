"""Non-finite inputs: the port's plain versions of rows 2-10 and its plain
encoder against the JAX package's functions, on the CPU: the Pallas kernels in
interpret mode, the XLA mirror ``cp_encode_stacked`` under ``jax.vjp``.

Each case sets one input non-finite: a NaN coordinate, a +inf and a -inf
coordinate, a NaN entry of one weight matrix, a NaN entry of one line-table
row and, for the gradients, a NaN and an inf cotangent entry. Rows 7 and 8
take their cotangent from their own loss. The NaN, +inf and -inf masks of
every output must be equal; the finite entries are held to the tolerances of
the files that hold the same functions on finite inputs
(``test_torch_fused.py``, ``test_torch_train_kernels.py``,
``test_torch_train_full.py``, ``test_torch_classic_fused.py``,
``test_torch_cp_encode.py``). Row 1's case is
``test_torch_occupancy.py::test_hull_lookup_nan_and_inf_points_match_the_reference``.

One Pallas call per row and case, at the smallest shapes that show the
pattern: 3 levels of 8 (or 16) channels, 200 points, 128 rays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRF as JFlexibleNeRF
from nerf_kinematics_tpu.models.flexible_nerf import FlexibleNeRFConfig as JFCfg
from nerf_kinematics_tpu.ops import cp_grid_pallas as jcp
from nerf_kinematics_tpu.ops import ngp_fused_pallas as jf
from nerf_kinematics_tpu.ops.classic_fused_pallas import classic_fused_apply_cf as j_classic
from nerf_kinematics_tpu.ops.cp_grid import CPGridConfig as JCP
from nerf_kinematics_tpu.ops.cp_grid import cp_encode_stacked as j_stacked
from nerf_kinematics_tpu_torch.ops import cp_grid_cuda as tcp
from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as tf
from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import (
    classic_fused_apply_cf, classic_fused_apply_cf_bwd)
from nerf_kinematics_tpu_torch.ops.cp_grid import (
    CPGridConfig, cp_encode_stacked, fold_salt, hash_fold_indices)
from nerf_kinematics_tpu_torch.train.config import FlexibleNeRFConfig

# levels 8 (un-folded), 32 and 128 (folded into the 32-row table)
CP = dict(n_levels=3, n_components=8, base_resolution=8, max_resolution=128,
          table_size=32)
# F = 32 < T = 48: the fused kernels' operand rows 33-47 lie in the table
FOLD_CAP = dict(n_levels=3, n_components=16, base_resolution=8,
                max_resolution=64, table_size=48, fold_cap=32)
N = 200

POINT_CASES = ("nan_point", "inf_point")
PARAM_CASES = ("nan_weight", "nan_line")
COT_CASES = ("nan_cot", "inf_cot")
MODES = [True, False]
MODE_IDS = ["bf16", "f32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _classes(a):
    """0 finite, 1 NaN, 2 +inf, 3 -inf."""
    a = np.asarray(a)
    return np.select([np.isnan(a), np.isposinf(a), np.isneginf(a)], [1, 2, 3], 0)


def _check(got, want, name, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    cg, cw = _classes(got), _classes(want)
    assert np.array_equal(cg, cw), (
        f"{name}: NaN {int((cg == 1).sum())} / {int((cw == 1).sum())}, "
        f"+inf {int((cg == 2).sum())} / {int((cw == 2).sum())}, "
        f"-inf {int((cg == 3).sum())} / {int((cw == 3).sum())} (port / reference), "
        f"first difference at {np.argwhere(cg != cw)[0].tolist()}")
    fin = cw == 0
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol, err_msg=name)
    return int((cw != 0).sum())


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


def _leaves(d):
    out = [("lines", d["lines"])]
    for k in ("dW", "db", "cW", "cb"):
        out += [(f"{k}[{i}]", t) for i, t in enumerate(d[k])]
    return out


def _points(rng, n):
    xt = rng.uniform(-0.02, 1.02, (3, n)).astype(np.float32)
    vd = rng.standard_normal((3, n)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=0, keepdims=True)
    return xt, vd


def _spoil(case, xt=None, params=None, g=None):
    """Set the case's input non-finite, in place. ``xt`` is (3, n)."""
    if case == "nan_point":
        xt[0, 3] = np.nan
    elif case == "inf_point":
        xt[1, 5] = np.inf
        xt[2, 7] = -np.inf
    elif case == "nan_weight":
        params["dW"][1][2, 5] = np.nan
    elif case == "nan_line":
        params["lines"][1, 2, 5, 3] = np.nan  # a contracted row of level 1
    elif case == "nan_cot":
        g[3, 2] = np.nan
    elif case == "inf_cot":
        g[3, 2] = np.inf
        g[7, 1] = -np.inf
    else:
        raise ValueError(case)


# ---------------------------------------------------------------- row 4

@pytest.mark.parametrize("use_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("case", POINT_CASES + ("nan_line",))
def test_row4_encoder(case, use_bf16):
    cp = dict(CP, use_bf16=use_bf16)
    rng = np.random.default_rng(1)
    params = _params(rng, cp)
    xt, _ = _points(rng, N)
    _spoil(case, xt, params)
    x = xt.T.copy()
    want = jcp.cp_encode_pallas(jnp.asarray(params["lines"]), jnp.asarray(x), JCP(**cp),
                                128, True)
    got = tcp.cp_encode_cuda(torch.tensor(params["lines"]), torch.tensor(x), CPGridConfig(**cp))
    bad = _check(got, want, "encoding", rtol=0, atol=1e-5)
    assert bad or case == "inf_point"


# ---------------------------------------------------------------- row 5

def _cases(both, f32_only=(), prefix=()):
    """Parameters ``(*prefix, case, use_bf16)``: the cases of ``both`` in
    both modes, those of ``f32_only`` in f32 mode only (cases that repeat a
    rule in the other mode are left out to keep the file cheap)."""
    out = [pytest.param(*prefix, c, bf, id="-".join((*prefix, c, i)))
           for c in both for bf, i in zip(MODES, MODE_IDS)]
    return out + [pytest.param(*prefix, c, False, id="-".join((*prefix, c, "f32")))
                  for c in f32_only]


@pytest.mark.parametrize(
    "fold,case,use_bf16",
    _cases(("nan_point", "inf_point", "nan_line") + COT_CASES, prefix=("periodic",))
    + _cases((), ("nan_point",) + COT_CASES, prefix=("fold_cap",))
    + _cases(("nan_point",), prefix=("hash",)))
def test_row5_line_table_gradient(fold, case, use_bf16):
    cp = dict(FOLD_CAP if fold == "fold_cap" else CP, use_bf16=use_bf16)
    if fold == "hash":
        cp["fold"] = "hash"
    rng = np.random.default_rng(2)
    params = _params(rng, cp)
    xt, _ = _points(rng, N)
    LC = cp["n_levels"] * cp["n_components"]
    g = rng.standard_normal((N, LC)).astype(np.float32)
    _spoil(case, xt, params, g)
    x, lines = xt.T.copy(), params["lines"]
    _, vjp = jax.vjp(lambda t: jcp.cp_encode_pallas(t, jnp.asarray(x), JCP(**cp), 128, True),
                     jnp.asarray(lines))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = tcp.cp_encode_cuda_bwd(torch.tensor(lines), torch.tensor(x), torch.tensor(g),
                                 CPGridConfig(**cp))
    scale = np.abs(np.where(np.isfinite(want), want, 0)).max()
    bad = _check(got, want, "dlines", rtol=1e-3,
                 atol=2e-3 * scale if use_bf16 else 1e-5)
    assert bad or case == "inf_point"


@pytest.mark.parametrize("use_bf16", MODES, ids=MODE_IDS)
def test_rows4_5_nan_point_on_a_hash_folded_level(use_bf16):
    """A NaN coordinate on a hash-folded level: the reference makes one
    integer of it for both cells, so its tent is NaN on one hashed row.
    The encoding is NaN in every channel of that point; the gradient of the
    NaN axis' table is NaN on that row only, in every column, and finite on
    its other rows; the other axes' tables are NaN in every contracted row
    (their cotangent is NaN)."""
    cp = dict(CP, fold="hash", use_bf16=use_bf16)
    cfg = CPGridConfig(**cp)
    rng = np.random.default_rng(4)
    lines = _params(rng, cp)["lines"]
    xt, _ = _points(rng, N)
    _spoil("nan_point", xt)
    x = xt.T.copy()
    g = rng.standard_normal((N, 24)).astype(np.float32)
    enc, vjp = jax.vjp(lambda t: jcp.cp_encode_pallas(t, jnp.asarray(x), JCP(**cp), 128, True),
                       jnp.asarray(lines))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got_enc = tcp.cp_encode_cuda(torch.tensor(lines), torch.tensor(x), cfg)
    _check(got_enc, enc, "encoding", rtol=0, atol=1e-5)
    assert np.isnan(np.asarray(got_enc)[3]).all()
    got = tcp.cp_encode_cuda_bwd(torch.tensor(lines), torch.tensor(x), torch.tensor(g), cfg)
    scale = np.abs(np.where(np.isfinite(want), want, 0)).max()
    _check(got, want, "dlines", rtol=1e-3, atol=2e-3 * scale if use_bf16 else 1e-5)
    got = got.numpy()
    for l, R in enumerate(cfg.resolutions):
        if not cfg.level_fold(R):
            continue  # an un-folded level: the tent of a NaN is NaN on every row
        row = int(hash_fold_indices(torch.zeros(1), cfg.level_fold(R), fold_salt(l, 0))[0])
        nan_rows = np.flatnonzero(np.isnan(got[l, 0]).any(axis=1))
        assert nan_rows.tolist() == [row] and np.isnan(got[l, 0, row]).all(), (l, nan_rows)
        assert np.isnan(got[l, 1, :cfg.level_rows(R)]).all()


# ------------------------------------------------- the plain encoder (mirror)

@pytest.mark.parametrize("case", ("inf_point", "nan_line") + COT_CASES)
def test_plain_encoder_gradient_matches_the_xla_mirror(case):
    """The plain encoder under autograd gives the classes of ``jax.vjp`` of
    the XLA mirror, whose dense product spans all T rows. (A NaN coordinate
    is not a case: the mirror makes an integer of it, which the platform
    decides, ROADMAP.md section C.)"""
    cp = dict(CP, use_bf16=False)
    rng = np.random.default_rng(3)
    params = _params(rng, cp)
    xt, _ = _points(rng, N)
    g = rng.standard_normal((N, 24)).astype(np.float32)
    _spoil(case, xt, params, g)
    x, lines = xt.T.copy(), params["lines"]
    out_j, vjp = jax.vjp(lambda t: j_stacked(t, jnp.asarray(x), JCP(**cp)), jnp.asarray(lines))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tl = torch.tensor(lines, requires_grad=True)
    out = cp_encode_stacked(tl, torch.tensor(x), CPGridConfig(**cp))
    _check(out.detach(), out_j, "encoding", rtol=0, atol=1e-6)
    out.backward(torch.tensor(g))
    bad = _check(tl.grad, want, "dlines", rtol=1e-4, atol=1e-5)
    assert bad or case == "inf_point"


# ---------------------------------------------------------------- rows 2, 3

@pytest.mark.parametrize("use_bf16", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("case", POINT_CASES + PARAM_CASES)
def test_rows2_3_fused_forwards(case, use_bf16):
    cp = dict(CP, use_bf16=use_bf16)
    rng = np.random.default_rng(4)
    params = _params(rng, cp)
    xt, vd = _points(rng, N)
    _spoil(case, xt, params)
    jp, tp, cfg = _to(params, jnp.asarray), _to(params, torch.tensor), CPGridConfig(**cp)
    want2 = jf.ngp_fused_sigma_cf(jp, jnp.asarray(xt), JCP(**cp), 128, True)
    got2 = tf.ngp_fused_sigma_cf(tp, torch.tensor(xt), cfg)
    want3 = jf.ngp_fused_apply_cf(jp, jnp.asarray(xt), jnp.asarray(vd), JCP(**cp), 128, True)
    got3 = tf.ngp_fused_apply_cf(tp, torch.tensor(xt), torch.tensor(vd), cfg)
    bad = 0
    for got, want, name in ((got2, want2, "row 2"), (got3, want3, "row 3")):
        got, want = np.asarray(got), np.asarray(want)
        if use_bf16:
            bad += _check(got[:3], want[:3], f"{name} rgb", rtol=0, atol=3e-3)
            bad += _check(got[3], want[3], f"{name} sigma", rtol=3e-3, atol=0)
        else:
            bad += _check(got, want, name)
    assert bad or case == "inf_point"


# ---------------------------------------------------------------- row 6

@pytest.mark.parametrize("case,use_bf16", _cases(
    ("nan_point",) + COT_CASES, ("inf_point",) + PARAM_CASES))
def test_row6_fused_vjp(case, use_bf16):
    cp = dict(FOLD_CAP, use_bf16=use_bf16)
    rng = np.random.default_rng(5)
    params = _params(rng, cp)
    xt, vd = _points(rng, N)
    g = rng.standard_normal((4, N)).astype(np.float32)
    _spoil(case, xt, params, g.T)
    _, vjp = jax.vjp(
        lambda p: jf.ngp_fused_apply_cf(p, jnp.asarray(xt), jnp.asarray(vd), JCP(**cp), 128, True),
        _to(params, jnp.asarray))
    want = vjp(jnp.asarray(g))[0]
    got = tf.ngp_fused_apply_cf_bwd(_to(params, torch.tensor), torch.tensor(xt),
                                    torch.tensor(vd), torch.tensor(g), CPGridConfig(**cp))
    _check_grads(got, want, use_bf16, case)


def _check_grads(got, want, use_bf16, case):
    bad = 0
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        b = np.asarray(b)
        scale = np.abs(np.where(np.isfinite(b), b, 0)).max()
        bad += _check(a, b, name, rtol=1e-3, atol=2e-3 * scale if use_bf16 else 1e-6)
    assert bad or case == "inf_point"


# ---------------------------------------------------------------- row 7

def _bsm(a, S, RB=128):
    """Ray-major (C, R*S) -> the reference's block-sample-major lanes."""
    C = a.shape[0]
    return a.reshape(C, -1, RB, S).transpose(0, 1, 3, 2).reshape(C, -1)


@pytest.mark.parametrize("case,use_bf16", _cases(("nan_point",), ("inf_point",) + PARAM_CASES))
def test_row7_fused_train(case, use_bf16):
    cp = dict(FOLD_CAP, use_bf16=use_bf16)
    rng = np.random.default_rng(6)
    params = _params(rng, cp)
    params["db"][-1][0] += 1.5  # a denser field: transmittance really decays
    R, S = 128, 4
    xt, vd = _points(rng, R * S)
    vd = np.repeat(vd[:, :R], S, axis=1)  # one direction per ray
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)), axis=1).astype(np.float32)
    dists = np.concatenate([z[:, 1:] - z[:, :-1], np.full((R, 1), 1e10, np.float32)], axis=1)
    dists = dists.reshape(1, -1).astype(np.float32)
    tgt = rng.uniform(size=(3, R)).astype(np.float32)
    _spoil(case, xt, params)
    inv = 1.0 / (3.0 * R)
    err_j, maps_j, d_j = jf.ngp_fused_train_cf(
        _to(params, jnp.asarray), jnp.asarray(_bsm(xt, S)), jnp.asarray(_bsm(vd, S)),
        jnp.asarray(_bsm(dists, S)), jnp.asarray(tgt), JCP(**cp), S, True, inv,
        interpret=True)
    d_j = dict(d_j, lines=jf.fold_dlines(d_j["lines"], JCP(**cp)))
    err_t, maps_t, d_t = tf.ngp_fused_train_cf(
        _to(params, torch.tensor), torch.tensor(xt), torch.tensor(vd), torch.tensor(dists),
        torch.tensor(tgt), CPGridConfig(**cp), S, True, inv)
    tol = 3e-3 if use_bf16 else 1e-5
    _check(maps_t, maps_j, "maps", rtol=0, atol=tol)
    _check(err_t, err_j, "err", rtol=1e-4, atol=tol)
    _check_grads(d_t, d_j, use_bf16, case)


# ---------------------------------------------------------------- row 8

@pytest.mark.parametrize("case", ("nan_point", "inf_point", "nan_weight", "nan_line"))
def test_row8_whole_step(case):
    """Rays of 4 coarse and 3 fine samples over 4 proposal bins of an 8^3
    grid; the coordinate cases set a ray's origin. f32 operands."""
    cp = dict(FOLD_CAP, use_bf16=False)
    rng = np.random.default_rng(7)
    params = _params(rng, cp)
    R, S, Sc, NB, Rg = 128, 3, 4, 4, 8
    o = (0.1 * rng.standard_normal((3, R))).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    vd = d.copy()
    tgt = rng.uniform(size=(3, R)).astype(np.float32)
    uc = np.sort(rng.uniform(size=(Sc, R)), axis=0).astype(np.float32)
    uf = np.sort(rng.uniform(size=(S, R)), axis=0).astype(np.float32)
    proj2 = rng.uniform(0.0, 5.0, (3, Rg, Rg)).astype(np.float32)
    _spoil(case, o, params)
    statics = dict(near=0.5, far=3.0, bound=1.0, occ_floor=0.01)
    inv = 1.0 / (3.0 * R)
    ej, mj, ecj, dj = jf.ngp_fused_train_full_cf(
        _to(params, jnp.asarray), *(jnp.asarray(a) for a in (o, d, vd, tgt, uc, uf, proj2)),
        JCP(**cp), S, Sc, NB, True, inv, interpret=True, **statics)
    dj = dict(dj, lines=jf.fold_dlines(dj["lines"], JCP(**cp)))
    et, mt, ect, dt = tf.ngp_fused_train_full_cf(
        _to(params, torch.tensor), *(torch.tensor(a) for a in (o, d, vd, tgt, uc, uf, proj2)),
        CPGridConfig(**cp), S, Sc, NB, True, inv, **statics)
    for got, want, name in ((et, ej, "err"), (mt, mj, "maps"), (ect, ecj, "err_c")):
        _check(got, want, name, rtol=1e-5, atol=1e-7)
    _check_grads(dt, dj, False, case)


# ---------------------------------------------------------------- rows 9, 10

SMALL = dict(hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
NAMES = lambda t: (["layer1"] + [f"layers_xyz_{i}" for i in range(t - 1)]
                   + ["fc_alpha", "fc_feat", "layers_dir_0", "fc_rgb"])


def _classic(dtype, n=N, seed=0):
    cfg = JFCfg(**SMALL, compute_dtype=dtype)
    x0 = np.zeros((1, 3), np.float32)
    tree = jax.tree_util.tree_map(np.asarray, JFlexibleNeRF(cfg).init(
        jax.random.PRNGKey(seed), x0, x0))["params"]
    rng = np.random.default_rng(seed + 1)
    W = [tree[k]["kernel"].copy() for k in NAMES(cfg.trunk_depth)]
    b = [(0.1 * rng.standard_normal((w.shape[1], 1))).astype(np.float32) for w in W]
    x = rng.uniform(-4.0, 4.0, (3, n)).astype(np.float32)
    vd = rng.standard_normal((3, n)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=0, keepdims=True)
    tcfg = FlexibleNeRFConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    return cfg, tcfg, {"W": W, "b": b}, x, vd


def _classic_spoil(case, params, x, g):
    if case == "nan_weight":
        params["W"][1][2, 5] = np.nan
    elif case in POINT_CASES:
        _spoil(case, x)
    else:
        _spoil(case, g=g)


@pytest.mark.parametrize("case,use_bf16", _cases(
    ("nan_point", "inf_cot"), ("inf_point", "nan_weight", "nan_cot")))
def test_rows9_10_classic(case, use_bf16):
    dtype = "bfloat16" if use_bf16 else "float32"
    cfg, tcfg, params, x, vd = _classic(dtype)
    g = np.random.default_rng(9).standard_normal((4, x.shape[1])).astype(np.float32)
    _classic_spoil(case, params, x, g.T)
    jp = {k: [jnp.asarray(a) for a in v] for k, v in params.items()}
    tp = {k: [torch.tensor(a) for a in v] for k, v in params.items()}
    out_j, vjp = jax.vjp(lambda p: j_classic(p, jnp.asarray(x), jnp.asarray(vd), cfg, 128, True),
                         jp)
    bf16 = dtype == "bfloat16"
    if case not in COT_CASES:
        got = classic_fused_apply_cf(tp, torch.tensor(x), torch.tensor(vd), tcfg)
        _check(got, out_j, "row 9", rtol=0 if bf16 else 2e-5, atol=2e-2 if bf16 else 2e-6)
    dp = vjp(jnp.asarray(g))[0]
    got = classic_fused_apply_cf_bwd(tp, torch.tensor(x), torch.tensor(vd), torch.tensor(g), tcfg)
    bad = 0
    for key in ("W", "b"):
        for i, (a, w) in enumerate(zip(got[key], dp[key])):
            w = np.asarray(w)
            scale = np.abs(np.where(np.isfinite(w), w, 0)).max()
            bad += _check(a, w, f"{key}[{i}]", rtol=5e-4,
                          atol=2e-2 * scale if bf16 else 5e-6)
    assert bad
