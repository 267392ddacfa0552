"""Contracted scenes (aabb_scale > 2, the fox regime) on the CPU: the
contraction maps against the JAX package's, the engine's switch, the
occupancy refreshes and the density grid through the contracted map, one
train step against the JAX engine's on three routes, and the halo scene
trained without collapse.

Tolerances. The maps: rtol 1e-6 / atol 1e-6 (f32 elementwise; the same
formula). The step follows tests/test_torch_train_step.py with f32 tables
and weights: losses rtol 1e-5, gradients leaf for leaf rtol 1e-3 / atol 1e-6,
the updated parameters within 1e-6 where |g| > 2e-6 (the first Adam step is
``-lr sign(g)``), Adam's first moment rtol 1e-3 / atol 1e-7. The routes:
``module`` (the fused forward and its gradient, rows 3 and 6, as plain
versions; coarse samples only, as ``configs/fox_ngp.yml`` trains),
``two_call`` (the density-only coarse pass and the fused objective, rows 2
and 7, whose points are built channels first) and ``hash`` (the hash
encoder through the unfused model). The density grid and the occupancy
refreshes: rtol 1e-4 / atol 1e-6, as tests/test_torch_train_step.py holds
the linear ones.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
from nerf_kinematics_tpu.ops import contraction as jc
from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid as JGrid
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics
from nerf_kinematics_tpu_torch.io import convert
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
from nerf_kinematics_tpu_torch.ops import contraction as tc
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train import loop as tloop
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

N_RAYS, N_COARSE, OCC = 128, 8, 16
BOUND = 8.0  # contraction on (auto), inner = 2
NEAR, FAR = 1.0, 14.0
HASH_GRID = {"n_levels": 4, "n_features": 2, "log2_table_size": 10,
             "base_resolution": 4, "max_resolution": 32}
# route -> (encoder, fused, fused_train, fine samples)
ROUTES = {"module": ("cp_pallas", "on", "off", 0),
          "two_call": ("cp_pallas", "on", "auto", 6),
          "hash": ("hash", "auto", "auto", 0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------- the maps

def _points(seed=0, n=512):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((n, 3)) * np.array([0.5, 5.0, 50.0])).astype(np.float32)
    pts[:4] = [[0, 0, 0], [1, -1, 1], [2, 0.5, -0.25], [-1e4, 3, 7]]
    return pts


@pytest.mark.parametrize("inner", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("fn", ["contract", "contract_to_unit"])
def test_forward_maps_match_jax(fn, inner):
    pts = _points()
    want = np.asarray(getattr(jc, fn)(jnp.asarray(pts), inner))
    got = getattr(tc, fn)(torch.tensor(pts), inner).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    lo, hi = (-2.0, 2.0) if fn == "contract" else (0.0, 1.0)
    assert (got >= lo).all() and (got <= hi).all()
    # the linear region
    inside = np.abs(pts).max(-1) <= inner
    lin = pts[inside] / inner if fn == "contract" else pts[inside] / inner * 0.25 + 0.5
    np.testing.assert_allclose(got[inside], lin, atol=1e-6)


@pytest.mark.parametrize("inner", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("fn", ["uncontract", "unit_to_world"])
def test_inverse_maps_match_jax_and_round_trip(fn, inner):
    rng = np.random.default_rng(1)
    if fn == "uncontract":
        u = rng.uniform(-1.999, 1.999, (512, 3)).astype(np.float32)
        u[:2] = [[2.0, 0.0, 0.0], [0.3, -0.2, 0.1]]  # the clamped boundary
    else:
        u = (rng.uniform(size=(512, 3)) * 0.96 + 0.02).astype(np.float32)
    want = np.asarray(getattr(jc, fn)(jnp.asarray(u), inner))
    got = getattr(tc, fn)(torch.tensor(u), inner)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got).all()
    forward = tc.contract if fn == "uncontract" else tc.contract_to_unit
    np.testing.assert_allclose(forward(got, inner)[2:].numpy(), u[2:], rtol=1e-4, atol=1e-5)


def test_contraction_keeps_a_nan_point():
    """A NaN coordinate makes the point's norm NaN in both packages: all
    three contracted coordinates are NaN."""
    pts = np.array([[np.nan, 0.5, 3.0], [0.1, 0.2, 0.3]], np.float32)
    want = np.asarray(jc.contract_to_unit(jnp.asarray(pts), 2.0))
    got = tc.contract_to_unit(torch.tensor(pts), 2.0).numpy()
    assert np.isnan(got[0]).all() and np.isnan(want[0]).all()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


# --------------------------------------------------------------- the engine

def _raw(route="two_call", bound_occ=True):
    encoder, fused, fused_train, n_fine = ROUTES[route]
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": encoder, "n_levels": 3, "n_components": 16,
            "table_size": 48, "base_resolution": 8, "max_resolution": 32,
            "grid": dict(HASH_GRID),
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": bound_occ, "occ_resolution": OCC,
            "occ_bins": 8, "fused": fused, "fused_train": fused_train,
            "occ_incremental_cells": 300, "cp": {"use_bf16": False},
        },
        "dataset": {"near": NEAR, "far": FAR},
        "nerf": {
            "train": {"num_coarse": N_COARSE, "num_fine": n_fine,
                      "white_background": True, "num_random_rays": N_RAYS,
                      "pixel_sampler": "shuffled"},
            "validation": {"num_coarse": N_COARSE, "num_fine": n_fine,
                           "perturb": False, "white_background": True},
            "coarse_loss_weight": 0.0,
        },
        "optimizer": {"lr": 0.01},
        "scheduler": {"lr_decay": 6, "lr_decay_factor": 0.33},
    }


def _draws(n_fine, seed=5, n_total=300):
    """Rays from outside the linear region through the whole box, targets,
    the window offset and the depth jitter."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_total, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = -6.0 * d + 1.5 * rng.standard_normal((n_total, 3)).astype(np.float32)
    out = {
        "ray_buf": {"rays_o": o.astype(np.float32), "rays_d": d,
                    "target": rng.uniform(size=(n_total, 3)).astype(np.float32)},
        "offset": 37,
        "u_coarse": rng.uniform(size=(N_RAYS, N_COARSE)).astype(np.float32),
    }
    if n_fine:
        out["u_fine"] = rng.uniform(size=(N_RAYS, n_fine)).astype(np.float32)
    return out


def _grid():
    """A blob in the contracted cube's cells, thin elsewhere."""
    lin = (np.arange(OCC) + 0.5) / OCC * 2 - 1
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xs**2 + 1.3 * ys**2 + 0.8 * zs**2)
    return np.where(r < 0.6, 20.0 * (1.0 - r), 0.05).astype(np.float32)


def _patch_jax_draws(monkeypatch, draws):
    by_shape = {(N_RAYS, N_COARSE): draws["u_coarse"]}
    if "u_fine" in draws:
        by_shape[draws["u_fine"].shape] = draws["u_fine"]

    real_uniform = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, **kw):
        if tuple(shape) not in by_shape:  # the hash table's init, traced for its shape
            return real_uniform(key, shape, dtype, **kw)
        return jnp.asarray(by_shape[tuple(shape)], dtype)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.asarray(draws["offset"], dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


class _Pair:
    """Both engines on one contracted scene, the same fresh weights and grid."""

    def __init__(self, route, use_occ=True):
        raw = _raw(route, use_occ)
        self.je = JEngine(jcfg.config_from_dict(raw), scene_bound=BOUND)
        self.jstate = self.je.init_state(seed=9)
        tree = jax.tree_util.tree_map(np.array, self.jstate.params["coarse"])
        self.te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=BOUND, device="cpu")
        self.te.load_flax_params(tree)
        self.tstate = self.te.init_state(seed=9, keep_weights=True)
        if use_occ:
            dens = _grid()
            self.jstate = self.jstate._replace(aux=JGrid(jnp.asarray(dens), jnp.float32(BOUND)))
            self.tstate.aux = grid_from_numpy(dens, BOUND)
        ti = machina_intrinsics(16)
        self.tintr = ti
        self.jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                                 width=16, height=16)

    def named(self, tree):
        return convert.named_from_flax(jax.tree_util.tree_map(np.asarray, tree))


def test_engine_contraction_resolves_by_bound():
    """As tests/test_contraction.py::test_engine_contraction_resolves_by_bound,
    with the JAX engine beside: the switch, ``inner`` and the unit map."""
    for bound, inner in ((1.0, None), (2.0, None), (4.0, 1.0), (16.0, 4.0)):
        raw = _raw("two_call")
        te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=bound, device="cpu")
        je = JEngine(jcfg.config_from_dict(raw), scene_bound=bound)
        assert te.contracted == je.contracted == (inner is not None)
        if inner is not None:
            assert te._inner == je._inner == inner
        far_pts = np.array([[40.0, -12.0, 3.0], [0.1, 0.0, -0.05], [3.9, 3.9, -3.9]],
                           np.float32)
        got = te._to_unit(torch.tensor(far_pts)).numpy()
        np.testing.assert_allclose(got, np.asarray(je._to_unit(jnp.asarray(far_pts))),
                                   rtol=1e-6, atol=1e-7)
        # channels first: the same points
        cf = te._to_unit_cf(torch.tensor(far_pts).T.contiguous()).T.numpy()
        np.testing.assert_array_equal(cf, got)
        if te.contracted:
            assert (got >= 0.0).all() and (got <= 1.0).all()
    raw = _raw("two_call")
    raw["ngp"]["contraction"] = "off"
    assert not NGPEngine(tcfg.config_from_dict(raw), scene_bound=16.0, device="cpu").contracted
    raw["ngp"]["contraction"], raw["ngp"]["contract_inner"] = "on", 3.0
    on = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
    assert on.contracted and on._inner == 3.0
    # the whole step in one call refuses a contracted scene, as the JAX engine does
    raw = _raw("two_call")
    raw["ngp"]["fused_train"] = "full"
    for eng in (NGPEngine(tcfg.config_from_dict(raw), scene_bound=BOUND, device="cpu"),
                JEngine(jcfg.config_from_dict(raw), scene_bound=BOUND)):
        with pytest.raises(ValueError, match="non-contracted scene"):
            eng.fused_objective_fn(NEAR, FAR, eng.cfg.nerf.train)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_contracted_step_matches_jax(route, monkeypatch):
    """One whole train step on a contracted scene (bound 8, inner 2) with the
    occupancy proposal in contracted space: loss, the gradients leaf for
    leaf, the updated parameters and Adam's moments."""
    n_fine = ROUTES[route][3]
    pr = _Pair(route)
    draws = _draws(n_fine)
    _patch_jax_draws(monkeypatch, draws)
    settings = pr.je.cfg.nerf.train
    one_call = route == "two_call"
    assert (pr.je.fused_objective_fn(NEAR, FAR, settings) is not None) == one_call
    assert (pr.te.fused_objective_fn(NEAR, FAR, pr.te.cfg.nerf.train) is not None) == one_call
    assert pr.te.fused == (route != "hash")

    jbuf = {k: jnp.asarray(v) for k, v in draws["ray_buf"].items()}
    jstep = pr.je.make_train_step(pr.jintr, NEAR, FAR, False, donate=False)
    jnew, jm = jstep(pr.jstate, None, None, jbuf)

    u_fine = torch.tensor(draws["u_fine"]) if n_fine else None
    tbuf = {k: torch.tensor(v) for k, v in draws["ray_buf"].items()}
    tstep = pr.te.make_train_step(pr.tintr, NEAR, FAR, False)
    before = pr.tstate.clone()
    tnew, tm = tstep(pr.tstate, None, None, tbuf, offset=draws["offset"],
                     u_coarse=torch.tensor(draws["u_coarse"]), u_fine=u_fine)
    for k in ("loss", "loss_coarse", "loss_fine", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)

    # ---- gradients, leaf by leaf ------------------------------------------
    sl = slice(draws["offset"], draws["offset"] + N_RAYS)
    o, d, t = (draws["ray_buf"][k][sl] for k in ("rays_o", "rays_d", "target"))
    vdn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    jbatch = tuple(jnp.asarray(a) for a in (o, d, vdn, t))
    key = jax.random.PRNGKey(0)
    jobj = pr.je.fused_objective_fn(NEAR, FAR, settings)
    if jobj is not None:
        _, jg = jobj(pr.jstate.params, jbatch, key, pr.jstate.aux)
    else:
        from nerf_kinematics_tpu.rendering.renderer import render_rays

        def loss_fn(params):
            cf_c, cf_f = pr.je.cf_apply_fns()
            coarse, fine = render_rays(
                params["coarse"], pr.je.apply_coarse, jbatch[0], jbatch[1], NEAR, FAR,
                settings, key=key, use_viewdirs=True, viewdirs=jbatch[2],
                proposal_fn=pr.je.proposal_for(pr.jstate.aux, NEAR, FAR, settings),
                apply_coarse_cf=cf_c, apply_fine_cf=cf_f)
            return jnp.mean(((fine or coarse).rgb - jbatch[3]) ** 2)

        jg = jax.grad(loss_fn)(pr.jstate.params)
    jgrads = pr.named(jg["coarse"])
    objective = tloop.build_objective(pr.te, NEAR, FAR)
    pr.te.layout.bind(pr.te.model, before.params)
    tbatch = tuple(torch.tensor(a) for a in (o, d, vdn, t))
    (_, (tlc, tlf)), tgrads = objective(tbatch, before.aux, before.generator,
                                        u_coarse=torch.tensor(draws["u_coarse"]),
                                        u_fine=u_fine)
    np.testing.assert_allclose(float(tlf), float(jm["loss_fine"]), rtol=1e-5)
    assert set(tgrads) == set(jgrads)
    assert ("hash_table" in tgrads) == (route == "hash")
    live = 0
    for name, want in jgrads.items():
        got = tgrads[name].numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6, err_msg=name)
        live += np.abs(want).max() > 0
    assert live >= 5

    # ---- updated parameters and Adam's first moment -------------------------
    layout = pr.te.layout
    g_flat = layout.flatten({k: torch.tensor(v) for k, v in jgrads.items()}).numpy()
    p_new = layout.flatten({k: torch.tensor(v) for k, v in
                            pr.named(jnew.params["coarse"]).items()}).numpy()
    sure = np.abs(g_flat) > 2e-6
    assert sure.sum() > 500
    diff = np.abs(tnew.params.numpy() - p_new)
    assert diff[sure].max() <= 1e-6
    assert diff.max() <= 2 * 0.01 + 1e-6
    P = layout.total
    mu = next(np.asarray(l) for l in jax.tree_util.tree_leaves(jnew.opt_state)
              if np.size(l) == P)
    np.testing.assert_allclose(tnew.opt_state.mu.numpy(),
                               convert.flat_from_reference(mu, layout).numpy(),
                               rtol=1e-3, atol=1e-7)


def test_contracted_occupancy_refreshes_match_jax(monkeypatch):
    """The full sweep and the incremental refresh query the model at
    ``unit_to_world`` of the cells' jittered points: the grids agree."""
    pr = _Pair("module")
    rng = np.random.default_rng(6)
    u_full = rng.uniform(size=(OCC**3, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u_full).reshape(shape))
    want = np.asarray(pr.je.update_occupancy(pr.jstate, full=True).aux.density)
    got = pr.te.update_occupancy(pr.tstate.aux, full=True, u=torch.tensor(u_full))
    np.testing.assert_allclose(got.density.numpy(), want, rtol=1e-4, atol=1e-6)
    assert not np.allclose(want, 0.95 * _grid())  # the sweep changed cells

    n_cells = pr.te.ngp_config.occ_incremental_cells
    idx = rng.integers(0, OCC**3, n_cells)
    u = rng.uniform(size=(n_cells, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi, dtype=jnp.int32: jnp.asarray(idx, dtype))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u).reshape(shape))
    want = np.asarray(pr.je.update_occupancy(pr.jstate, full=False).aux.density)
    got = pr.te.update_occupancy(pr.tstate.aux, full=False, idx=torch.tensor(idx),
                                 u=torch.tensor(u))
    np.testing.assert_allclose(got.density.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("route", ["module", "hash"])
def test_contracted_density_grid_matches_jax(route):
    """``density_grid`` over the world box [-bound, bound]^3 through the
    contracted map, with the reference's axis order."""
    pr = _Pair(route)
    want = np.asarray(pr.je.density_grid(pr.jstate.params, resolution=12))
    got = pr.te.density_grid(resolution=12).numpy()
    assert got.shape == (12, 12, 12)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_weight_decay_exempts_the_hash_table():
    """The decay mask covers the MLP kernels only: never ``hash_table`` (nor
    ``cp_lines``), as the reference's mask."""
    te = NGPEngine(tcfg.config_from_dict(_raw("hash")), scene_bound=BOUND, device="cpu")
    mask = te.layout.decay_mask()
    for name, _, off, n in te.layout.entries:
        want = tloop.WEIGHT_DECAY if name.endswith(".kernel") else 0.0
        assert (mask[off:off + n] == want).all(), name
    assert "hash_table" in dict(te.model.named_parameters())
    assert te.model.hash_table.shape == (4, 1024, 2)


def test_fox_regime_halo_scene_trains_without_collapse():
    """The port's counterpart of tests/test_contraction.py::
    test_fox_regime_halo_scene_trains_without_collapse: the halo scene
    (aabb_scale 32, bound 16) switches contraction on, and 200 steps of the
    ngp engine with occupancy and incremental maintenance bring the loss
    below 0.35 of its first value, on the same schedule of refreshes."""
    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.models.ngp import NGPConfig
    from nerf_kinematics_tpu_torch.ops.hashgrid import HashGridConfig
    from nerf_kinematics_tpu_torch.rendering.renderer import RenderSettings
    from nerf_kinematics_tpu_torch.train.config import Config, NeRFConfig, OptimizerConfig

    ds = make_synthetic_scene(n_views=9, resolution=32, variant="halo", device="cpu")
    assert ds.aabb_scale == 32.0
    cfg = Config(
        engine="ngp",
        ngp=NGPConfig(
            grid=HashGridConfig(n_levels=4, n_features=2, log2_table_size=12,
                                base_resolution=4, max_resolution=64),
            density_width=32, density_layers=2, color_width=32, color_layers=2,
            use_occupancy=True, occ_resolution=32, occ_update_every=50,
            occ_full_every=100, occ_incremental_cells=4096,
        ),
        nerf=NeRFConfig(
            train=RenderSettings(num_coarse=32, num_fine=32, perturb=True),
            validation=RenderSettings(num_coarse=32, num_fine=32, perturb=False),
            num_random_rays=512,
        ),
        optimizer=OptimizerConfig(lr=5e-3),
    )
    engine = NGPEngine(cfg, scene_bound=ds.aabb_scale / 2.0, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert engine.contracted and engine._inner == 4.0
    state = engine.init_state(0)
    step = engine.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    images, poses = torch.tensor(ds.images), torch.tensor(ds.poses)
    losses = []
    for i in range(1, 201):
        state, m = step(state, images, poses)
        losses.append(float(m["loss"]))
        if i % 50 == 0:
            state = engine.update_occupancy(state, full=(i == 50 or i == 100))
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.35 * losses[0], (losses[0], losses[-1])
