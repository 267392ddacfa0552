"""Occupancy parity: the hull lookup (the JAX package's Pallas kernel in
interpret mode and its XLA form) against the port -- exact equality -- and
the projections, the full-sweep update (jitter injected) and the hull
proposal sampling (positions injected) at atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.ops import occupancy as jo
from nerf_kinematics_tpu.ops.occupancy_pallas import occupancy_at_hull_pallas
from nerf_kinematics_tpu_torch.ops import occupancy as to
from nerf_kinematics_tpu_torch.ops.occupancy_cuda import (
    occupancy_at_hull_cuda, occupancy_at_hull_cuda_ref)

R = 16


def _grid(seed=0, bound=1.0):
    rng = np.random.default_rng(seed)
    d = rng.gamma(0.5, 4.0, (R, R, R)).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.6] = 0.01
    return d, bound


def _grids(seed=0, bound=1.0):
    d, b = _grid(seed, bound)
    return (jo.OccupancyGrid(jnp.asarray(d), jnp.float32(b)),
            to.OccupancyGrid(torch.tensor(d), torch.tensor(b, dtype=torch.float32)))


def test_pair_projections_equal():
    gj, gt = _grids()
    assert np.array_equal(to.pair_projections(gt).numpy(), np.asarray(jo.pair_projections(gj)))


def test_hull_lookup_equals_pallas_and_xla_exactly():
    gj, gt = _grids(1)
    rng = np.random.default_rng(2)
    xt = rng.uniform(-0.1, 1.1, (3, 2000)).astype(np.float32)
    xt[:, :4] = [[0, 1, 0.5, 0.99999994], [0, 1, 0.5, 0.0625], [0, 1, 0.5, 0.5]]
    pj, pt = jo.pair_projections(gj), to.pair_projections(gt)
    pallas = np.asarray(occupancy_at_hull_pallas(pj, jnp.asarray(xt), 512, True))
    got = occupancy_at_hull_cuda(pt, torch.tensor(xt)).numpy()
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, occupancy_at_hull_cuda_ref(pt, torch.tensor(xt)).numpy())
    # channels-last world-point form against the XLA form
    pts = (xt.T * 2.0 - 1.0).astype(np.float32).reshape(40, 50, 3)
    xla = np.asarray(jo.occupancy_at_hull(pj, jnp.asarray(pts), jo._linear_to_unit(gj)))
    mine = to.occupancy_at_hull(pt, torch.tensor(pts), to._linear_to_unit(gt)).numpy()
    assert mine.shape == (40, 50) and np.array_equal(mine, xla)
    # the values are bf16-rounded projections
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))


def _nonfinite_points():
    """Unit coordinates with a NaN in one or two coordinates (every choice of
    axes), +-inf in one or more, and finite points between them."""
    rng = np.random.default_rng(12)
    xt = rng.uniform(-0.1, 1.1, (3, 64)).astype(np.float32)
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    cases = [(0,), (1,), (2,), (0, 1), (0, 2), (1, 2)]
    for i, axes in enumerate(cases):
        xt[list(axes), 2 * i] = nan
    xt[0, 20], xt[1, 21], xt[2, 22] = inf, -inf, inf
    xt[:, 23] = [-inf, inf, -inf]
    xt[0, 24], xt[2, 24] = nan, inf
    xt[:, 25] = nan
    return xt


@pytest.mark.parametrize("seed", [1, 7])
def test_hull_lookup_nan_and_inf_points_match_the_reference(seed):
    """A NaN coordinate makes the reference's one-hot row all zero, so each
    pair projection that reads that axis contributes 0 to the minimum; +-inf
    clamp to the end cells. The port's plain version gives exactly that: the
    Pallas kernel in interpret mode and the XLA form, bit for bit."""
    gj, gt = _grids(seed)
    xt = _nonfinite_points()
    pj, pt = jo.pair_projections(gj), to.pair_projections(gt)
    pallas = np.asarray(occupancy_at_hull_pallas(pj, jnp.asarray(xt), 512, True))
    got = occupancy_at_hull_cuda_ref(pt, torch.tensor(xt)).numpy()
    assert np.isfinite(got).all()
    assert np.array_equal(got, pallas)
    assert np.array_equal(occupancy_at_hull_cuda(pt, torch.tensor(xt)).numpy(), pallas)
    pts = (xt.T * 2.0 - 1.0).astype(np.float32)
    xla = np.asarray(jo.occupancy_at_hull(pj, jnp.asarray(pts), jo._linear_to_unit(gj)))
    mine = to.occupancy_at_hull(pt, torch.tensor(pts), to._linear_to_unit(gt)).numpy()
    assert np.array_equal(mine, xla) and np.array_equal(mine, pallas)
    # the NaN points read 0 from a pair, so their minimum is at most 0
    assert (got[[0, 2, 4, 6, 8, 10, 24, 25]] <= 0.0).all()
    # +-inf: the end cells, as the clamped finite coordinates 1 and 0
    ends = xt[:, 20:24].copy()
    ends[np.isposinf(ends)], ends[np.isneginf(ends)] = 1.0, 0.0
    at_ends = occupancy_at_hull_cuda_ref(pt, torch.tensor(ends)).numpy()
    assert np.array_equal(got[20:24], at_ends)


@pytest.mark.parametrize("bound", [1.0, 1.5])
def test_update_grid_with_injected_jitter(bound, monkeypatch):
    gj, gt = _grids(3, bound)
    u = np.random.default_rng(4).uniform(size=(R**3, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, **kw: jnp.asarray(u).reshape(shape))

    nj = jo.update_grid(gj, lambda p: 30.0 * jnp.exp(-4.0 * (p * p).sum(-1)) + p[..., 0],
                        jax.random.PRNGKey(0), chunk=1024)
    nt = to.update_grid(gt, lambda p: 30.0 * torch.exp(-4.0 * (p * p).sum(-1)) + p[..., 0],
                        chunk=1000, u=torch.tensor(u))
    np.testing.assert_allclose(nt.density.numpy(), np.asarray(nj.density), rtol=1e-5, atol=1e-5)
    assert nt.density.shape == (R, R, R)
    # cell points follow the [x, y, z] layout
    pts = to._cell_points(gt, to._linear_from_unit(gt), u=torch.full((R**3, 3), 0.5))
    np.testing.assert_allclose(pts.reshape(R, R, R, 3)[3, 5, 7].numpy(),
                               ((np.array([3, 5, 7]) + 0.5) / R * 2 - 1) * bound, atol=1e-6)


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "jitter"])
def test_occupancy_sample_hull_with_injected_positions(deterministic, monkeypatch):
    gj, gt = _grids(5)
    rng = np.random.default_rng(6)
    n, S, bins = 96, 24, 32
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + np.array([0, 0, 3.0], np.float32)
    d = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32) + np.array([0, 0, -1.0], np.float32)
    u = rng.uniform(size=(n, S)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, **kw: jnp.asarray(u).reshape(shape))
    zj = jo.occupancy_sample(jax.random.PRNGKey(0), gj, jnp.asarray(o), jnp.asarray(d),
                             2.0, 4.5, S, num_bins=bins, deterministic=deterministic,
                             mode="hull", floor=1e-2)
    zt = to.occupancy_sample(gt, torch.tensor(o), torch.tensor(d), 2.0, 4.5, S,
                             num_bins=bins, deterministic=deterministic, mode="hull",
                             floor=1e-2, u=torch.tensor(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=1e-5)
    assert (np.diff(zt.numpy(), axis=-1) >= 0).all()  # sorted, no per-ray sort
    # proposal weights themselves
    edges = np.linspace(2.0, 4.5, bins + 1, dtype=np.float32)
    wj = jo.occupancy_proposal_hull(gj, jnp.asarray(o), jnp.asarray(d),
                                    jnp.broadcast_to(jnp.asarray(edges), (n, bins + 1)))
    wt = to.occupancy_proposal_hull(gt, torch.tensor(o), torch.tensor(d),
                                    torch.tensor(edges).expand(n, bins + 1))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-5)


def test_proposal_modes_and_init_grid():
    """An unknown proposal mode is refused (all three named modes run), and
    init_grid is the all-occupied grid."""
    _, gt = _grids()
    o = torch.zeros(2, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(2, 3)
    with pytest.raises(ValueError, match="unknown"):
        to.occupancy_sample(gt, o, o, 2.0, 6.0, 8, mode="nope")
    for mode in ("grid", "projected", "hull"):
        z = to.occupancy_sample(gt, o, d, 0.0, 0.9, 8, mode=mode, deterministic=True)
        assert z.shape == (2, 8) and torch.isfinite(z).all()
    g = to.init_grid(8, 2.0)
    assert g.resolution == 8 and float(g.bound) == 2.0 and float(g.density.min()) == 1.0


# ---------------------------------------------------------------- grid / projected

LOOKUPS = ("occupancy_at", "occupancy_at_nearest", "occupancy_at_projected")


def _lookup(mod, name, grid, pts):
    """One of the three point lookups through module ``mod`` (jo or to)."""
    if name == "occupancy_at_projected":
        return mod.occupancy_at_projected(mod.axis_projections(grid), pts,
                                          mod._linear_to_unit(grid))
    return getattr(mod, name)(grid, pts)


def _both(name, gj, gt, pts):
    want = np.asarray(_lookup(jo, name, gj, jnp.asarray(pts)))
    got = _lookup(to, name, gt, torch.tensor(pts)).numpy()
    assert got.shape == want.shape == pts.shape[:-1]
    return got, want


def test_axis_projections_equal():
    gj, gt = _grids(2)
    want = np.asarray(jo.axis_projections(gj))
    got = to.axis_projections(gt).numpy()
    assert got.shape == (R, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("bound", [1.0, 1.5])
@pytest.mark.parametrize("name", LOOKUPS)
def test_grid_lookups_match_jax(name, bound):
    """The three lookups at points inside, on the edges of and beyond the
    grid: nearest and projected bit for bit, trilinear within 1e-6."""
    gj, gt = _grids(8, bound)
    rng = np.random.default_rng(9)
    pts = (rng.uniform(-1.2, 1.2, (30, 40, 3)) * bound).astype(np.float32)
    edges = np.array([[-1, -1, -1], [1, 1, 1], [0, 0, 0], [1, -1, 0.5]], np.float32)
    pts[0, :4] = edges * bound
    got, want = _both(name, gj, gt, pts)
    if name == "occupancy_at":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert np.array_equal(got, want)
    if name == "occupancy_at_projected":
        # the bf16-rounded projections, as the reference's one-hot reads them
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))


@pytest.mark.parametrize("name", LOOKUPS)
def test_grid_lookups_nan_and_inf_points_match_jax(name):
    """Non-finite coordinates give what the JAX functions give on the CPU:
    trilinear NaN for a NaN coordinate; nearest takes cell 0 on a NaN axis
    (the int32 cast); projected reads 0 on a NaN axis (no one-hot row
    matches), so its minimum is 0; +-inf the end cells in all three."""
    gj, gt = _grids(11)
    xt = _nonfinite_points()
    pts = (xt.T * 2.0 - 1.0).astype(np.float32)
    got, want = _both(name, gj, gt, pts)
    assert np.array_equal(got, want, equal_nan=True)
    nan_rows = np.isnan(xt).any(axis=0)
    ends = xt.copy()
    ends[np.isposinf(ends)], ends[np.isneginf(ends)] = 1.0, 0.0
    finite = ~nan_rows
    at_ends = _lookup(to, name, gt, torch.tensor((ends.T * 2.0 - 1.0).astype(np.float32)))
    assert np.array_equal(got[finite], at_ends.numpy()[finite])
    if name == "occupancy_at":
        assert np.isnan(got[nan_rows]).all() and np.isfinite(got[finite]).all()
    elif name == "occupancy_at_nearest":
        zeroed = np.where(np.isnan(ends), 0.0, ends).astype(np.float32)
        at0 = _lookup(to, name, gt, torch.tensor((zeroed.T * 2.0 - 1.0).astype(np.float32)))
        assert np.array_equal(got, at0.numpy())
    else:
        assert (got[nan_rows] == 0.0).all()


@pytest.mark.parametrize("mode", ["grid", "projected"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "jitter"])
def test_occupancy_sample_grid_modes_with_injected_positions(mode, deterministic,
                                                             monkeypatch):
    gj, gt = _grids(5)
    rng = np.random.default_rng(6)
    n, S, bins = 96, 24, 32
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + np.array([0, 0, 3.0], np.float32)
    d = rng.uniform(-0.25, 0.25, (n, 3)).astype(np.float32) + np.array([0, 0, -1.0], np.float32)
    u = rng.uniform(size=(n, S)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, **kw: jnp.asarray(u).reshape(shape))
    zj = jo.occupancy_sample(jax.random.PRNGKey(0), gj, jnp.asarray(o), jnp.asarray(d),
                             2.0, 4.5, S, num_bins=bins, deterministic=deterministic,
                             mode=mode, floor=1e-2)
    zt = to.occupancy_sample(gt, torch.tensor(o), torch.tensor(d), 2.0, 4.5, S,
                             num_bins=bins, deterministic=deterministic, mode=mode,
                             floor=1e-2, u=torch.tensor(u))
    # the weights below are equal bit for bit; the inverse CDF of the grid's
    # steeper weights carries f32 rounding of the cumulative sum (5e-6 of z)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=1e-5)
    assert (np.diff(zt.numpy(), axis=-1) >= 0).all()
    edges = np.linspace(2.0, 4.5, bins + 1, dtype=np.float32)
    fn = {"grid": "occupancy_proposal", "projected": "occupancy_proposal_projected"}[mode]
    wj = getattr(jo, fn)(gj, jnp.asarray(o), jnp.asarray(d),
                         jnp.broadcast_to(jnp.asarray(edges), (n, bins + 1)))
    wt = getattr(to, fn)(gt, torch.tensor(o), torch.tensor(d),
                         torch.tensor(edges).expand(n, bins + 1))
    assert wt.shape == (n, bins) and np.array_equal(wt.numpy(), np.asarray(wj))


# The JAX package's tests/test_occupancy.py, on the port.

def _sphere_density(pts):
    r = torch.linalg.norm(pts, dim=-1)
    return torch.where(r < 0.4, 50.0, 0.0)


def test_trilinear_lookup_interpolates():
    grid = to.init_grid(resolution=8, bound=1.0)
    density = torch.zeros((8, 8, 8))
    density[3, 3, 3] = 8.0
    grid = grid._replace(density=density)
    center = (torch.tensor([[3.5, 3.5, 3.5]]) / 8 * 2 - 1) * 1.0
    np.testing.assert_allclose(to.occupancy_at(grid, center).numpy(), 8.0, rtol=1e-5)
    half = (torch.tensor([[4.0, 3.5, 3.5]]) / 8 * 2 - 1) * 1.0
    np.testing.assert_allclose(to.occupancy_at(grid, half).numpy(), 4.0, rtol=1e-5)


def test_proxy_lookups_bound_the_grid():
    """Both proxies are upper bounds of the nearest-cell lookup, and the
    visual hull is at least as tight as the axis projections."""
    rng = np.random.default_rng(3)
    grid = to.init_grid(resolution=16, bound=1.0)
    grid = grid._replace(density=torch.tensor(
        (rng.uniform(size=(16, 16, 16)) ** 4 * 10.0).astype(np.float32)))
    pts = torch.tensor(rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32))
    to_unit = to._linear_to_unit(grid)
    exact = to.occupancy_at_nearest(grid, pts).numpy()
    hull = to.occupancy_at_hull(to.pair_projections(grid), pts, to_unit).numpy()
    proj1d = to.occupancy_at_projected(to.axis_projections(grid), pts, to_unit).numpy()
    tol = 1e-2 * exact.max()
    assert (hull >= exact - tol).all()
    assert (proj1d >= hull - tol).all()
    assert hull.mean() < proj1d.mean()


def test_occupancy_sample_modes_agree_on_simple_field():
    grid = to.init_grid(resolution=32, bound=1.0)
    grid = to.update_grid(grid, _sphere_density, torch.Generator().manual_seed(0),
                          decay=0.0)
    n_rays = 64
    rays_o = torch.tensor([[0.0, 0.0, -2.0]]).repeat(n_rays, 1)
    rays_d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n_rays, 1)
    for mode in ("grid", "hull", "projected"):
        z = to.occupancy_sample(grid, rays_o, rays_d, 0.5, 3.5, 32, mode=mode,
                                generator=torch.Generator().manual_seed(1))
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        frac = float((torch.linalg.norm(pts, dim=-1) < 0.5).float().mean())
        assert frac > 0.55, (mode, frac)


@pytest.fixture
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("mode", ["grid", "projected"])
def test_train_step_with_grid_proposals_matches_jax(mode, monkeypatch, _one_torch_thread):
    """One fast-engine step (the two-call objective; f32 tables and weights)
    with ``occ_proposal: grid`` / ``projected`` against the JAX engine's,
    from the same weights, grid, window offset and jitter: the losses at
    rtol 1e-5, Adam's first moment (a tenth of the gradient) at rtol 1e-3
    where |g| > 2e-6; ``fused_train: full`` refuses both modes in both."""
    import test_torch_train_step as ts
    from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
    from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid as JGrid
    from nerf_kinematics_tpu.train import config as jcfg
    from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
    from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics
    from nerf_kinematics_tpu_torch.io import convert
    from nerf_kinematics_tpu_torch.train import config as tcfg
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    raw = ts._raw("on", "auto", True, 0.0, bf16=False)
    raw["ngp"]["occ_proposal"] = mode
    je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
    jstate = je.init_state(seed=9)
    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
    te.load_flax_params(jax.tree_util.tree_map(np.array, jstate.params["coarse"]))
    tstate = te.init_state(seed=9, keep_weights=True)
    dens = ts._grid()
    jstate = jstate._replace(aux=JGrid(jnp.asarray(dens), jnp.float32(1.0)))
    tstate.aux = convert.grid_from_numpy(dens, 1.0)
    ti = machina_intrinsics(16)
    jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy, width=16, height=16)
    draws = ts._draws()
    ts._patch_jax_draws(monkeypatch, draws)
    assert te.fused_objective_fn(ts.NEAR, ts.FAR, te.cfg.nerf.train) is not None

    jbuf = {k: jnp.asarray(v) for k, v in draws["ray_buf"].items()}
    jnew, jm = je.make_train_step(jintr, ts.NEAR, ts.FAR, False, donate=False)(
        jstate, None, None, jbuf)
    tbuf = {k: torch.tensor(v) for k, v in draws["ray_buf"].items()}
    tnew, tm = te.make_train_step(ti, ts.NEAR, ts.FAR, False)(
        tstate, None, None, tbuf, offset=draws["offset"],
        u_coarse=torch.tensor(draws["u_coarse"]), u_fine=torch.tensor(draws["u_fine"]))
    for k in ("loss", "loss_coarse", "loss_fine"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    layout = te.layout
    big = [np.asarray(l) for l in jax.tree_util.tree_leaves(jnew.opt_state)
           if np.size(l) == layout.total]
    mu_j = convert.flat_from_reference(big[0], layout).numpy()
    live = np.abs(mu_j) > 0.1 * 2e-6
    assert live.mean() > 0.2
    np.testing.assert_allclose(tnew.opt_state.mu.numpy()[live], mu_j[live],
                               rtol=1e-3, atol=1e-7)

    full = dict(raw, ngp=dict(raw["ngp"], fused_train="full"))
    with pytest.raises(ValueError, match="hull"):
        JEngine(jcfg.config_from_dict(full), scene_bound=1.0).fused_objective_fn(
            ts.NEAR, ts.FAR, je.cfg.nerf.train)
    with pytest.raises(ValueError, match="hull"):
        NGPEngine(tcfg.config_from_dict(full), scene_bound=1.0,
                  device="cpu").fused_objective_fn(ts.NEAR, ts.FAR, te.cfg.nerf.train)
