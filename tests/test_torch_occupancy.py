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


def test_unported_modes_say_so():
    _, gt = _grids()
    o = torch.zeros(2, 3)
    with pytest.raises(NotImplementedError, match="not ported"):
        to.occupancy_sample(gt, o, o, 2.0, 6.0, 8, mode="grid")
    with pytest.raises(ValueError, match="unknown"):
        to.occupancy_sample(gt, o, o, 2.0, 6.0, 8, mode="nope")
    g = to.init_grid(8, 2.0)
    assert g.resolution == 8 and float(g.bound) == 2.0 and float(g.density.min()) == 1.0
