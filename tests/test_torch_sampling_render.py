"""Samplers, compositing, rays and SH: the JAX package against the port on
the same numpy inputs, random draws injected. atol 1e-5; depths (sampled
or composited, values of 2..6) atol 1e-5 + rtol 1e-5: the inverse CDF divides
by bin masses down to 1e-5, which magnifies the last-bit differences of two
cumulative sums."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.cameras import rays as jr
from nerf_kinematics_tpu.ops import sampling as js
from nerf_kinematics_tpu.ops import volume_render as jv
from nerf_kinematics_tpu.ops.sh import sh_encode as j_sh
from nerf_kinematics_tpu.rendering.fast_render import _blur_floor_pdf as j_blur
from nerf_kinematics_tpu_torch.cameras import rays as tr
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
from nerf_kinematics_tpu_torch.metrics.psnr import mse_to_psnr, psnr
from nerf_kinematics_tpu_torch.ops import sampling as ts
from nerf_kinematics_tpu_torch.ops import volume_render as tv
from nerf_kinematics_tpu_torch.ops.sh import sh_encode as t_sh
from nerf_kinematics_tpu_torch.rendering.fast_render import _blur_floor_pdf as t_blur
from nerf_kinematics_tpu_torch.rendering.fast_render import _window_range

ATOL = 1e-5


def _inject(monkeypatch, u):
    monkeypatch.setattr(
        jax.random, "uniform",
        lambda key, shape, **kw: jnp.asarray(u).reshape(shape))


@pytest.mark.parametrize("n", [1, 2, 64, 65, 192])
def test_linspace_matches_jnp(n):
    """Same blend formula as jnp.linspace: equal up to the last bit (XLA may
    fuse the multiply-add), end points exact."""
    for a, b in [(0.0, 1.0), (2.0, 6.0), (-1.0, 1.0)]:
        want = np.asarray(jnp.linspace(a, b, n, dtype=jnp.float32))
        got = ts.linspace(a, b, n).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=1e-7)
        assert got[0] == np.float32(a) and (n == 1 or got[-1] == np.float32(b))


@pytest.mark.parametrize("perturb", [True, False])
@pytest.mark.parametrize("lindisp", [True, False])
def test_stratified_sample(perturb, lindisp, monkeypatch):
    n, S = 33, 16
    u = np.random.default_rng(0).uniform(size=(n, S)).astype(np.float32)
    _inject(monkeypatch, u)
    zj = js.stratified_sample(jax.random.PRNGKey(0), n, S, 2.0, 6.0, perturb, lindisp)
    zt = ts.stratified_sample(n, S, 2.0, 6.0, perturb, lindisp, u=torch.tensor(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=ATOL)
    # per-ray bounds
    near = np.linspace(1.0, 2.0, n).astype(np.float32)
    zj = js.stratified_sample(jax.random.PRNGKey(0), n, S, jnp.asarray(near), 6.0, perturb, lindisp)
    zt = ts.stratified_sample(n, S, torch.tensor(near), 6.0, perturb, lindisp, u=torch.tensor(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["deterministic", "stratified_u", "iid"])
def test_sample_pdf_all_position_modes(mode, monkeypatch):
    rng = np.random.default_rng(1)
    n, M, S = 40, 20, 48
    bins = np.sort(rng.uniform(2.0, 6.0, (n, M + 1)).astype(np.float32), axis=-1)
    # Bin masses bounded below: inside a bin of (almost) no mass the inverse
    # CDF is ill-conditioned and the position of a sample there is arbitrary.
    w = (rng.gamma(0.3, 1.0, (n, M)) + 0.02).astype(np.float32)
    w[0] = 0.0          # an empty ray
    w[1, 3:] = 0.0      # mass in a few bins only
    u = rng.uniform(size=(n, S)).astype(np.float32)
    _inject(monkeypatch, u)
    kw = dict(deterministic=mode == "deterministic", stratified_u=mode == "stratified_u")
    zj = js.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins), jnp.asarray(w), S, **kw)
    zt = ts.sample_pdf(torch.tensor(bins), torch.tensor(w), S, u=torch.tensor(u), **kw)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=ATOL)
    assert zt.shape == (n, S)


def test_sample_pdf_from_a_generator_is_seeded():
    bins = torch.linspace(2, 6, 9).expand(5, 9)
    w = torch.ones(5, 8)
    a = ts.sample_pdf(bins, w, 16, stratified_u=True, generator=torch.Generator().manual_seed(3))
    b = ts.sample_pdf(bins, w, 16, stratified_u=True, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and (a >= 2).all() and (a <= 6).all()


@pytest.mark.parametrize("deterministic", [True, False])
def test_hierarchical_sample_fine_only(deterministic, monkeypatch):
    rng = np.random.default_rng(2)
    n, Sc, Sf = 30, 16, 24
    z = np.sort(rng.uniform(2.0, 6.0, (n, Sc)).astype(np.float32), axis=-1)
    w = (rng.gamma(0.5, 1.0, (n, Sc)) + 0.02).astype(np.float32)
    u = rng.uniform(size=(n, Sf)).astype(np.float32)
    _inject(monkeypatch, u)
    zj = js.hierarchical_sample(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(w), Sf,
                                deterministic=deterministic, merge=False)
    zt = ts.hierarchical_sample(torch.tensor(z), torch.tensor(w), Sf,
                                deterministic=deterministic, merge=False, u=torch.tensor(u))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-5, atol=ATOL)
    # merged form: sorted union of the right size
    zm = ts.hierarchical_sample(torch.tensor(z), torch.tensor(w), Sf, deterministic=True, merge=True)
    zmj = js.hierarchical_sample(jax.random.PRNGKey(0), jnp.asarray(z), jnp.asarray(w), Sf,
                                 deterministic=True, merge=True)
    np.testing.assert_allclose(zm.numpy(), np.asarray(zmj), rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("white", [True, False], ids=["white_bg", "black_bg"])
def test_raw2outputs_cf(white):
    rng = np.random.default_rng(3)
    R, S = 50, 24
    raw4 = rng.standard_normal((4, R * S)).astype(np.float32) * 2.0
    raw4[3] = np.exp(rng.uniform(-6, 5, R * S)).astype(np.float32)  # activated sigma
    raw4[3, : 3 * S] = 0.0  # empty rays
    z = np.sort(rng.uniform(2.0, 6.0, (R, S)).astype(np.float32), axis=-1)
    d = rng.standard_normal((R, 3)).astype(np.float32)
    oj = jv.raw2outputs_cf(jnp.asarray(raw4), jnp.asarray(z), jnp.asarray(d), white_background=white)
    ot = tv.raw2outputs_cf(torch.tensor(raw4), torch.tensor(z), torch.tensor(d), white_background=white)
    for name in ("rgb", "acc", "weights"):
        np.testing.assert_allclose(getattr(ot, name).numpy(), np.asarray(getattr(oj, name)),
                                   rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(ot.depth.numpy(), np.asarray(oj.depth), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(ot.disp.numpy(), np.asarray(oj.disp), rtol=1e-4, atol=ATOL)
    # injected noise is added after the activation
    noise = rng.standard_normal((R, S)).astype(np.float32)
    on = tv.raw2outputs_cf(torch.tensor(raw4), torch.tensor(z), torch.tensor(d),
                           noise_std=0.5, noise=torch.tensor(noise))
    assert not torch.equal(on.acc, ot.acc)
    with pytest.raises(ValueError):
        tv.raw2outputs_cf(torch.tensor(raw4), torch.tensor(z), torch.tensor(d), noise_std=0.5)


@pytest.mark.parametrize("dist", [None, (0.1, -0.05, 0.01, -0.02)], ids=["pinhole", "distorted"])
def test_get_rays(dist):
    c2w = orbit_poses(3)[1]
    intr = machina_intrinsics(16)
    oj, dj = jr.get_rays(12, 16, intr.fl_x, jnp.asarray(c2w), cx=7.5, cy=6.25,
                         focal_y=intr.fl_x * 1.1, dist=dist)
    ot, dt = tr.get_rays(12, 16, intr.fl_x, torch.tensor(c2w), cx=7.5, cy=6.25,
                         focal_y=intr.fl_x * 1.1, dist=dist)
    assert ot.shape == dt.shape == (12, 16, 3)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL)
    # defaults: principal point at the image center
    oj, dj = jr.get_rays(8, 8, 10.0, jnp.asarray(c2w))
    ot, dt = tr.get_rays(8, 8, 10.0, c2w)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode(degree):
    v = np.random.default_rng(4).standard_normal((7, 9, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    got = t_sh(torch.tensor(v), degree).numpy()
    assert got.shape == (7, 9, degree**2)
    np.testing.assert_allclose(got, np.asarray(j_sh(jnp.asarray(v), degree)), rtol=0, atol=ATOL)
    with pytest.raises(ValueError):
        t_sh(torch.tensor(v), 5)


def test_orbit_poses_and_intrinsics_match():
    from nerf_kinematics_tpu.data import machina as jm

    for n in (4, 8):
        assert np.array_equal(orbit_poses(n), jm.orbit_poses(n))
    assert np.array_equal(orbit_poses(5, elev_deg=20.0), jm.orbit_poses(5, elev_deg=20.0))
    intr = machina_intrinsics(400)
    assert intr.fl_x == 0.5 * 400 / np.tan(0.5 * jm.CAMERA_ANGLE_X)
    assert intr.scaled(4).width == 100 and intr.distortion is None


@pytest.mark.parametrize("blur,floor", [(True, 0.01), (False, 0.0), (True, 0.0)])
def test_blur_floor_pdf(blur, floor):
    w = np.random.default_rng(5).gamma(0.5, 1.0, (20, 16)).astype(np.float32)
    np.testing.assert_allclose(t_blur(torch.tensor(w), blur, floor).numpy(),
                               np.asarray(j_blur(jnp.asarray(w), blur, floor)), rtol=0, atol=1e-6)


def test_window_range_matches_reduce_window():
    img = np.random.default_rng(6).uniform(size=(7, 9, 3)).astype(np.float32)
    x = jnp.asarray(img)
    mx = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (3, 3, 1), (1, 1, 1), "SAME")
    mn = jax.lax.reduce_window(x, jnp.inf, jax.lax.min, (3, 3, 1), (1, 1, 1), "SAME")
    want = np.asarray((mx - mn).max(-1))
    assert np.array_equal(_window_range(torch.tensor(img)).numpy(), want)


def test_psnr():
    import importlib

    jp = importlib.import_module("nerf_kinematics_tpu.metrics.psnr")

    a = np.random.default_rng(7).uniform(size=(5, 5, 3))
    b = np.clip(a + 0.01, 0, 1)
    assert psnr(a, b) == pytest.approx(jp.psnr(a, b))
    assert psnr(torch.tensor(a), torch.tensor(a)) == float("inf")
    assert float(mse_to_psnr(1e-3)) == pytest.approx(float(jp.mse_to_psnr(1e-3)), rel=1e-6)
    with pytest.raises(ValueError):
        psnr(a, a[:2])
