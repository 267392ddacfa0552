"""Pose refinement in the port (``poses/refine.py``) on the CPU: the
counterparts of ``tests/test_pose_refine.py``, then ``se3_exp``, the
differentiable replica and one step of ``refine_pose`` / ``refine_poses``
against the JAX package's from the same weights and draws.

Tolerances. The port's own checks keep ``tests/test_pose_refine.py``'s
(1e-7 / 1e-6 on the exponential, rtol 2e-4 / atol 2e-5 replica against
model, image MSE halved, pose error reduced). Against the JAX package:
``se3_exp`` 1e-7 absolute and its gradient rtol 1e-5 / atol 1e-6 (f32,
a few ulps of entries near 1); ``ngp_apply_diff``
rgb and sigma rtol 1e-5 / atol 1e-6, its point gradient rtol 1e-4 / atol
1e-6 (f32 sums in another order); the photometric loss rtol 1e-5 and its
delta gradient rtol 1e-3 / atol 1e-7; the first Adam step moves each delta
entry by lr * g / (|g| + 1e-8), so where |g| > 2e-6 both packages move by
lr * sign(g) to 0.5 % of lr (1e-8 / 2e-6) and agree to 1e-8 (ROADMAP's
parity rules), and by at most 2 lr elsewhere; the refined pose 3 lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.poses import refine as jref
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
from nerf_kinematics_tpu_torch.poses.refine import (
    apply_delta,
    frozen_params,
    make_photometric_loss,
    ngp_apply_diff,
    refine_pose,
    refine_poses,
    se3_exp,
)
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

D_TRUE = np.array([0.03, -0.02, 0.025, 0.03, -0.02, 0.02], np.float32)
OCC, BOUND = 16, 1.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(use_occ=False):
    """tests/test_pose_refine.py's tiny configuration."""
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "fused": "on", "use_occupancy": use_occ,
            "occ_resolution": OCC,
            "cp": {"n_levels": 2, "n_components": 16, "base_resolution": 8,
                   "max_resolution": 64, "table_size": 32, "use_bf16": False},
            "density_width": 16, "density_layers": 2, "color_width": 16,
            "color_layers": 2, "compute_dtype": "float32",
        },
        "nerf": {
            "train": {"num_coarse": 12, "num_fine": 0, "perturb": True,
                      "num_random_rays": 256},
            "validation": {"num_coarse": 12, "num_fine": 0, "perturb": False},
        },
    }


def _engine(use_occ=False):
    return NGPEngine(tcfg.config_from_dict(_raw(use_occ)), scene_bound=BOUND, device="cpu",
                     generator=torch.Generator().manual_seed(1))


class _Pair:
    """The JAX engine's ``init_state(0)`` and the port's engine with its
    weights; with occupancy, both grids set to the same random densities."""

    def __init__(self, use_occ=True):
        self.je = JEngine(jcfg.config_from_dict(_raw(use_occ)), scene_bound=BOUND)
        self.jstate = self.je.init_state(0)
        self.te = NGPEngine(tcfg.config_from_dict(_raw(use_occ)), scene_bound=BOUND,
                            device="cpu")
        self.te.load_flax_params(jax.tree_util.tree_map(
            np.array, self.jstate.params["coarse"]))
        self.tparams = self.te.init_state(keep_weights=True).params
        self.jaux = self.taux = None
        if use_occ:
            dens = np.random.default_rng(2).gamma(0.5, 4.0, (OCC, OCC, OCC)).astype(np.float32)
            self.jaux = self.jstate.aux._replace(density=jnp.asarray(dens))
            self.taux = grid_from_numpy(dens, BOUND)


def _view(n_views=3, size=12):
    ds = make_synthetic_scene(n_views=n_views, resolution=size, device="cpu")
    return ds


# ---------------------------------------- counterparts of test_pose_refine.py

def test_se3_exp_identity_and_inverse():
    np.testing.assert_allclose(se3_exp(torch.zeros(6)).numpy(), np.eye(4), atol=1e-7)
    d = torch.tensor([0.1, -0.05, 0.2, 0.3, 0.0, -0.1])
    T, Tinv = se3_exp(d).numpy(), se3_exp(-d).numpy()
    np.testing.assert_allclose(T @ Tinv, np.eye(4), atol=1e-6)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-6)


def test_diff_replica_matches_model():
    eng = _engine()
    g = torch.Generator().manual_seed(0)
    x = torch.rand(33, 3, generator=g)
    vd = torch.randn(33, 3, generator=g)
    vd = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
    with torch.no_grad():
        rgb_m, sig_m = eng.model(x, vd)
    params = frozen_params(eng, eng.init_state(keep_weights=True).params)
    rgb_d, sig_d = ngp_apply_diff(params, eng.ngp_config, x, vd)
    np.testing.assert_allclose(rgb_d.detach().numpy(), rgb_m.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sig_d.detach().numpy(), sig_m.numpy(), rtol=2e-4, atol=2e-5)
    # position gradients exist and are finite (the whole point)
    xg = x.clone().requires_grad_(True)
    (gx,) = torch.autograd.grad(ngp_apply_diff(params, eng.ngp_config, xg, vd)[1].sum(), xg)
    assert torch.isfinite(gx).all() and gx.abs().max() > 0.0


def test_photometric_refinement_recovers_perturbed_pose():
    """Train a tiny field, render GT at a view's pose, perturb the pose and
    recover it photometrically: the image error halves, the pose error
    shrinks."""
    ds = make_synthetic_scene(n_views=8, resolution=24, device="cpu")
    eng = _engine()
    images, poses = torch.tensor(ds.images), torch.tensor(ds.poses)
    step = eng.make_train_step(ds.intrinsics, ds.near, ds.far, ds.use_ndc)
    state = eng.init_state(0)
    for _ in range(150):
        state, _ = step(state, images, poses)
    render = eng.make_render_fn(ds.intrinsics, ds.near, ds.far, ds.use_ndc)

    def img(c2w):
        with torch.no_grad(), eng.bound(state.params):
            return render(c2w, state.aux)["rgb"].numpy()

    pose0 = poses[0]
    gt = img(pose0)
    pose_bad = apply_delta(pose0, torch.tensor(D_TRUE))
    mse_bad = float(np.mean((img(pose_bad) - gt) ** 2))
    refined, delta, losses = refine_pose(
        eng, state.params, state.aux, gt, pose_bad, ds.intrinsics, ds.near, ds.far,
        n_iters=40, n_rays=24 * 24, n_samples=12, lr=5e-3, white_background=False)
    assert len(losses) == 40 and delta.shape == (6,)
    mse_ref = float(np.mean((img(refined) - gt) ** 2))
    assert mse_ref < 0.5 * mse_bad, (mse_bad, mse_ref)
    err_bad = float((pose_bad - pose0).abs().max())
    err_ref = float((refined - pose0).abs().max())
    assert err_ref < err_bad, (err_bad, err_ref)


# ---------------------------------------------------- against the JAX package

@pytest.mark.parametrize("at", ["zero", "d_true", "small"])
def test_se3_exp_and_its_gradient_match_jax(at):
    d = {"zero": np.zeros(6, np.float32), "d_true": D_TRUE,
         "small": np.array([3e-5, -2e-5, 1e-5, 0.1, 0.2, -0.3], np.float32)}[at]
    w = np.random.default_rng(1).normal(size=(4, 4)).astype(np.float32)
    want = np.asarray(jref.se3_exp(jnp.asarray(d)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jref.se3_exp(x) * w))(jnp.asarray(d)))
    dt = torch.tensor(d, requires_grad=True)
    got = se3_exp(dt)
    (grad,) = torch.autograd.grad((got * torch.tensor(w)).sum(), dt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(grad.numpy(), gwant, rtol=1e-5, atol=1e-6)
    assert np.isfinite(grad.numpy()).all()


def test_ngp_apply_diff_and_point_gradient_match_jax():
    pr = _Pair(use_occ=False)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(5, 7, 3)).astype(np.float32)
    vd = rng.normal(size=(5, 7, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    w = rng.normal(size=(5, 7, 3)).astype(np.float32)
    jp = pr.jstate.params["coarse"]

    def jf(xx):
        rgb, sig = jref.ngp_apply_diff(jp, pr.je.ngp_config, xx, jnp.asarray(vd))
        return jnp.sum(rgb * w) + jnp.sum(sig), (rgb, sig)

    (_, (jrgb, jsig)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    trgb, tsig = ngp_apply_diff(frozen_params(pr.te, pr.tparams), pr.te.ngp_config, xt, torch.tensor(vd))
    (tg,) = torch.autograd.grad((trgb * torch.tensor(w)).sum() + tsig.sum(), xt)
    np.testing.assert_allclose(trgb.detach().numpy(), np.asarray(jrgb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsig.detach().numpy(), np.asarray(jsig), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)
    assert np.abs(np.asarray(jg)).max() > 1e-3


def _jax_pixels(seed, n_rays, H, W, n_images=None):
    """The pixel indices (and image) JAX's first iteration draws."""
    key = jax.random.PRNGKey(seed)
    _, sub = jax.random.split(key)
    if n_images is None:
        k_px, _ = jax.random.split(sub)
        return np.asarray(jax.random.randint(k_px, (n_rays,), 0, H * W)), None
    k_img, k_px, _ = jax.random.split(sub, 3)
    i = int(jax.random.randint(k_img, (), 0, n_images))
    return np.asarray(jax.random.randint(k_px, (n_rays,), 0, H * W)), i


def _assert_first_adam_step(got, want, g, lr):
    sure = np.abs(g) > 2e-6
    assert sure.sum() >= 3
    np.testing.assert_allclose(got[sure], want[sure], rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.abs(want[sure]), lr, rtol=5e-3)
    assert np.abs(got - want).max() <= 2 * lr + 1e-9


@pytest.mark.parametrize("use_occ", [True, False], ids=["hull", "uniform"])
def test_refine_pose_step_in_lockstep_with_jax(use_occ):
    """The photometric loss and its gradient at a perturbed pose, then one
    ``refine_pose`` iteration, with JAX's pixel draws passed to the port
    (the proposal is deterministic: ``perturb`` off)."""
    pr = _Pair(use_occ)
    ds = _view()
    H, W = ds.intrinsics.height, ds.intrinsics.width
    image, c2w = ds.images[0][..., :3], ds.poses[0].astype(np.float32)
    near, far = ds.near, ds.far
    kw = dict(n_samples=12, n_rays=64, white_background=False)
    seed, lr = 3, 1e-3
    px, _ = _jax_pixels(seed, 64, H, W)
    delta0 = (0.5 * D_TRUE).astype(np.float32)

    jloss = jref.make_photometric_loss(pr.je, pr.jstate.params, pr.jaux, image,
                                       ds.intrinsics, near, far, **kw)
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(delta0), jnp.asarray(c2w), sub)
    tloss = make_photometric_loss(pr.te, pr.tparams, pr.taux, image, ds.intrinsics, near, far, **kw)
    dt = torch.tensor(delta0, requires_grad=True)
    tl = tloss(dt, torch.tensor(c2w), px=torch.tensor(px))
    (tg,) = torch.autograd.grad(tl, dt)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-7)

    jc2w, jdelta, jlosses = jref.refine_pose(pr.je, pr.jstate.params, pr.jaux, image, c2w,
                                             ds.intrinsics, near, far, n_iters=1, lr=lr,
                                             seed=seed, delta0=delta0, **kw)
    tc2w, tdelta, tlosses = refine_pose(pr.te, pr.tparams, pr.taux, image, c2w, ds.intrinsics,
                                        near, far, n_iters=1, lr=lr, delta0=delta0,
                                        px=torch.tensor(px)[None], **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _assert_first_adam_step(tdelta.numpy() - delta0, np.asarray(jdelta) - delta0,
                            np.asarray(jg), lr)
    np.testing.assert_allclose(tc2w.numpy(), np.asarray(jc2w), rtol=0, atol=3 * lr)


def test_refine_poses_step_in_lockstep_with_jax():
    """One ``refine_poses`` iteration over three train poses with JAX's
    image and pixel draws passed in: only the drawn image's delta moves,
    by the same first Adam step."""
    pr = _Pair(use_occ=True)
    ds = _view(n_views=3)
    H, W = ds.intrinsics.height, ds.intrinsics.width
    images, c2ws = ds.images[..., :3], ds.poses.astype(np.float32)
    seed, lr = 5, 1e-3
    kw = dict(n_samples=12, n_rays=48, white_background=False, lr=lr)
    px, i = _jax_pixels(seed, 48, H, W, n_images=3)
    jref_c2w, jdeltas = jref.refine_poses(pr.je, pr.jstate.params, pr.jaux, images, c2ws,
                                          ds.intrinsics, ds.near, ds.far, n_iters=1,
                                          seed=seed, **kw)
    tref_c2w, tdeltas = refine_poses(pr.te, pr.tparams, pr.taux, images, c2ws, ds.intrinsics,
                                     ds.near, ds.far, n_iters=1, idx=torch.tensor([i]),
                                     px=torch.tensor(px)[None], **kw)
    jdeltas, tdeltas = np.asarray(jdeltas), tdeltas.numpy()
    others = [k for k in range(3) if k != i]
    assert np.abs(jdeltas[others]).max() == 0.0 and np.abs(tdeltas[others]).max() == 0.0
    # the drawn image's gradient, from the loss the port builds for it
    tloss = make_photometric_loss(pr.te, pr.tparams, pr.taux, images[i], ds.intrinsics,
                                  ds.near, ds.far, n_samples=12, n_rays=48,
                                  white_background=False)
    dt = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad(tloss(dt, torch.tensor(c2ws[i]), px=torch.tensor(px)), dt)
    _assert_first_adam_step(tdeltas[i], jdeltas[i], g.numpy(), lr)
    np.testing.assert_allclose(tref_c2w.numpy(), np.asarray(jref_c2w), rtol=0, atol=3 * lr)


def test_refine_poses_draws_from_its_generator():
    """Without draws passed in, the port draws from a generator seeded with
    ``seed``: two runs agree, another seed differs, and the loss falls."""
    eng = _engine(use_occ=True)
    eng_aux = eng.init_aux()
    params = eng.init_state(keep_weights=True).params
    ds = _view(n_views=3)
    images, c2ws = ds.images[..., :3], ds.poses.astype(np.float32)
    kw = dict(n_iters=3, n_rays=32, n_samples=12, white_background=False, lr=1e-3)
    a = refine_poses(eng, params, eng_aux, images, c2ws, ds.intrinsics, ds.near, ds.far,
                     seed=1, **kw)[1]
    b = refine_poses(eng, params, eng_aux, images, c2ws, ds.intrinsics, ds.near, ds.far,
                     seed=1, **kw)[1]
    c = refine_poses(eng, params, eng_aux, images, c2ws, ds.intrinsics, ds.near, ds.far,
                     seed=2, **kw)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() > 0
