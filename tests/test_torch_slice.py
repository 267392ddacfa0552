"""The serving slice as a whole (training: tests/test_torch_train_step.py): the same random-init flax parameters and a
hand-made occupancy grid go through ``NGPEngine`` of the JAX package (Pallas
kernels in interpret mode) and of the port (plain versions on the CPU) --
fast render with and without foreground compaction, the standard evaluation
render, the full occupancy sweep (jitter injected) and the density grid, at
16x16.

Tolerances: images max abs 5e-3 in bf16 mode (a flipped bf16 rounding of a
hidden activation moves one sample's color), 1e-4 in f32 mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid as JGrid
from nerf_kinematics_tpu.rendering.fast_render import FastRenderSettings as JFast
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
from nerf_kinematics_tpu_torch.rendering.fast_render import FastRenderSettings
from nerf_kinematics_tpu_torch.rendering.renderer import RenderSettings
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

SIZE, OCC = 16, 16


def _raw(bf16: bool) -> dict:
    return {
        "engine": "ngp",
        "ngp": {
            "encoder": "cp_pallas", "n_levels": 3, "n_components": 8,
            "table_size": 32, "base_resolution": 8, "max_resolution": 128,
            "cp": {"use_bf16": bf16},
            "density_width": 32, "density_out": 16, "color_width": 32,
            "color_layers": 3, "use_occupancy": True, "occ_resolution": OCC,
            "occ_bins": 32,
            "compute_dtype": "bfloat16" if bf16 else "float32",
        },
        "dataset": {"near": 2.0, "far": 6.0},
        "nerf": {
            "train": {"num_coarse": 16, "num_fine": 16, "white_background": True},
            "validation": {"num_coarse": 16, "num_fine": 24, "perturb": False,
                           "white_background": True},
        },
    }


class _Slice:
    """Both engines on the same weights and grid."""

    def __init__(self, bf16: bool):
        raw = _raw(bf16)
        self.bf16 = bf16
        self.je = JEngine(jcfg.config_from_dict(raw), scene_bound=1.0)
        state = self.je.init_state(seed=9)
        tree = jax.tree_util.tree_map(np.array, state.params["coarse"])
        # a denser, more colorful field than a fresh init gives
        rng = np.random.default_rng(10)
        p = tree["params"]
        p["density_out"]["bias"][0] = 2.5
        p["density_out"]["kernel"][:, 0] *= 6.0
        p["color_out"]["kernel"] *= 4.0
        p["cp_lines"] += (0.4 * rng.standard_normal(p["cp_lines"].shape)).astype(np.float32)
        self.jparams = {"coarse": jax.tree_util.tree_map(jnp.asarray, tree)}
        self.te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=1.0, device="cpu")
        self.te.load_flax_params(tree)
        # hand-made grid: an occupied ball in a nearly empty box
        lin = (np.arange(OCC) + 0.5) / OCC * 2 - 1
        xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
        r = np.sqrt(xs**2 + 1.3 * ys**2 + 0.8 * zs**2)
        dens = np.where(r < 0.7, 20.0 * (1.0 - r), 0.02).astype(np.float32)
        self.jaux = JGrid(jnp.asarray(dens), jnp.float32(1.0))
        self.taux = grid_from_numpy(dens, 1.0)
        ti = machina_intrinsics(SIZE)
        self.tintr = ti
        self.jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                                 width=SIZE, height=SIZE)
        self.pose = orbit_poses(5)[2]
        self.tol = 5e-3 if bf16 else 1e-4
        self.state = state

    def check(self, out_j, out_t):
        for k in ("rgb", "acc"):
            a, b = out_t[k].numpy(), np.asarray(out_j[k])
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= self.tol, (k, np.abs(a - b).max())
        np.testing.assert_allclose(out_t["depth"].numpy(), np.asarray(out_j["depth"]),
                                   rtol=2e-3, atol=self.tol)
        # the scene is neither empty nor full, so the comparison means something
        acc = out_t["acc"].numpy()
        assert acc.max() > 0.9 and out_t["rgb"].numpy().std() > 0.02


@pytest.fixture(scope="module", params=[True, False], ids=["bf16", "f32"])
def sl(request):
    return _Slice(request.param)


@pytest.mark.parametrize("fg_fraction", [1.0, 0.5], ids=["all_blocks", "fg_half"])
def test_fast_render_matches(sl, fg_fraction):
    kw = dict(num_coarse=16, num_fine=24, fg_fraction=fg_fraction, white_background=True)
    fj = sl.je.make_fast_render_fn(sl.jintr, 2.0, 6.0, False, settings=JFast(**kw))
    ft = sl.te.make_fast_render_fn(sl.tintr, 2.0, 6.0, False, settings=FastRenderSettings(**kw))
    out_t = ft(sl.pose, sl.taux)
    assert out_t["rgb"].shape == (SIZE, SIZE, 3)
    sl.check(fj(sl.jparams, jnp.asarray(sl.pose), sl.jaux), out_t)


def test_fast_render_default_settings_and_batch(sl):
    fj = sl.je.make_fast_render_fn(sl.jintr, 2.0, 6.0, False)
    fb = sl.te.make_fast_render_batch(sl.tintr, 2.0, 6.0, False)
    poses = np.stack([sl.pose, orbit_poses(5)[0]])
    out_t = fb(torch.tensor(poses), sl.taux)
    assert out_t["rgb"].shape == (2, SIZE, SIZE, 3)
    for i in range(2):
        sl.check(fj(sl.jparams, jnp.asarray(poses[i]), sl.jaux),
                 {k: v[i] for k, v in out_t.items()})


def test_eval_render_matches_and_ignores_the_chunk(sl):
    rj = sl.je.make_render_fn(sl.jintr, 2.0, 6.0, False)
    rt = sl.te.make_render_fn(sl.tintr, 2.0, 6.0, False)
    out_t = rt(sl.pose, sl.taux)
    sl.check(rj(sl.jparams, jnp.asarray(sl.pose), sl.jaux), out_t)
    # another chunk size (with a padded tail) renders the same image
    out_c = sl.te.make_render_fn(sl.tintr, 2.0, 6.0, False, chunk_rays=100)(sl.pose, sl.taux)
    np.testing.assert_allclose(out_c["rgb"].numpy(), out_t["rgb"].numpy(), rtol=0, atol=1e-5)
    # without a grid the coarse pass is stratified
    out_n = rt(sl.pose, None)
    out_nj = rj(sl.jparams, jnp.asarray(sl.pose), None)
    sl.check(out_nj, out_n)


def test_occupancy_sweep_matches(sl, monkeypatch):
    u = np.random.default_rng(12).uniform(size=(OCC**3, 3)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, **kw: jnp.asarray(u).reshape(shape))
    start = sl.je.init_state(seed=9)._replace(params=sl.jparams)
    new_j = np.asarray(sl.je.update_occupancy(start, full=True).aux.density)
    new_t = sl.te.update_occupancy(sl.te.init_aux(), full=True, u=torch.tensor(u)).density.numpy()
    assert new_t.shape == (OCC,) * 3
    # sigma = exp(z0) of a module whose bf16 layers round their outputs
    rtol = 2e-2 if sl.bf16 else 1e-4
    np.testing.assert_allclose(new_t, new_j, rtol=rtol, atol=1e-5)
    # max(decay * old, new) from an all-ones grid
    assert (new_t > 1.0).any() and (new_t >= 0.95 - 1e-6).all()


def test_density_grid_matches(sl):
    gj = np.asarray(sl.je.density_grid(sl.jparams, resolution=16))
    gt = sl.te.density_grid(resolution=16).numpy()
    assert gt.shape == (16, 16, 16)
    rtol = 2e-2 if sl.bf16 else 1e-4
    np.testing.assert_allclose(gt, gj, rtol=rtol, atol=1e-5)


def test_training_entry_points_wait(sl):
    """The training entry points exist now; what still waits for a later
    slice says so and names its place in the queue."""
    state = sl.te.init_state(seed=1, keep_weights=True)
    assert int(state.step) == 0 and state.params.numel() == sl.te.layout.total
    for make in (sl.te.make_train_step, sl.te.make_train_many):
        assert callable(make(sl.tintr, 2.0, 6.0, False))
    assert callable(sl.te.fused_objective_fn(2.0, 6.0, sl.te.cfg.nerf.train))
    new = sl.te.update_occupancy(sl.taux, full=False,
                                 generator=torch.Generator().manual_seed(0))
    assert new.density.shape == sl.taux.density.shape
    import dataclasses
    full = dataclasses.replace(sl.te.ngp_config, fused_train="full")
    with pytest.raises(NotImplementedError, match="row 8"):
        NGPEngine(sl.te.cfg.replace(ngp=full), device="cpu").fused_objective_fn(
            2.0, 6.0, sl.te.cfg.nerf.train)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NGPEngine(sl.te.cfg, scene_bound=4.0, device="cpu")  # contracted scene
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hashed = dataclasses.replace(sl.te.ngp_config, encoder="hash")
        NGPEngine(sl.te.cfg.replace(ngp=hashed), device="cpu")
    with pytest.raises(NotImplementedError, match="NDC"):
        sl.te.make_train_step(sl.tintr, 2.0, 6.0, True)
    assert sl.te.fused and sl.te.resolved_coarse_loss_weight() == 0.0
    coarse, fine = sl.te.cf_apply_fns()
    assert coarse == sl.te.apply_sigma_cf and fine == sl.te.apply_cf
    rgb, sigma = sl.te.apply_coarse(torch.zeros(2, 5, 3), None)
    assert rgb.shape == (2, 5, 3) and sigma.shape == (2, 5)
    assert isinstance(sl.te.cfg.nerf.validation, RenderSettings)
    assert sl.te.cfg.nerf.validation.merge_hierarchical is False
