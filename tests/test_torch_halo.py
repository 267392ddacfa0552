"""The shipped ``configs/fox_ngp.yml`` recipe on the halo scene, the JAX
engine beside the port on the CPU: where both go. The witness for ROADMAP
C's all-black start of the CP encoder on this scene.

Tolerances: each 10-step window's mean loss within 10 % between the two
(each draws its own rays and depths, so the steps differ batch by batch;
a route that trains reads well under half the all-black loss by then, a
dark one within a few % of it), and within 10 % of the all-black loss.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

FOX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "fox_ngp.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fox_recipe_on_the_halo_scene_goes_dark_as_jax():
    """configs/fox_ngp.yml (cp_pallas through the fused module route, fox's
    widths: L 5, C 96, T 256, 64-wide MLPs, bf16 operands) on the halo scene
    at test size (25 views of 24x24), 256 rays x 64 samples, 30 steps from
    the same weights, the JAX engine (rows 3 and 6 in interpret mode) beside the port (their plain
    versions), each with its own draws. Both fall to the loss of an
    all-black prediction within ~20 steps and stay there, as the port does
    on the card at full size (ROADMAP C): each 10-step window's mean loss
    agrees within 10 %, and the last window of each lies within 10 % of the
    all-black loss."""
    from nerf_kinematics_tpu.data import make_synthetic_scene as jscene
    from nerf_kinematics_tpu.train.loop import build_shuffled_ray_buffer as jbuffer
    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.train.loop import build_shuffled_ray_buffer

    with open(FOX) as f:
        raw = tcfg.parse_yaml(f.read())
    raw["nerf"]["train"]["num_random_rays"] = 256
    steps, window = 30, 10
    jds = jscene(n_views=25, resolution=24, variant="halo")
    tds = make_synthetic_scene(n_views=25, resolution=24, variant="halo", device="cpu")
    bound = jds.aabb_scale / 2.0
    all_black = float((jds.images[jds.train_idx] ** 2).mean())

    je = JEngine(jcfg.config_from_dict(raw), scene_bound=bound)
    assert je.fused and je.contracted
    jstate = je.init_state(42)
    jimages = jnp.asarray(jds.images[jds.train_idx])
    jbuf = jbuffer(jimages, jnp.asarray(jds.poses[jds.train_idx]), jds.intrinsics, seed=42)
    jstep = je.make_train_step(jds.intrinsics, jds.near, jds.far, False, donate=False)
    jlosses = []
    for _ in range(steps):
        jstate, m = jstep(jstate, None, None, jbuf)
        jlosses.append(float(m["loss"]))

    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=bound, device="cpu")
    assert te.fused and te.contracted
    te.load_flax_params(jax.tree_util.tree_map(np.array, je.init_state(42).params["coarse"]))
    tstate = te.init_state(seed=42, keep_weights=True)
    tbuf = build_shuffled_ray_buffer(torch.as_tensor(tds.images[tds.train_idx]),
                                     torch.as_tensor(tds.poses[tds.train_idx]),
                                     tds.intrinsics, seed=42)
    tstep = te.make_train_step(tds.intrinsics, tds.near, tds.far, False)
    tlosses = []
    for _ in range(steps):
        tstate, m = tstep(tstate, None, None, tbuf)
        tlosses.append(float(m["loss"]))

    assert np.isfinite(jlosses).all() and np.isfinite(tlosses).all()
    jw = np.asarray(jlosses).reshape(-1, window).mean(axis=1)
    tw = np.asarray(tlosses).reshape(-1, window).mean(axis=1)
    np.testing.assert_allclose(tw, jw, rtol=0.1)
    np.testing.assert_allclose([jw[-1], tw[-1]], all_black, rtol=0.1)
