"""The port's robot loader (``dataset.type: robot``) against the JAX
package's, on captures these tests write (tests/test_torch_poses.py::
write_capture): the robot cases of tests/test_data.py, which skip here
without the real wheel capture. Also the FK capture writer of
chip_smoke.py's ``robot`` phase (the loader returns its rendered poses up
to one similarity), the two wheel configs through ``Trainer`` on the CPU,
and rays with fl_x != fl_y on a non-square image.

Tolerances: images exactly equal (the port's PNG codec and LANCZOS equal
Pillow's on uint8; JPEG decodes through Pillow in both); poses, intrinsics
and render poses 1e-6 (f32 casts of the same float64 numpy arithmetic, the
orbit through torch); the writer's poses 1e-5; rays 1e-6."""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.cameras import rays as jrays
from nerf_kinematics_tpu.data import load_dataset as jload_dataset
from nerf_kinematics_tpu.data.robot import load_robot as jload_robot
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu_torch.cameras import rays as trays
from nerf_kinematics_tpu_torch.data import load_dataset
from nerf_kinematics_tpu_torch.data.robot import load_robot
from nerf_kinematics_tpu_torch.train import config as tcfg
from nerf_kinematics_tpu_torch.train.trainer import Trainer
from test_torch_poses import ring_poses, slide_poses, write_capture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dataset_cfgs(basedir, **kw):
    raw = {"dataset": {"type": "robot", "basedir": str(basedir), "near": 0.0, "far": 1.0,
                       "llffhold": 8, "no_ndc": False, **kw}}
    return tcfg.config_from_dict(raw).dataset, jcfg.config_from_dict(raw).dataset


def _same(got, want) -> None:
    assert np.array_equal(got.images, want.images)
    assert got.images.dtype == np.float32 and got.poses.dtype == np.float32
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=1e-6)
    gi, wi = got.intrinsics, want.intrinsics
    np.testing.assert_allclose(
        [gi.fl_x, gi.fl_y, gi.cx, gi.cy, gi.width, gi.height],
        [wi.fl_x, wi.fl_y, wi.cx, wi.cy, wi.width, wi.height], rtol=1e-6)
    assert np.array_equal(got.train_idx, want.train_idx)
    assert np.array_equal(got.val_idx, want.val_idx)
    np.testing.assert_allclose(got.render_poses, want.render_poses, rtol=0, atol=1e-6)
    assert (got.near, got.far, got.use_ndc, got.aabb_scale) == (
        want.near, want.far, want.use_ndc, want.aabb_scale)


@pytest.mark.parametrize("ext,factor", [("png", 1), ("png", 4), ("jpg", 2)])
def test_load_robot_matches_jax(tmp_path, ext, factor):
    """14 poses, images 0-14 but 7 (as the wheel capture has them): pose k
    pairs with the k-th image in index order, the last pose is dropped for
    want of an image; LANCZOS by ``downsample_factor``."""
    cap = write_capture(tmp_path, ring_poses(14), size=(64, 40), ext=ext, missing=(7,),
                        seed=3, extra=1)
    tc, jc = _dataset_cfgs(cap, downsample_factor=factor)
    got, want = load_robot(tc), jload_robot(jc)
    _same(got, want)
    assert got.images.shape == (14, 40 // factor, 64 // factor, 3)
    assert list(got.val_idx) == [0, 8] and len(got.train_idx) == 12
    assert got.use_ndc and got.aabb_scale == 2.0
    # the D405's field of view: two focal lengths on a non-square image
    assert got.intrinsics.fl_x != pytest.approx(got.intrinsics.fl_y)


def test_load_robot_names_and_pairs_like_jax(tmp_path):
    """Images named ``frame_k`` under ``images/`` and more poses than
    images: the same pairing by trailing index, skipping what is not an
    indexed image."""
    cap = write_capture(tmp_path, slide_poses(11), size=(32, 24), prefix="frame_",
                        missing=(2, 3), seed=4)
    os.rename(os.path.join(cap, "images_robot"), os.path.join(cap, "images"))
    for name in ("notes.txt", "frame_x.png"):
        shutil.copy(os.path.join(cap, "poses.txt"), os.path.join(cap, "images", name))
    tc, jc = _dataset_cfgs(cap, downsample_factor=2, no_ndc=True)
    got = load_robot(tc)
    _same(got, jload_robot(jc))
    assert got.images.shape[0] == 9 and not got.use_ndc


def test_load_robot_through_the_cache(tmp_path):
    """``dataset.cachedir``: the first load writes the cache, the second
    reads it back; both equal the JAX loader's dataset (read through its
    own cache as well)."""
    cap = write_capture(tmp_path / "cap", ring_poses(10), size=(48, 32), seed=6)
    tc, jc = _dataset_cfgs(cap, downsample_factor=2, cachedir=str(tmp_path / "cache"))
    first = load_dataset(tc)
    assert len(os.listdir(tmp_path / "cache")) == 1
    again = load_dataset(tc)
    want = jload_dataset(jc)
    _same(first, want)
    _same(again, want)


def test_capture_writer_gives_the_rendered_poses(tmp_path):
    """chip_smoke.py's FK writer: raw matrices in millimetres whose
    normalization by the loader gives the rendered poses up to x -> k (x -
    m) (the rotations unchanged), for the ring and the slide it renders;
    the scene (the object on its table) maps inside the engine's box on
    the ring."""
    import chip_smoke as cs

    world = cs.robot_world_poses()
    for name, w in world.items():
        root = tmp_path / name
        (root / "images_robot").mkdir(parents=True)
        cs.write_poses_txt(str(root / "poses.txt"), cs.fk_matrices(w))
        for k in range(len(w)):
            shutil.copy(write_capture(tmp_path / "one", w[:1], size=(16, 9)) +
                        "/images_robot/TestNERF 0.png",
                        root / "images_robot" / f"TestNERF {k}.png")
        ds = load_robot(_dataset_cfgs(root)[0])
        m, k = cs.robot_similarity(w)
        want = np.array(w)
        want[:, :3, 3] = (want[:, :3, 3] - m) * k
        np.testing.assert_allclose(ds.poses, want, rtol=0, atol=1e-5)
        assert np.linalg.norm(ds.poses[1:, :3, 3], axis=1).max() == pytest.approx(1.0, abs=1e-6)
    m, k = cs.robot_similarity(world["ring"])
    half, z0 = cs.ROBOT_FLOOR_HALF, cs.ROBOT_FLOOR_Z
    lo, hi = (np.array([-half, -half, z0]) - m) * k, (np.array([half, half, 0.45]) - m) * k
    assert np.abs(np.stack([lo, hi])).max() <= cs.ROBOT_BOX


def test_rays_with_two_focal_lengths_match_jax():
    """get_rays for a non-square image with fl_x != fl_y and the D405's
    centre, against the JAX package's."""
    W, H = 40, 24
    fl_x = 0.5 * W / np.tan(np.radians(87.0) / 2)
    fl_y = 0.5 * H / np.tan(np.radians(58.0) / 2)
    c2w = ring_poses(3)[1].astype(np.float32)
    o, d = trays.get_rays(H, W, fl_x, torch.tensor(c2w), cx=W / 2, cy=H / 2, focal_y=fl_y)
    jo, jd = jrays.get_rays(H, W, fl_x, jnp.asarray(c2w), cx=W / 2, cy=H / 2, focal_y=fl_y)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    # the focal lengths act on their own axes
    d = d.numpy()
    assert not np.allclose(d[0, 1] - d[0, 0], (d[1, 0] - d[0, 0])[[1, 0, 2]])


@pytest.mark.parametrize("name", ["wheel_ngp.yml", "wheel_robot.yml"])
def test_trainer_two_steps_from_the_wheel_configs(tmp_path, name):
    """configs/wheel_ngp.yml (fast engine) and configs/wheel_robot.yml
    (classic, NDC) as shipped, read by the port's YAML reader, with
    ``basedir`` pointed at a capture; cut to CPU size: 256 rays a step and
    two steps. Trainer(cfg, device="cpu") loads the capture itself; the
    losses are finite."""
    cap = write_capture(tmp_path / "cap", slide_poses(10), size=(80, 48), seed=7)
    cfg = tcfg.load_config(os.path.join(ROOT, "configs", name))
    cfg = cfg.replace(
        dataset=dataclasses.replace(cfg.dataset, basedir=cap),
        experiment=dataclasses.replace(cfg.experiment, logdir=str(tmp_path / "logs"),
                                       train_iters=2, validate_every=0, save_every=0,
                                       print_every=0),
        nerf=dataclasses.replace(cfg.nerf, num_random_rays=256))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.dataset.images.shape == (10, 6, 10, 3)
    assert trainer.dataset.use_ndc == (name == "wheel_robot.yml")
    res = trainer.fit()
    trainer.close()
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
