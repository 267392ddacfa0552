"""The synthetic scenes, their orbit poses and the render buffer on the CPU,
against the JAX package: the same numpy inputs to both.

Tolerances. Poses: atol 1e-12 (f64 both). The fields on the same points:
rtol 1e-5 / atol 1e-6 (the sphere in f32, whose exponentials numpy and
torch round a few ulps apart; the blobs and the halo in f64 as numpy
promotes them, in both). The rendered images: atol 1e-5 (f32
exponentials and a 192-sample product; measured below 2e-6). Tonemap and
the buffer: atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.data import synthetic as js
from nerf_kinematics_tpu.poses import orbit as jo
from nerf_kinematics_tpu.rendering import render_buffer as jrb
from nerf_kinematics_tpu_torch.data import LOADERS, load_dataset, synthetic as ts
from nerf_kinematics_tpu_torch.poses import orbit as to
from nerf_kinematics_tpu_torch.rendering import render_buffer as trb
from nerf_kinematics_tpu_torch.train import config as tcfg

LENS = (0.05, -0.01, 0.002, -0.001)  # k1, k2, p1, p2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ poses

@pytest.mark.parametrize("fn,args", [
    ("generate_test_poses", ()), ("generate_video_poses", ()),
    ("generate_orbit_poses", (3.5, 7, 0.8, 3)), ("generate_orbit_poses", (11.0, 2))])
def test_orbit_poses_match_jax(fn, args):
    center = np.array([0.3, -0.2, 0.5])
    want = getattr(jo, fn)(center, *args)
    got = getattr(to, fn)(center, *args)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # rotation blocks are orthonormal, the cameras look at the center
    R = got[:, :3, :3].numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-12)
    fwd = -R[:, :, 2]
    to_c = center - got[:, :3, 3].numpy()
    np.testing.assert_allclose(np.cross(fwd, to_c), 0.0, atol=1e-9)


def test_look_at_matches_jax():
    rng = np.random.default_rng(0)
    pos = rng.standard_normal((6, 3)) * 4.0
    want = jo._look_at_poses(pos, np.zeros(3))
    got = to._look_at_poses(torch.tensor(pos), torch.zeros(3)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)


# ----------------------------------------------------------------- fields

@pytest.mark.parametrize("name", ["field_fn", "field_fn_blobs", "field_fn_halo"])
def test_fields_match_jax(name):
    rng = np.random.default_rng(1)
    scale = 8.0 if name == "field_fn_halo" else 1.0
    pts = (rng.uniform(-1, 1, (5, 40, 3)) * scale).astype(np.float32)
    rgb_j, sig_j = getattr(js, name)(pts)
    rgb_t, sig_t = getattr(ts, name)(torch.tensor(pts))
    assert rgb_t.shape == rgb_j.shape and sig_t.shape == sig_j.shape
    assert rgb_t.dtype == {np.float32: torch.float32, np.float64: torch.float64}[rgb_j.dtype.type]
    np.testing.assert_allclose(rgb_t.numpy(), rgb_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sig_t.numpy(), sig_j, rtol=1e-5, atol=1e-6)
    assert (sig_t >= 0).all() and (rgb_t >= 0).all() and (rgb_t <= 1).all()


# ----------------------------------------------------------------- scenes

@pytest.mark.parametrize("variant,dist,res", [
    ("sphere", None, 16), ("blobs", None, 24), ("halo", None, 32), ("sphere", LENS, 16),
    ("halo", LENS, 16)])
def test_scene_matches_jax(variant, dist, res):
    want = js.make_synthetic_scene(n_views=5, resolution=res, variant=variant, dist=dist)
    got = ts.make_synthetic_scene(n_views=5, resolution=res, variant=variant, dist=dist,
                                  device="cpu")
    assert got.images.shape == want.images.shape == (5, res, res, 3)
    assert got.images.dtype == np.float32 and got.poses.dtype == np.float32
    np.testing.assert_allclose(got.images, want.images, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.poses, want.poses)
    for k in ("near", "far", "aabb_scale", "use_ndc"):
        assert getattr(got, k) == getattr(want, k), k
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.val_idx, want.val_idx)
    gi, wi = got.intrinsics, want.intrinsics
    for k in ("fl_x", "fl_y", "cx", "cy", "width", "height", "k1", "k2", "p1", "p2"):
        assert getattr(gi, k) == getattr(wi, k), k
    assert (gi.distortion is None) == (dist is None)
    assert got.images.std() > 0.01  # something is in view


def test_halo_scene_is_the_large_aabb_regime():
    ds = ts.make_synthetic_scene(n_views=3, resolution=8, variant="halo", device="cpu")
    assert (ds.near, ds.far, ds.aabb_scale) == (2.5, 20.0, 32.0)
    np.testing.assert_allclose(np.linalg.norm(ds.poses[0, :3, 3]), 11.0, rtol=1e-6)


def test_render_gt_chunks_give_the_same_image(monkeypatch):
    pose = ts.scene_poses(1, 2.0, device="cpu")[0]
    whole = ts._render_gt(pose, 12, 10, 9.0, 0.5, 3.5, device="cpu")
    monkeypatch.setattr(ts, "CHUNK_POINTS", 10 * 192 * 3)  # 3 rows a chunk
    assert torch.equal(ts._render_gt(pose, 12, 10, 9.0, 0.5, 3.5, device="cpu"), whole)


def test_load_dataset_synthetic(tmp_path):
    """``dataset.type: synthetic`` as configs/synthetic_smoke.yml has it: the
    sphere with the config's near / far, through the cache too."""
    raw = {"type": "synthetic", "near": 0.5, "far": 3.5}
    cfg = tcfg.config_from_dict({"dataset": raw}).dataset
    ds = load_dataset(cfg, device="cpu")
    want = js.make_synthetic_scene(cfg)
    np.testing.assert_allclose(ds.images, want.images, atol=1e-5)
    assert LOADERS["synthetic"] is ts.make_synthetic_scene
    cached = tcfg.config_from_dict({"dataset": dict(raw, cachedir=str(tmp_path))}).dataset
    first = load_dataset(cached, device="cpu")
    again = load_dataset(cached, device="cpu")
    np.testing.assert_array_equal(again.images, first.images)
    assert len(list(tmp_path.iterdir())) == 1


def test_scene_needs_a_device_or_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.make_synthetic_scene(n_views=2, resolution=4)


# ----------------------------------------------------------- render buffer

def test_render_buffer_accumulates_as_jax():
    rng = np.random.default_rng(3)
    frames = rng.uniform(0, 1.2, (4, 6, 5, 3)).astype(np.float32)
    jb, tb = jrb.new_buffer(6, 5), trb.new_buffer(6, 5)
    assert tb.spp.dtype == torch.int32 and int(tb.spp) == 0
    np.testing.assert_array_equal(tb.resolved.numpy(), np.asarray(jb.resolved))
    for f in frames:
        jb, tb = jrb.accumulate(jb, jnp.asarray(f)), trb.accumulate(tb, torch.tensor(f))
    assert int(tb.spp) == 4
    np.testing.assert_allclose(tb.resolved.numpy(), np.asarray(jb.resolved), atol=1e-6)
    np.testing.assert_allclose(tb.resolved.numpy(), frames.mean(0), atol=1e-6)


@pytest.mark.parametrize("exposure,srgb", [(0.0, True), (1.5, True), (-1.0, False)])
def test_tonemap_matches_jax(exposure, srgb):
    x = np.concatenate([np.linspace(-0.1, 1.3, 200), [0.0, 0.0031308, 1e-9]]).astype(np.float32)
    want = np.asarray(jrb.tonemap(jnp.asarray(x), exposure, srgb))
    got = trb.tonemap(torch.tensor(x), exposure, srgb).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got.min() >= 0.0 and got.max() <= 1.0
