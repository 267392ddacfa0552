"""SfM in the port (``poses/sfm.py``, ``cli/sfm2nerf.py``) on the CPU: the
counterparts of ``tests/test_sfm.py`` (cv2 as an ``importorskip``, as
there), then the bundle adjustment and the whole pipeline against the JAX
package's on the same inputs.

Tolerances. The port's own checks keep ``tests/test_sfm.py``'s (0.5 px
after BA, 2.5 px and an RMS of 0.2 for the sprite orbit, focal within
10 %). Against the JAX package: ``_rodrigues`` and its gradient 2e-6
absolute (f32 sin / cos of both libraries); the cosine schedule's rate 1e-6
relative plus 1e-10 absolute at every count (f32 both; near the end 1 + cos
cancels, and an ulp of cos there is 3e-11 of the rate); ``bundle_adjust`` for 300 iterations
from the same noisy start, cameras 2e-6, points 1e-5, focal 1e-5 relative
and the mean reprojection error 1e-4 px (the same f32 arithmetic in another
order: measured 1.8e-7, 1.4e-6, 0 and 2.2e-6); ``run_sfm`` and
``sfm_to_transforms`` on the sprite capture, both from cv2's default
random stream (and left there for the tests that follow): the same registered images, camera centres within 1e-3 of
the orbit's radius 4 and the focal within 1e-4 relative (the front-end's
gates see the bundle adjustments' f32 results), the transforms within 1e-3.
"""

import json

import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.poses import sfm as jsfm
from nerf_kinematics_tpu_torch.poses import sfm as tsfm
from nerf_kinematics_tpu_torch.poses.sfm import (
    build_pairs,
    build_tracks,
    bundle_adjust,
    run_sfm,
    sfm_to_transforms,
    triangulate_dlt,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ba_problem(seed=3, n_cams=6, n_pts=80, f=300.0):
    """tests/test_sfm.py's noisy BA problem: exact cameras on a line, noisy
    start (camera 0 exact, the gauge)."""
    rng = np.random.default_rng(seed)
    cx = cy = 160.0
    X = rng.uniform(-1, 1, (n_pts, 3)) + np.array([0, 0, 4.0])
    rv = np.zeros((n_cams, 3))
    tv = np.stack([np.array([0.4 * i - 1.0, 0.0, 0.0]) for i in range(n_cams)])
    cam_idx = np.repeat(np.arange(n_cams), n_pts)
    pt_idx = np.tile(np.arange(n_pts), n_cams)
    uv = np.concatenate([
        np.stack([f * (X[:, 0] + tv[c, 0]) / X[:, 2] + cx,
                  f * (X[:, 1] + tv[c, 1]) / X[:, 2] + cy], -1) for c in range(n_cams)])
    rv_n = rv + rng.normal(0, 0.01, rv.shape)
    rv_n[0] = 0
    tv_n = tv + rng.normal(0, 0.02, tv.shape)
    tv_n[0] = tv[0]
    X_n = X + rng.normal(0, 0.05, X.shape)
    return (rv_n, tv_n, X_n, cam_idx, pt_idx, uv), (f, cx, cy)


# ------------------------------------------------ counterparts of test_sfm.py

def test_build_pairs_window_and_loops():
    pairs = build_pairs(20, window=3, long_range_stride=8)
    assert (0, 1) in pairs and (0, 3) in pairs and (1, 5) not in pairs
    assert any(j - i > 3 for i, j in pairs)
    assert pairs == jsfm.build_pairs(20, window=3, long_range_stride=8)


def test_build_tracks_merges_and_drops_contradictions():
    matches = {
        (0, 1): (np.array([5]), np.array([7])),
        (1, 2): (np.array([7]), np.array([9])),
        (0, 2): (np.array([5]), np.array([11])),  # image 2 seen twice
    }
    assert build_tracks(matches) == []
    del matches[(0, 2)]
    tracks = build_tracks(matches)
    assert len(tracks) == 1 and tracks[0] == {0: 5, 1: 7, 2: 9}


def test_triangulate_dlt_exact():
    X_true = np.array([0.3, -0.2, 2.5])
    K = np.array([[300.0, 0, 160], [0, 300, 160], [0, 0, 1]])
    Ps, uvs = [], []
    for tx in (-0.5, 0.0, 0.5):
        P = K @ np.hstack([np.eye(3), np.array([[tx], [0], [0]])])
        x = P @ np.append(X_true, 1.0)
        Ps.append(P)
        uvs.append(x[:2] / x[2])
    np.testing.assert_allclose(triangulate_dlt(Ps, uvs), X_true, atol=1e-9)


def test_bundle_adjust_reduces_noise():
    """BA pulls noisy cameras and points back toward the exact geometry."""
    args, (f, cx, cy) = _ba_problem()
    _, _, _, f_out, err = bundle_adjust(*args, f, cx, cy, iters=1500,
                                        optimize_focal=False, device="cpu")
    assert err < 0.5, f"BA left {err:.2f}px mean reprojection error"
    assert f_out == pytest.approx(f)


@pytest.fixture(scope="module")
def sprite_capture(tmp_path_factory):
    """tests/test_sfm.py's capture: 300 textured point sprites, 10 views of
    400^2 on an orbit of radius 4, through an exact pinhole (60 degrees)."""
    cv2 = pytest.importorskip("cv2")
    from test_sfm import _orbit, _render_sprites

    rng = np.random.default_rng(7)
    n_pts, n_views, H, W = 300, 10, 400, 400
    focal = 0.5 * W / np.tan(np.radians(60.0) / 2)
    pts = rng.uniform(-1, 1, (n_pts, 3))
    patterns = rng.integers(0, 255, (n_pts, 8, 8, 3)).astype(np.uint8)
    poses = _orbit(n_views)
    d = tmp_path_factory.mktemp("sfm_imgs")
    paths = []
    for i, p in enumerate(poses):
        path = str(d / f"{i:03d}.png")
        cv2.imwrite(path, _render_sprites(pts, patterns, p, H, W, focal))
        paths.append(path)
    return paths, poses, focal


@pytest.fixture
def fresh_cv2_rng():
    """cv2's random stream (RANSAC's) as a fresh process has it, before the
    test and after it: seed 0 is OpenCV's default state."""
    import cv2

    cv2.setRNGSeed(0)
    yield cv2
    cv2.setRNGSeed(0)


@pytest.fixture(scope="module")
def sfm_pair(sprite_capture):
    """run_sfm of the port and of the JAX package on the capture, each from
    cv2's default random stream (RANSAC)."""
    import cv2

    paths = sprite_capture[0]
    cv2.setRNGSeed(0)
    port = run_sfm(paths, max_dim=640, window=4, ba_iters=1500, verbose=False,
                   device="cpu")
    cv2.setRNGSeed(0)
    ref = jsfm.run_sfm(paths, max_dim=640, window=4, ba_iters=1500, verbose=False)
    cv2.setRNGSeed(0)
    return port, ref


def test_run_sfm_recovers_orbit(sprite_capture, sfm_pair):
    from test_sfm import _align_similarity

    paths, gt_poses, gt_focal = sprite_capture
    result = sfm_pair[0]
    assert len(result.registered) == len(paths)
    # whole-pixel sprite placement: 1-2 px residuals are the floor
    assert result.mean_reproj_px < 2.5
    centers = result.c2w()[:, :3, 3]
    rms = _align_similarity(centers, gt_poses[np.asarray(result.registered), :3, 3])
    assert rms < 0.2, f"camera-center RMS after alignment: {rms:.3f}"
    assert abs(result.focal - gt_focal) / gt_focal < 0.10


def test_sfm_to_transforms_normalization(sprite_capture, sfm_pair):
    paths = sprite_capture[0]
    result = sfm_pair[0]
    out = sfm_to_transforms(result, paths, target_avg_distance=4.0,
                            with_sharpness=True, verbose=False)
    assert len(out["frames"]) == len(result.registered)
    mats = np.stack([f["transform_matrix"] for f in out["frames"]])
    assert np.linalg.norm(mats[:, :3, 3], axis=1).mean() == pytest.approx(4.0, rel=1e-6)
    assert all("sharpness" in f for f in out["frames"])
    assert out["w"] == 400 and out["fl_x"] == pytest.approx(result.focal)


# ---------------------------------------------------- against the JAX package

def test_rodrigues_and_its_gradient_match_jax():
    """Including theta = 0 exactly (the gauge camera), where the smooth norm
    keeps the gradient finite."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    r = np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.7, (7, 3)),
                        np.full((1, 3), 1e-9)]).astype(np.float32)
    w = rng.normal(size=(len(r), 3, 3)).astype(np.float32)
    want = np.asarray(jsfm._rodrigues_jax(jnp.asarray(r)))
    gwant = np.asarray(jax.grad(lambda x: jnp.sum(jsfm._rodrigues_jax(x) * w))(jnp.asarray(r)))
    rt = torch.tensor(r, requires_grad=True)
    got = tsfm._rodrigues(rt)
    (grad,) = torch.autograd.grad((got * torch.tensor(w)).sum(), rt)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(grad.numpy(), gwant, rtol=0, atol=2e-6)
    assert np.isfinite(grad.numpy()).all()


@pytest.mark.parametrize("iters", [7, 300, 3000])
def test_cosine_schedule_matches_optax(iters):
    import optax

    sched = optax.cosine_decay_schedule(1e-3, iters, alpha=0.01)
    counts = np.arange(iters + 3, dtype=np.int32)
    want = np.asarray([sched(np.int32(c)) for c in counts])
    got = tsfm.cosine_decay_lr(1e-3, iters, torch.tensor(counts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("optimize_focal", [False, True])
def test_bundle_adjust_matches_jax(optimize_focal):
    """300 iterations from the same noisy start (and a focal 5 % off where
    it is optimised)."""
    args, (f, cx, cy) = _ba_problem(seed=4)
    f0 = f * 1.05 if optimize_focal else f
    got = bundle_adjust(*args, f0, cx, cy, iters=300, optimize_focal=optimize_focal,
                        device="cpu")
    want = jsfm.bundle_adjust(*args, f0, cx, cy, iters=300, optimize_focal=optimize_focal)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == np.float64 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert got[3] == pytest.approx(want[3], rel=1e-5)
    assert got[4] == pytest.approx(want[4], abs=1e-4)
    assert (got[3] == f0) != optimize_focal
    assert got[4] < 1.0


def test_bundle_adjust_asks_for_the_gpu(monkeypatch):
    args, (f, cx, cy) = _ba_problem()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bundle_adjust(*args, f, cx, cy, iters=2)


def test_run_sfm_matches_jax(sfm_pair):
    port, ref = sfm_pair
    assert port.registered == ref.registered
    assert port.image_names == ref.image_names
    assert (port.width, port.height) == (ref.width, ref.height)
    assert port.focal == pytest.approx(ref.focal, rel=1e-4)
    np.testing.assert_allclose(port.c2w()[:, :3, 3], ref.c2w()[:, :3, 3], rtol=0, atol=4e-3)
    np.testing.assert_allclose(port.R, ref.R, rtol=0, atol=1e-3)
    assert port.points.shape == ref.points.shape
    np.testing.assert_array_equal(port.track_lengths, ref.track_lengths)
    assert port.mean_reproj_px == pytest.approx(ref.mean_reproj_px, abs=1e-2)


def test_sfm_to_transforms_matches_jax(sprite_capture, sfm_pair, tmp_path):
    paths = sprite_capture[0]
    port, ref = sfm_pair
    got = sfm_to_transforms(port, paths, out_path=str(tmp_path / "t.json"), verbose=False)
    want = jsfm.sfm_to_transforms(ref, paths, out_path=str(tmp_path / "j.json"),
                                  verbose=False)
    assert got.keys() == want.keys()
    for k in ("w", "h", "cx", "cy", "aabb_scale", "k1", "k2", "p1", "p2"):
        assert got[k] == want[k]
    for k in ("fl_x", "fl_y", "camera_angle_x", "camera_angle_y"):
        assert got[k] == pytest.approx(want[k], rel=1e-4)
    for g, w in zip(got["frames"], want["frames"]):
        assert g["file_path"] == w["file_path"] and g["sharpness"] == w["sharpness"]
        np.testing.assert_allclose(g["transform_matrix"], w["transform_matrix"],
                                   rtol=0, atol=1e-3)
    assert json.loads((tmp_path / "t.json").read_text())["frames"][0]["file_path"] == \
        json.loads((tmp_path / "j.json").read_text())["frames"][0]["file_path"]


def test_sfm2nerf_cli_matches_jax(sprite_capture, tmp_path, fresh_cv2_rng):
    """Both command lines on the capture with its last two frames in a
    held-out folder: the same train and val splits and the same frames
    within the transforms' tolerance."""
    import shutil

    from nerf_kinematics_tpu.cli import sfm2nerf as jcli
    from nerf_kinematics_tpu_torch.cli import sfm2nerf as tcli

    paths = sprite_capture[0]
    train, val = tmp_path / "images", tmp_path / "val"
    train.mkdir()
    val.mkdir()
    for i, p in enumerate(paths):
        shutil.copy(p, (val if i in (4, 7) else train))
    args = ["--images", str(train), "--val-images", str(val), "--max_dim", "640",
            "--window", "4", "--ba_iters", "300"]
    tcli.main(args + ["--out", str(tmp_path / "port.json"), "--device", "cpu"])
    fresh_cv2_rng.setRNGSeed(0)
    jcli.main(args + ["--out", str(tmp_path / "jax.json")])
    for split in ("", "_val"):
        got = json.loads((tmp_path / f"port{split}.json").read_text())
        want = json.loads((tmp_path / f"jax{split}.json").read_text())
        assert [f["file_path"] for f in got["frames"]] == \
            [f["file_path"] for f in want["frames"]]
        assert got["fl_x"] == pytest.approx(want["fl_x"], rel=1e-4)
        for g, w in zip(got["frames"], want["frames"]):
            np.testing.assert_allclose(g["transform_matrix"], w["transform_matrix"],
                                       rtol=0, atol=1e-3)
    assert len(json.loads((tmp_path / "port_val.json").read_text())["frames"]) == 2
