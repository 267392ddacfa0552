"""The port's pose tools against the JAX package's: the parser, the
normalization, the orbits, the converter (``convert_poses``), sharpness and
the camera path. Mirrors tests/test_poses.py and tests/test_camera_path.py,
whose capture cases skip here (the real wheel capture is not in the
repository): these tests write their own FK captures (``write_capture``,
also used by the robot, parallax and pipeline tests).

Tolerances: the parser, the normalization and the camera path run the same
float64 numpy operations in both packages and are compared to the bit;
the converter's dicts to 1e-12 (the orbits are torch in the port); the
sharpness equals Pillow's, which the JAX function calls."""

import json
import math
import os

import numpy as np
import pytest
import torch

from nerf_kinematics_tpu.poses import camera_path as jcp
from nerf_kinematics_tpu.poses import normalize as jnorm
from nerf_kinematics_tpu.poses import parser as jparser
from nerf_kinematics_tpu.poses import pipeline as jpipe
from nerf_kinematics_tpu.poses import sharpness as jsharp
from chip_smoke import fk_matrices
from nerf_kinematics_tpu_torch.data.machina import _look_at_poses
from nerf_kinematics_tpu_torch.io.image import write_png
from nerf_kinematics_tpu_torch.poses import (
    aabb_scale_for,
    camera_centers,
    generate_test_poses,
    generate_video_poses,
    normalize_poses,
    parse_poses_file,
    parse_poses_text,
)
from nerf_kinematics_tpu_torch.poses import camera_path as tcp
from nerf_kinematics_tpu_torch.poses import sharpness as tsharp
from nerf_kinematics_tpu_torch.poses.normalize import _flip_z
from nerf_kinematics_tpu_torch.poses.pipeline import (
    base_transforms_dict, convert_poses, intrinsics_from_fov)

SAMPLE = """
[     0.730263,    -0.682985,    -0.015725,  1072.532608 ;
     -0.683050,    -0.729519,    -0.035290,   132.989927 ;
      0.012630,     0.036512,    -0.999253,   -53.612386 ;
      0.000000,     0.000000,     0.000000,     1.000000 ];


[     0.730277,    -0.682968,    -0.015808,  1072.524301 ;
     -0.683036,    -0.729532,    -0.035287,   205.916738 ;
      0.012568,     0.036567,    -0.999252,   -53.688525 ;
      0.000000,     0.000000,     0.000000,     1.000000 ];
"""


# ---------------------------------------------------------------- captures

def ring_poses(n: int, radius: float = 1.4, height: float = 0.6) -> np.ndarray:
    """OpenGL camera-to-world poses on a circle, looking at the origin."""
    a = 2 * np.pi * np.arange(n) / n
    return _look_at_poses(np.stack([radius * np.cos(a), radius * np.sin(a),
                                    np.full(n, height)], 1), np.zeros(3))


def slide_poses(n: int, step: float = 0.073, height: float = 0.5) -> np.ndarray:
    """Poses on a line along +y looking straight down (the wheel capture)."""
    m = np.tile(np.eye(4), (n, 1, 1))
    m[:, 1, 3] = (np.arange(n) - (n - 1) / 2) * step
    m[:, 2, 3] = height
    return m


def messy_poses_text(mats, seed: int = 0) -> str:
    """A poses.txt as a controller might log it: irregular spaces and blank
    lines, some numbers in scientific notation, garbage rows and a garbage
    block between the matrices."""
    rng = np.random.default_rng(seed)
    out = ["# controller log\n\n"]
    for i, m in enumerate(mats):
        rows = []
        for r in m:
            toks = [f"{v:.6e}" if rng.random() < 0.3 else f"{v:.6f}" for v in r]
            rows.append(" " * int(rng.integers(0, 6)) + ",  ".join(toks))
        if i % 3 == 1:  # a row of three numbers is skipped, the block keeps four
            rows.insert(2, " 1.0, 2.0, 3.0")
        out.append("[" + " ;\n".join(rows) + " ];\n" + "\n" * int(rng.integers(0, 3)))
        if i == 2:
            out.append("[ 1, 2, 3, 4 ; 5, 6, 7, 8 ];  # not a 4x4\n\n")
    return "".join(out)


def seeded_image(rng, w: int, h: int, saturate: bool = False) -> np.ndarray:
    """(h, w, 3) uint8: smooth gradients, a few edges and noise; with
    ``saturate`` large flat 0 / 255 areas beside sharp ones, where the
    Laplacian clamps."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([xx / w * 255, yy / h * 255, (xx + yy) / (w + h) * 255], -1)
    img += rng.normal(0, 25, img.shape)
    img[h // 3: h // 2, w // 4: w // 2] = rng.uniform(0, 255, 3)
    if saturate:
        img[: h // 2] = np.where(rng.random((h // 2, w, 1)) < 0.5, 0.0, 255.0)
        img[:, : w // 4] = 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def write_capture(root, world, size=(40, 24), ext: str = "png", missing=(),
                  seed: int = 0, prefix: str = "TestNERF ", extra: int = 0) -> str:
    """A capture directory: poses.txt (messy_poses_text of the FK matrices
    chip_smoke.py's robot phase writes for ``world``)
    and images_robot/<prefix>k.<ext> for k < len(world) + extra not in
    ``missing`` (JPEG through Pillow)."""
    root = str(root)
    os.makedirs(os.path.join(root, "images_robot"), exist_ok=True)
    with open(os.path.join(root, "poses.txt"), "w") as f:
        f.write(messy_poses_text(fk_matrices(world), seed))
    rng = np.random.default_rng(seed)
    for k in range(len(world) + extra):
        img = seeded_image(rng, *size, saturate=k % 4 == 3)
        if k in missing:
            continue
        path = os.path.join(root, "images_robot", f"{prefix}{k}.{ext}")
        if ext == "png":
            write_png(path, img)
        else:
            from PIL import Image

            Image.fromarray(img).save(path, quality=90)
    return root


# ---------------------------------------------------------------- parser

def test_parse_sample_text():
    mats = parse_poses_text(SAMPLE)
    assert mats.shape == (2, 4, 4)
    assert mats[0, 0, 0] == pytest.approx(0.730263)
    assert mats[0, 0, 3] == pytest.approx(1072.532608)
    assert mats[1, 1, 3] == pytest.approx(205.916738)
    assert np.allclose(mats[:, 3], [0, 0, 0, 1])
    assert np.array_equal(mats, jparser.parse_poses_text(SAMPLE))


def test_parse_scientific_notation_and_garbage_rows():
    text = "[1e0, 2.5e-1, 0, 3 ; 0, 1, 0, -4E+1 ; 0, 0, 1, 0 ; 0,0,0,1]"
    mats = parse_poses_text(text)
    assert mats[0, 0, 1] == pytest.approx(0.25)
    assert mats[0, 1, 3] == pytest.approx(-40.0)
    assert np.array_equal(mats, jparser.parse_poses_text(text))


def test_parse_rejects_empty():
    with pytest.raises(ValueError, match="no 4x4 pose matrices"):
        parse_poses_text("no matrices here")
    with pytest.raises(ValueError, match="no 4x4 pose matrices"):
        jparser.parse_poses_text("no matrices here")


def test_parse_messy_file_matches_jax(tmp_path):
    """A file with blank lines, irregular spaces, scientific notation and
    garbage rows and blocks: the same (N, 4, 4) array as the JAX parser,
    to the bit, and the matrices written."""
    world = ring_poses(12)
    path = tmp_path / "poses.txt"
    path.write_text(messy_poses_text(fk_matrices(world), seed=3))
    mats = parse_poses_file(path)
    assert mats.shape == (12, 4, 4) and mats.dtype == np.float64
    assert np.array_equal(mats, jparser.parse_poses_file(path))
    np.testing.assert_allclose(mats, fk_matrices(world), rtol=1e-6, atol=1e-6)
    rots = mats[:, :3, :3]
    assert np.allclose(np.einsum("nij,nkj->nik", rots, rots), np.eye(3), atol=1e-5)


# ---------------------------------------------------------------- normalize

def test_normalize_recenter_scale_and_zflip():
    mats = parse_poses_text(SAMPLE)
    mats = np.concatenate([mats, mats[:1]], axis=0)
    norm = normalize_poses(mats, recenter=True, scale_trans=2.0)
    centers = camera_centers(norm.train)
    assert np.linalg.norm(centers, axis=1).max() == pytest.approx(2.0)
    assert np.allclose(centers.mean(axis=0), 0.0, atol=1e-12)
    assert norm.train[0, 0, 2] == pytest.approx(+0.015808)
    assert norm.train[0, 2, 2] == pytest.approx(+0.999252)
    expected_val_xyz = (mats[0, :3, 3] - norm.center) * norm.scale_factor
    expected_val_xyz[2] *= -1
    assert np.allclose(norm.val[:3, 3], expected_val_xyz)
    want = jnorm.normalize_poses(mats, recenter=True, scale_trans=2.0)
    for a, b in zip(norm, want):
        assert np.array_equal(a, b)


def test_normalize_without_recenter_is_identity():
    mats = parse_poses_text(SAMPLE)
    norm = normalize_poses(mats, recenter=False)
    assert np.array_equal(norm.train, mats[1:]) and np.array_equal(norm.val, mats[0])
    assert norm.scale_factor == 1.0 and not norm.center.any()
    for a, b in zip(norm, jnorm.normalize_poses(mats, recenter=False)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        normalize_poses(mats[:1])


def test_normalize_capture_matches_jax():
    """Pose 0 held out, the train poses' centroid, unit radius, the Z flip:
    equal to the bit on a 30-pose capture in millimetres."""
    mats = fk_matrices(ring_poses(30))
    for recenter in (True, False):
        for a, b in zip(normalize_poses(mats, recenter=recenter, scale_trans=1.5),
                        jnorm.normalize_poses(mats, recenter=recenter, scale_trans=1.5)):
            assert np.array_equal(a, b)
    assert np.array_equal(jnorm._flip_z(mats), _flip_z(mats))


def test_aabb_power_of_two_bounds():
    m = np.tile(np.eye(4), (2, 1, 1))
    m[1, :3, 3] = [10, 0, 0]
    assert aabb_scale_for(m) == 16.0 == jnorm.aabb_scale_for(m)
    m[1, :3, 3] = [0, 0, 0]
    assert aabb_scale_for(m) == 1.0 == jnorm.aabb_scale_for(m)
    m[1, :3, 3] = [1e6, 0, 0]
    assert aabb_scale_for(m) == 128.0 == jnorm.aabb_scale_for(m)
    mats = fk_matrices(ring_poses(9))
    assert aabb_scale_for(mats, 0.01) == jnorm.aabb_scale_for(mats, 0.01)


# ---------------------------------------------------------------- orbits

def test_orbit_poses_look_at_center():
    center = np.array([1.0, 2.0, 3.0])
    poses = generate_test_poses(center, radius=50, n_poses=8).numpy()
    assert poses.shape == (8, 4, 4)
    positions = poses[:, :3, 3]
    assert np.allclose(np.linalg.norm(positions[:, :2] - center[:2], axis=1), 50.0)
    assert np.allclose(positions[:, 2], center[2])
    back = poses[:, :3, 2]
    to_cam = positions - center
    to_cam /= np.linalg.norm(to_cam, axis=1, keepdims=True)
    assert np.allclose(back, to_cam, atol=1e-12)
    rots = poses[:, :3, :3]
    assert np.allclose(np.einsum("nij,nkj->nik", rots, rots), np.eye(3), atol=1e-12)
    assert np.allclose(np.linalg.det(rots), 1.0)


def test_video_poses_height_wobble():
    poses = generate_video_poses(np.zeros(3)).numpy()
    assert poses.shape == (60, 4, 4)
    z = poses[:, 2, 3]
    assert 4.7 < z.max() <= 5.0
    assert -5.0 <= z.min() < -4.7
    assert abs(z.mean()) < 1e-9


def test_intrinsics_realsense_defaults():
    intr = intrinsics_from_fov(1280, 720, 87.0, 58.0)
    assert intr["fl_x"] == pytest.approx(0.5 * 1280 / math.tan(math.radians(87.0) / 2))
    assert intr["fl_y"] == pytest.approx(0.5 * 720 / math.tan(math.radians(58.0) / 2))
    assert intr["cx"] == 640.0 and intr["cy"] == 360.0
    assert intr == jpipe.intrinsics_from_fov(1280, 720, 87.0, 58.0)
    args = (64, 36, 87, 58, 0.1, 0, 0, 0, 2.0)
    assert list(base_transforms_dict(*args).items()) == list(
        jpipe.base_transforms_dict(*args).items())


# ---------------------------------------------------------------- converter

def _close(a, b, path="") -> None:
    """Equal JSON-like trees: keys in the same order, floats to 1e-12."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-12), path
    else:
        assert a == b, path


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_full_conversion_pipeline_matches_jax(tmp_path, ext):
    """convert_poses on a capture of 13 poses and images 0-13 but 7, as
    the real wheel capture has them: the four dicts and the files equal the
    JAX converter's, the size read from the PNG header (JPEG: Pillow)."""
    cap = write_capture(tmp_path / "cap", ring_poses(13), size=(48, 27), ext=ext,
                        missing=(7,), seed=5, extra=1)
    kw = dict(poses_path=os.path.join(cap, "poses.txt"),
              image_folder=os.path.join(cap, "images_robot"), image_ext=ext,
              recenter=True, scale_trans=1.0)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = convert_poses(output=str(tmp_path / "port" / "transforms.json"), **kw)
    want = jpipe.convert_poses(output=str(tmp_path / "jax" / "transforms.json"), **kw)
    for key in ("train", "val", "test", "video"):
        _close(getattr(got, key), getattr(want, key), key)
        _close(json.load(open(got.paths[key])), json.load(open(want.paths[key])), key)
        assert os.path.basename(got.paths[key]) == os.path.basename(want.paths[key])
    assert got.scale_factor == want.scale_factor and got.aabb_scale == want.aabb_scale
    assert np.array_equal(got.center, want.center)
    assert len(got.train["frames"]) == 12 and got.train["w"] == 48 and got.train["h"] == 27
    used = [f["file_path"] for f in got.train["frames"]]
    assert f"TestNERF 1.{ext}" in used[0] and not any(f"TestNERF 7.{ext}" in p for p in used)
    assert f"TestNERF 13.{ext}" in used[-1] and len(set(used)) == 12
    assert "transform_matrix_start" in got.test["frames"][0]
    assert got.train["aabb_scale"] == 2.0 or got.train["aabb_scale"] == 4.0


def test_conversion_skips_missing_images(tmp_path):
    """Missing indices are bridged, each image used once; with one image
    too few both converters raise FileNotFoundError."""
    world = slide_poses(12)
    cap = write_capture(tmp_path / "a", world, missing=(7,), seed=2, extra=1)
    kw = dict(poses_path=os.path.join(cap, "poses.txt"),
              image_folder=os.path.join(cap, "images_robot"), image_ext="png",
              recenter=True, output=None, with_sharpness=False)
    res = convert_poses(**kw)
    _close(res.train, jpipe.convert_poses(**kw).train)
    used = [f["file_path"] for f in res.train["frames"]]
    assert not any("TestNERF 7.png" in p for p in used)
    assert any("TestNERF 12.png" in p for p in used)
    assert len(used) == len(set(used)) == 11

    cap = write_capture(tmp_path / "b", world, missing=(7, 12), seed=2, extra=1)
    kw.update(poses_path=os.path.join(cap, "poses.txt"),
              image_folder=os.path.join(cap, "images_robot"))
    with pytest.raises(FileNotFoundError):
        convert_poses(**kw)
    with pytest.raises(FileNotFoundError):
        jpipe.convert_poses(**kw)


# ---------------------------------------------------------------- sharpness

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_sharpness_equals_pillow(tmp_path, seed, ext):
    """The port's sharpness (its own PNG codec, gray formula and clamped
    Laplacian) equals the JAX function's, which filters through Pillow, on
    seeded images: odd seeds saturate, where the clamp bites. JPEG reads
    through Pillow in both."""
    rng = np.random.default_rng(100 + seed)
    w, h = int(rng.integers(5, 70)), int(rng.integers(5, 50))
    img = seeded_image(rng, w, h, saturate=seed % 2 == 1)
    if seed == 4:
        img = np.concatenate([img, rng.integers(0, 256, (h, w, 1), np.uint8)], -1)
    path = str(tmp_path / f"im.{ext}")
    if ext == "png":
        write_png(path, img)
    else:
        from PIL import Image

        Image.fromarray(img[..., :3]).save(path, quality=85)
    got = tsharp.compute_sharpness(path)
    assert got == jsharp.compute_sharpness(path)
    assert got > 0


def test_gray_equals_pillow_convert():
    from PIL import Image

    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (37, 53, 3), np.uint8)
    rgba = np.concatenate([rgb, rng.integers(0, 256, (37, 53, 1), np.uint8)], -1)
    for img, mode in ((rgb, "RGB"), (rgba, "RGBA")):
        want = np.asarray(Image.fromarray(img, mode).convert("L"))
        assert np.array_equal(tsharp.to_gray_u8(img), want)
    gray = rgb[..., 0]
    assert tsharp.compute_sharpness_array(gray) == jsharp.compute_sharpness_array(gray)


# ---------------------------------------------------------------- camera path

def test_quat_roundtrip_random():
    rng = np.random.default_rng(0)
    for _ in range(20):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        quat = tcp.rotmat_to_quat(q)
        assert np.array_equal(quat, jcp.rotmat_to_quat(q))
        np.testing.assert_allclose(tcp.quat_to_rotmat(quat), q, atol=1e-10)


def test_slerp_half_angle():
    q0 = tcp.rotmat_to_quat(np.eye(3))
    q1 = tcp.rotmat_to_quat(np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], float))
    qm = tcp.slerp(q0, q1, 0.5)
    c, s = np.cos(np.pi / 4), np.sin(np.pi / 4)
    np.testing.assert_allclose(tcp.quat_to_rotmat(qm), [[c, -s, 0], [s, c, 0], [0, 0, 1]],
                               atol=1e-10)
    for t in (0.0, 0.3, 1.0):
        assert np.array_equal(tcp.slerp(q0, q1, t), jcp.slerp(q0, q1, t))
    assert np.array_equal(tcp.slerp(q0, q0 * 0.9999999, 0.5), jcp.slerp(q0, q0 * 0.9999999, 0.5))


def test_path_hits_keyframes():
    kf = ring_poses(4, radius=2.0, height=0.0)
    path = tcp.interpolate_path(kf, 7, loop=False)
    np.testing.assert_allclose(path[0], kf[0], atol=1e-9)
    np.testing.assert_allclose(path[-1], kf[-1], atol=1e-9)
    assert np.array_equal(path, jcp.interpolate_path(kf, 7, loop=False))


def test_path_rotations_valid_and_smooth():
    kf = ring_poses(6, radius=2.0, height=0.0)
    path = tcp.interpolate_path(kf, 60, loop=True)
    assert np.array_equal(path, jcp.interpolate_path(kf, 60, loop=True))
    rots = path[:, :3, :3]
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", rots, rots),
                               np.tile(np.eye(3), (60, 1, 1)), atol=1e-8)
    np.testing.assert_allclose(np.linalg.det(rots), 1.0, atol=1e-8)
    r = np.linalg.norm(path[:, :3, 3], axis=1)
    assert (np.abs(r - 2.0) < 0.2).all()
    steps = np.linalg.norm(np.diff(path[:, :3, 3], axis=0), axis=1)
    assert steps.max() < 3 * steps.mean()


def test_single_keyframe_repeats():
    kf = ring_poses(1, radius=1.0, height=0.0)
    path = tcp.interpolate_path(kf, 5)
    assert path.shape == (5, 4, 4)
    for p in path:
        np.testing.assert_allclose(p, kf[0])
    assert np.array_equal(path, jcp.interpolate_path(kf, 5))


def test_port_orbit_matches_jax_orbit():
    """The orbits the converter writes: the port's torch poses against the
    JAX package's numpy ones."""
    from nerf_kinematics_tpu.poses import orbit as jorbit

    c = np.array([0.1, -0.2, 0.3])
    np.testing.assert_allclose(generate_video_poses(c).numpy(),
                               jorbit.generate_video_poses(c), rtol=0, atol=1e-12)
    np.testing.assert_allclose(generate_test_poses(c).numpy(),
                               jorbit.generate_test_poses(c), rtol=0, atol=1e-12)
    assert torch.is_tensor(generate_test_poses(c))
