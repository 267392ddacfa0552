"""COLMAP import in the port (``poses/colmap.py``, ``cli/colmap2nerf.py``)
on synthetic text models with known geometry: the counterparts of
``tests/test_colmap.py``, then every function and the command line against
the JAX package's on the same models.

Tolerances. The port's own checks keep ``tests/test_colmap.py``'s (1e-8 on
round-tripped poses, rtol 1e-5 on the average distance, 1e-5 on the view
directions). Against the JAX package: 1e-12 absolute on every array and
number (both are the same float64 numpy arithmetic, so they agree to the
bit or within an ulp of a matrix product); sharpness scores and the
intrinsics exactly.
"""

import json
import math

import numpy as np
import pytest

from nerf_kinematics_tpu.poses import colmap as jc
from nerf_kinematics_tpu_torch.io.image import write_png
from nerf_kinematics_tpu_torch.poses import colmap as tc
from nerf_kinematics_tpu_torch.poses.colmap import (
    colmap_pose_to_c2w,
    colmap_to_transforms,
    parse_cameras_txt,
    parse_images_txt,
    qvec_to_rotmat,
)
from nerf_kinematics_tpu_torch.poses.orbit import generate_orbit_poses
from test_colmap import _rotmat_to_quat

TOL = 1e-12


def _orbit(center, radius, n):
    return generate_orbit_poses(np.asarray(center, np.float64), radius=radius,
                                n_poses=n).numpy()


def _write_model(tmp_path, poses_c2w, w=64, h=48, f=40.0, camera=None):
    """cameras.txt / images.txt for NeRF-convention c2w poses."""
    camera = camera or "PINHOLE {} {} {} {} {} {}".format(w, h, f, f, w / 2, h / 2)
    (tmp_path / "cameras.txt").write_text(f"# cameras\n1 {camera}\n")
    lines = ["# images"]
    for i, c2w in enumerate(poses_c2w):
        m = c2w.copy()
        m[:3, 1:3] *= -1.0
        R = m[:3, :3].T
        t = -R @ m[:3, 3]
        qw, qx, qy, qz = _rotmat_to_quat(R)
        lines.append(f"{i+1} {qw} {qx} {qy} {qz} {t[0]} {t[1]} {t[2]} 1 im_{i}.png")
        lines.append("")  # empty POINTS2D line
    (tmp_path / "images.txt").write_text("\n".join(lines) + "\n")


def _write_images(d, n, w=64, h=48):
    d.mkdir()
    rng = np.random.default_rng(3)
    for i in range(n):
        write_png(str(d / f"im_{i}.png"), rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    return d


# --------------------------------------------- counterparts of test_colmap.py

def test_qvec_identity():
    np.testing.assert_allclose(qvec_to_rotmat([1, 0, 0, 0]), np.eye(3))
    q = [np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)]  # 90 degrees about z
    np.testing.assert_allclose(qvec_to_rotmat(q) @ [1, 0, 0], [0, 1, 0], atol=1e-12)


def test_roundtrip_poses(tmp_path):
    poses = _orbit(np.zeros(3), 3.0, 6)
    _write_model(tmp_path, poses)
    cams = parse_cameras_txt(str(tmp_path / "cameras.txt"))
    assert cams[1].model == "PINHOLE"
    images = parse_images_txt(str(tmp_path / "images.txt"))
    assert len(images) == 6
    rec = np.stack([colmap_pose_to_c2w(im["qvec"], im["tvec"]) for im in images])
    np.testing.assert_allclose(rec, poses, atol=1e-8)


def test_full_conversion_reorients_and_scales(tmp_path, capsys):
    poses = _orbit(np.zeros(3), 3.0, 8)  # XY-plane orbit: up is +z, distance 3
    _write_model(tmp_path, poses)
    colmap_to_transforms(str(tmp_path), images_dir=None, out_path=str(tmp_path / "t.json"))
    printed = capsys.readouterr().out
    assert "up vector" in printed and "center of attention" in printed
    assert "avg camera distance" in printed
    data = json.loads((tmp_path / "t.json").read_text())
    assert len(data["frames"]) == 8
    mats = np.asarray([f["transform_matrix"] for f in data["frames"]])
    d = np.linalg.norm(mats[:, :3, 3], axis=1)
    np.testing.assert_allclose(d.mean(), 4.0, rtol=1e-5)
    np.testing.assert_allclose(mats[:, :3, 2], mats[:, :3, 3] / d[:, None], atol=1e-5)
    assert data["w"] == 64 and data["fl_x"] == pytest.approx(40.0)


def test_keep_colmap_coords(tmp_path):
    poses = _orbit(np.ones(3) * 5, 2.0, 4)
    _write_model(tmp_path, poses)
    out = colmap_to_transforms(str(tmp_path), keep_colmap_coords=True, verbose=False)
    mats = np.asarray([f["transform_matrix"] for f in out["frames"]])
    np.testing.assert_allclose(mats, poses, atol=1e-8)


# ---------------------------------------------------- against the JAX package

CAMERAS = [
    "SIMPLE_PINHOLE 64 48 41.5 31.0 23.5",
    "PINHOLE 64 48 40.0 38.5 32.0 24.0",
    "SIMPLE_RADIAL 64 48 41.5 31.0 23.5 0.01",
    "RADIAL 64 48 41.5 31.0 23.5 0.01 -0.002",
    "OPENCV 64 48 40.0 38.5 32.0 24.0 0.01 -0.002 0.0005 -0.0003",
]


@pytest.mark.parametrize("camera", CAMERAS, ids=lambda c: c.split()[0])
def test_cameras_and_intrinsics_match_jax(tmp_path, camera):
    _write_model(tmp_path, _orbit(np.zeros(3), 3.0, 3), camera=camera)
    got = parse_cameras_txt(str(tmp_path / "cameras.txt"))
    want = jc.parse_cameras_txt(str(tmp_path / "cameras.txt"))
    assert got.keys() == want.keys()
    assert got[1].model == want[1].model and got[1].params == want[1].params
    assert got[1].intrinsics() == want[1].intrinsics()


def test_unknown_camera_model_raises_as_jax(tmp_path):
    _write_model(tmp_path, _orbit(np.zeros(3), 3.0, 3), camera="FISHEYE 64 48 40 32 24 0")
    for mod in (tc, jc):
        cam = mod.parse_cameras_txt(str(tmp_path / "cameras.txt"))[1]
        with pytest.raises(ValueError, match="unsupported COLMAP camera model"):
            cam.intrinsics()


def test_quaternions_images_and_poses_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    for q in rng.normal(size=(16, 4)):
        q = q / np.linalg.norm(q)
        np.testing.assert_allclose(qvec_to_rotmat(q), jc.qvec_to_rotmat(q), rtol=0, atol=TOL)
    poses = _orbit([0.3, -1.0, 2.0], 2.5, 7)
    _write_model(tmp_path, poses)
    got = parse_images_txt(str(tmp_path / "images.txt"))
    want = jc.parse_images_txt(str(tmp_path / "images.txt"))
    assert got == want
    for im in got:
        np.testing.assert_allclose(colmap_pose_to_c2w(im["qvec"], im["tvec"]),
                                   jc.colmap_pose_to_c2w(im["qvec"], im["tvec"]),
                                   rtol=0, atol=TOL)


def test_pose_glue_matches_jax():
    """The center of attention and the up-vector rotation (parallel,
    antiparallel and general directions)."""
    rng = np.random.default_rng(11)
    o, d = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    np.testing.assert_allclose(tc._closest_point_to_rays(o, d),
                               jc._closest_point_to_rays(o, d), rtol=0, atol=TOL)
    z = np.array([0.0, 0.0, 1.0])
    for a in (z, -z, rng.normal(size=3), np.array([0.0, 1e-14, -1.0])):
        a = a / np.linalg.norm(a)
        np.testing.assert_allclose(tc._rotation_aligning(a, z), jc._rotation_aligning(a, z),
                                   rtol=0, atol=TOL)


@pytest.mark.parametrize("keep", [False, True])
def test_colmap_to_transforms_matches_jax(tmp_path, capsys, keep):
    """The whole conversion with sharpness scores of PNG frames: the same
    dict, numbers within 1e-12, and the same printed lines."""
    model = tmp_path / "model"
    model.mkdir()
    _write_model(model, _orbit([1.0, 2.0, 0.5], 3.0, 6), camera=CAMERAS[4])
    images = _write_images(tmp_path / "images", 6)
    kw = dict(images_dir=str(images), aabb_scale=8.0, keep_colmap_coords=keep)
    got = colmap_to_transforms(str(model), out_path=str(tmp_path / "t.json"), **kw)
    printed = capsys.readouterr().out
    want = jc.colmap_to_transforms(str(model), out_path=str(tmp_path / "j.json"), **kw)
    assert capsys.readouterr().out.replace("j.json", "t.json") == printed
    _assert_transforms_equal(got, want)
    assert all("sharpness" in f for f in got["frames"])
    _assert_transforms_equal(json.loads((tmp_path / "t.json").read_text()),
                             json.loads((tmp_path / "j.json").read_text()))


def _assert_transforms_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if k != "frames":
            assert got[k] == pytest.approx(want[k], rel=0, abs=TOL), k
    assert len(got["frames"]) == len(want["frames"])
    for g, w in zip(got["frames"], want["frames"]):
        assert g.keys() == w.keys()
        assert g["file_path"] == w["file_path"]
        assert g.get("sharpness") == w.get("sharpness")
        np.testing.assert_allclose(g["transform_matrix"], w["transform_matrix"],
                                   rtol=0, atol=TOL)


def test_colmap2nerf_cli_matches_jax(tmp_path):
    from nerf_kinematics_tpu.cli import colmap2nerf as jcli
    from nerf_kinematics_tpu_torch.cli import colmap2nerf as tcli

    model = tmp_path / "text"
    model.mkdir()
    _write_model(model, _orbit(np.zeros(3), 3.5, 8))
    images = _write_images(tmp_path / "images", 8)
    args = ["--images", str(images), "--text", str(model), "--aabb_scale", "4"]
    tcli.main(args + ["--out", str(tmp_path / "port.json")])
    jcli.main(args + ["--out", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    _assert_transforms_equal(got, want)
    assert got["aabb_scale"] == 4.0 and math.isclose(got["fl_x"], 40.0)
    tcli.main(args + ["--out", str(tmp_path / "ns.json"), "--no_sharpness",
                      "--keep_colmap_coords"])
    assert "sharpness" not in json.loads((tmp_path / "ns.json").read_text())["frames"][0]


def test_run_colmap_without_the_binary_exits_as_jax(tmp_path, monkeypatch):
    """``--run_colmap`` where no ``colmap`` binary is on the path: the same
    message as the JAX CLI's."""
    import shutil

    from nerf_kinematics_tpu.cli import colmap2nerf as jcli
    from nerf_kinematics_tpu_torch.cli import colmap2nerf as tcli

    monkeypatch.setattr(shutil, "which", lambda name: None)
    argv = ["--run_colmap", "--images", str(tmp_path), "--text", str(tmp_path / "t")]
    msgs = []
    for cli in (tcli, jcli):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "`colmap` binary is not installed" in msgs[0]


def test_run_colmap_calls_the_binary_as_jax(tmp_path, monkeypatch):
    """The four COLMAP commands, in order, with the JAX CLI's arguments."""
    import shutil
    import subprocess

    from nerf_kinematics_tpu.cli import colmap2nerf as jcli
    from nerf_kinematics_tpu_torch.cli import colmap2nerf as tcli

    monkeypatch.setattr(shutil, "which", lambda name: "/usr/bin/colmap")
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, check: calls.append(list(cmd)))
    argv = ["--images", str(tmp_path / "im"), "--text", str(tmp_path / "txt"),
            "--colmap_db", str(tmp_path / "db" / "c.db"), "--colmap_matcher", "sequential"]
    for cli in (tcli, jcli):
        cli.run_colmap_sfm(cli.build_parser().parse_args(argv))
    assert len(calls) == 8 and calls[:4] == calls[4:]
    assert [c[1] for c in calls[:4]] == ["feature_extractor", "sequential_matcher",
                                         "mapper", "model_converter"]
