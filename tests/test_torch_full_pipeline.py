"""The port's full pipeline (``cli/full_pipeline.py``: convert → diagnose →
train → video → mesh → report) against the JAX package's, at the sizes of
tests/test_full_pipeline.py (which skips here without the real wheel
capture), on captures these tests write: the same files, the JAX report's
keys (the port adds the video and mesh paths and the stages' seconds) and
the same parallax numbers, to the bit (the same numpy arithmetic)."""

import json
import os

import numpy as np
import pytest
import torch

from nerf_kinematics_tpu_torch.cli import full_pipeline
from nerf_kinematics_tpu_torch.export.mesh import load_ply
from test_torch_poses import ring_poses, slide_poses, write_capture

ARGS = ["--steps", "30", "--batch", "256", "--samples", "16", "--fine-samples", "0",
        "--downsample", "16", "--mesh-res", "24", "--video-frames", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_full_pipeline_matches_jax(tmp_path):
    """A JPEG ring capture of 13 poses (image 7 missing, as in the wheel
    capture): both pipelines write the same files; the port's report holds
    the JAX report's keys, the same parallax metrics and warning, a
    loadable PLY and the video it wrote."""
    from nerf_kinematics_tpu.cli.full_pipeline import main as jmain

    cap = write_capture(tmp_path / "cap", ring_poses(13), size=(160, 96), ext="jpg",
                        missing=(7,), seed=11, extra=1)
    out, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    rep = full_pipeline.main(["--capture", cap, "--out", out, "--device", "cpu", *ARGS])
    jrep = jmain(["--capture", cap, "--out", jout, *ARGS])

    for name in ("transforms.json", "transforms_val.json", "transforms_test.json",
                 "transforms_test_video.json", "parallax.json", "scene.ply", "report.json"):
        assert os.path.isfile(os.path.join(out, name)), name
        assert os.path.isfile(os.path.join(jout, name)), name
    assert rep["video"] and os.path.isfile(rep["video"])
    assert rep["video"].endswith((".gif", ".mp4"))
    on_disk = json.load(open(os.path.join(out, "report.json")))
    assert set(jrep) <= set(on_disk) and set(on_disk) - set(jrep) == {
        "video", "mesh", "stage_seconds"}
    assert set(on_disk["stage_seconds"]) == {"convert", "parallax", "train", "video", "mesh"}
    assert on_disk["parallax"] == jrep["parallax"]
    assert json.load(open(os.path.join(out, "parallax.json"))) == json.load(
        open(os.path.join(jout, "parallax.json")))
    assert on_disk["low_parallax_warning"] is jrep["low_parallax_warning"] is False
    assert on_disk["parallax"]["num_frames"] == 12 and on_disk["steps"] == 30
    assert np.isfinite(on_disk["val_psnr"])
    verts, tris = load_ply(os.path.join(out, "scene.ply"))
    assert verts.ndim == 2 and verts.shape[1] == 3 and tris.shape[1] == 3


def test_full_pipeline_png_slide_warns(tmp_path):
    """A PNG capture (no JPEG: the converter takes PNG, no Pillow needed)
    of the wheel's geometry trips the low-parallax warning; without video
    and mesh."""
    cap = write_capture(tmp_path / "cap", slide_poses(11), size=(160, 96), seed=12)
    out = str(tmp_path / "run")
    rep = full_pipeline.main(["--capture", cap, "--out", out, "--device", "cpu", *ARGS,
                              "--skip-video", "--skip-mesh"])
    assert rep["low_parallax_warning"] is True and rep["parallax"]["num_frames"] == 10
    assert rep["video"] is None and rep["mesh"] is None
    assert not os.path.exists(os.path.join(out, "scene.ply"))
    frames = json.load(open(os.path.join(out, "transforms.json")))["frames"]
    assert frames[0]["file_path"].endswith("TestNERF 1.png")
