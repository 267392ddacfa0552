"""The port's parallax analysis (``metrics/parallax.py``) against the JAX
package's: tests/test_parallax.py on captures these tests write (the real
wheel capture's golden directional_std, 0.13272, waits for the capture).
The same float64 numpy arithmetic: metrics equal to the bit, tables equal
as strings."""

import json
import os

import numpy as np

from nerf_kinematics_tpu.metrics import parallax as jpar
from nerf_kinematics_tpu.poses.pipeline import convert_poses as jconvert
from nerf_kinematics_tpu_torch.metrics.parallax import (
    analyze_poses,
    analyze_transforms_json,
    main,
    plot_pose_clouds,
    summary_table,
)
from nerf_kinematics_tpu_torch.poses.orbit import generate_orbit_poses
from nerf_kinematics_tpu_torch.poses.pipeline import convert_poses
from test_torch_poses import ring_poses, slide_poses, write_capture


def _train_poses(tmp_path, world, name):
    cap = write_capture(tmp_path / name, world, size=(24, 16), seed=8)
    res = convert_poses(poses_path=os.path.join(cap, "poses.txt"),
                        image_folder=os.path.join(cap, "images_robot"), image_ext="png",
                        recenter=True, scale_trans=1.0, output=None, with_sharpness=False)
    return np.asarray([f["transform_matrix"] for f in res.train["frames"]])


def test_slide_capture_reads_low_parallax(tmp_path):
    """The wheel capture's geometry (12 poses on a line, looking down) reads
    under the pipeline's 0.3 warning line; the same metrics as JAX."""
    poses = _train_poses(tmp_path, slide_poses(12), "slide")
    m = analyze_poses(poses, "slide")
    assert m.num_frames == 11
    assert m.directional_std < 0.3
    assert m.as_dict() == jpar.analyze_poses(poses, "slide").as_dict()


def test_low_vs_high_parallax_discrimination(tmp_path):
    """An orbit capture scores far higher directional diversity than the
    near-planar slide."""
    slide = _train_poses(tmp_path, slide_poses(12), "slide")
    orbit = generate_orbit_poses(np.zeros(3), radius=2.0, n_poses=12).numpy()
    m_slide = analyze_poses(slide, "wheel")
    m_orbit = analyze_poses(orbit, "orbit")
    assert m_orbit.directional_std > 3 * max(m_slide.directional_std, 1e-3)
    assert m_orbit.directional_std > 0.3
    assert m_orbit.mean_distance > m_slide.mean_distance * 0.5
    assert 0 < m_slide.spatial_range <= 1.0 + 1e-9
    for poses, label in ((slide, "wheel"), (orbit, "orbit")):
        assert analyze_poses(poses, label).as_dict() == jpar.analyze_poses(
            poses, label).as_dict()


def test_analyze_transforms_json(tmp_path):
    """The converter's transforms.json read back, against the JAX
    converter's file read by the JAX analysis."""
    cap = write_capture(tmp_path / "ring", ring_poses(13), size=(24, 16), seed=9)
    kw = dict(poses_path=os.path.join(cap, "poses.txt"),
              image_folder=os.path.join(cap, "images_robot"), image_ext="png",
              recenter=True, with_sharpness=False)
    convert_poses(output=str(tmp_path / "t.json"), **kw)
    jconvert(output=str(tmp_path / "j.json"), **kw)
    m = analyze_transforms_json(str(tmp_path / "t.json"), "ring")
    assert m.num_frames == 12 and m.directional_std > 0.3
    assert m.as_dict() == jpar.analyze_transforms_json(
        str(tmp_path / "j.json"), "ring").as_dict()
    # test-orbit frames carry transform_matrix_start
    t = analyze_transforms_json(str(tmp_path / "t_test.json"))
    assert t.num_frames == 8
    assert t.as_dict() == jpar.analyze_transforms_json(
        str(tmp_path / "j_test.json"), str(tmp_path / "t_test.json")).as_dict()


def test_summary_table_and_plot(tmp_path, capsys):
    orbit = generate_orbit_poses(np.zeros(3), 2.0, 8).numpy()
    ring2 = generate_orbit_poses(np.ones(3), 1.0, 6).numpy()
    ms = [analyze_poses(orbit, "a"), analyze_poses(ring2, "b")]
    table = summary_table(ms)
    assert "directional_std" in table and "a" in table and "b" in table
    assert table == jpar.summary_table([jpar.analyze_poses(orbit, "a"),
                                        jpar.analyze_poses(ring2, "b")])
    # the command line prints the same table
    path = tmp_path / "transforms.json"
    path.write_text(json.dumps({"frames": [{"transform_matrix": p.tolist()} for p in orbit]}))
    main([str(path)])
    assert capsys.readouterr().out.strip() == summary_table(
        [analyze_transforms_json(str(path))]).strip()
    out = str(tmp_path / "paralaje.png")
    plot_pose_clouds([("a", orbit), ("b", ring2)], out)
    assert os.path.getsize(out) > 1000
