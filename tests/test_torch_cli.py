"""The port's command lines, loader and bench on the CPU, against the JAX
package's (``tests/test_ngp_cli.py``, ``tests/test_trainer_cli.py``,
``tests/test_cli_entries.py``):

  * ``data/ngp_transforms.py`` against the JAX loader on a scene with
    extension-less paths, RGBA / gray + alpha / RGB / palette / JPEG images,
    a drifting rotation, ``_val`` and ``_test_video`` JSONs: images exactly;
  * ``cli/run_nerf.py``: train -> validate -> checkpoint -> resume, ``--eval``
    (from a step and from a legacy ``.ckpt``), ``--render-video`` (the
    standard and the ``--fast`` renderer), a silent run, ``plot_metrics``;
  * ``cli/ngp_run.py``: train -> snapshot -> reload -> ``--test_transforms``
    -> screenshots, ``--save_mesh`` to a PLY that loads back, ``--encoder
    hash`` through a snapshot and back, the ``--config`` step budget;
  * the whole slice: a snapshot the JAX package writes from its engine's
    initial state, read by both packages' ``ngp_run --load_snapshot
    --test_transforms``: per-frame PSNRs within 0.05 dB (f32 operands);
  * every command line and the bench raise without a GPU unless told
    ``--device cpu``.

Scenes come from the port's ``cli/make_scene --device cpu`` at 16 px."""

import json
import os
import re

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from nerf_kinematics_tpu.data import ngp_transforms as jngp
from nerf_kinematics_tpu_torch.cli import ngp_run, run_nerf
from nerf_kinematics_tpu_torch.data import ngp_transforms as tngp
from nerf_kinematics_tpu_torch.train import config as tcfg

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small CPU ops: several intra-op threads per test worker only
    fight over the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from nerf_kinematics_tpu_torch.cli import make_scene

    out = str(tmp_path_factory.mktemp("cli") / "machina")
    make_scene.main(["--out", out, "--resolution", str(SIZE), "--views", "6", "--val", "2",
                     "--test", "3", "--samples", "32", "--device", "cpu"])
    return out


def _write_yaml(path, raw) -> str:
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


CLASSIC_NET = {"num_layers": 4, "hidden_size": 16, "skip_connect_every": 3,
               "num_encoding_fn_xyz": 4, "num_encoding_fn_dir": 2}
NGP = {"encoder": "cp_pallas", "n_levels": 2, "n_components": 8, "table_size": 32,
       "base_resolution": 8, "max_resolution": 32, "density_width": 16,
       "density_out": 16, "color_width": 16, "color_layers": 2, "use_occupancy": True,
       "occ_resolution": 16, "occ_bins": 8, "occ_update_every": 4}


def _classic_raw(scene, logdir, **exp):
    return {
        "dataset": {"basedir": scene, "type": "blender", "near": 2, "far": 6,
                    "no_ndc": True, "testskip": 1},
        "experiment": {"id": "classic", "logdir": logdir, "train_iters": 12,
                       "save_every": 6, "validate_every": 6, "print_every": 6,
                       "randomseed": 42, **exp},
        "models": {"coarse": dict(CLASSIC_NET), "fine": dict(CLASSIC_NET)},
        "nerf": {"train": {"num_coarse": 8, "num_fine": 8, "num_random_rays": 64,
                           "perturb": True, "white_background": True},
                 "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False,
                                "white_background": True}},
        "optimizer": {"lr": 0.005, "type": "Adam"},
        "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
    }


def _ngp_raw(scene, logdir, run_id="ngp", ngp=None, steps=16):
    return {
        "engine": "ngp", "ngp": dict(NGP, **(ngp or {})),
        "dataset": {"basedir": scene, "type": "blender", "near": 2.0, "far": 6.0},
        "experiment": {"id": run_id, "logdir": logdir, "train_iters": steps,
                       "save_every": 8, "validate_every": 0, "print_every": 8},
        "nerf": {"train": {"num_coarse": 8, "num_fine": 8, "white_background": True,
                           "num_random_rays": 128},
                 "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False,
                                "white_background": True},
                 "coarse_loss_weight": 0.0},
        "optimizer": {"lr": 0.01}, "scheduler": {"lr_decay": 50, "lr_decay_factor": 0.33},
    }


# ------------------------------------------------------------ the ngp loader

@pytest.fixture(scope="module")
def ngp_scene(tmp_path_factory):
    """A transforms.json scene in the layouts the loader resolves."""
    root = tmp_path_factory.mktemp("ngp_scene")
    rng = np.random.default_rng(5)
    (root / "images").mkdir()
    (root / "held").mkdir()
    u8 = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)
    Image.fromarray(u8(12, 10, 4), "RGBA").save(root / "images" / "im_0.png")
    Image.fromarray(u8(12, 10, 2), "LA").save(root / "images" / "im_1.png")
    Image.fromarray(u8(12, 10, 3), "RGB").save(root / "im_2.png")
    Image.fromarray(u8(12, 10, 3), "RGB").save(root / "images" / "im_3.jpg", quality=90)
    pal = Image.fromarray(u8(12, 10) % 7, "P")
    pal.putpalette(list(u8(7 * 3)))
    pal.info["transparency"] = bytes([255, 0, 128, 255, 255, 255, 7])
    pal.save(root / "images" / "im_4.png", transparency=bytes([255, 0, 128, 255, 255, 255, 7]))
    Image.fromarray(u8(12, 10, 4), "RGBA").save(root / "held" / "v_0.png")

    def pose(i, scale=1.0):
        c, s = np.cos(0.3 * i), np.sin(0.3 * i)
        m = np.array([[c, 0, s, 4 * s], [0, 1, 0, 0.5], [-s, 0, c, 4 * c], [0, 0, 0, 1]])
        m[:3, :3] *= scale
        return m.tolist()

    frames = [{"file_path": "./images/im_0", "transform_matrix": pose(0)},   # no extension
              {"file_path": "images/im_1.png", "transform_matrix": pose(1, 1.02)},  # drifts
              {"file_path": "elsewhere/im_2.png", "transform_matrix": pose(2)},  # basename
              {"file_path": "./images/im_3", "transform_matrix": pose(3)},  # a JPEG
              {"file_path": "./images/im_4.png", "transform_matrix": pose(4)},  # palette
              {"file_path": "./images/missing", "transform_matrix": pose(5)}]  # skipped
    base = {"camera_angle_x": 0.7, "aabb_scale": 2, "k1": 0.01}
    (root / "transforms.json").write_text(json.dumps(dict(base, frames=frames)))
    (root / "transforms_val.json").write_text(json.dumps(dict(
        base, frames=[{"file_path": "held/v_0.png", "transform_matrix": pose(6)}])))
    (root / "transforms_test_video.json").write_text(json.dumps(dict(
        base, frames=[{"transform_matrix_start": pose(i)} for i in range(3)])))
    return root


def test_ngp_loader_matches_the_jax_package(ngp_scene):
    from nerf_kinematics_tpu.train import config as jcfg

    raw = {"dataset": {"basedir": str(ngp_scene), "type": "ngp", "near": 1.0, "far": 5.0}}
    want = jngp.load_ngp_transforms(jcfg.config_from_dict(raw).dataset)
    got = tngp.load_ngp_transforms(tcfg.config_from_dict(raw).dataset)
    assert got.images.shape == (6, 12, 10, 3) and got.images.dtype == np.float32
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)
    np.testing.assert_array_equal(got.render_poses, want.render_poses)
    np.testing.assert_array_equal(got.train_idx, want.train_idx)
    np.testing.assert_array_equal(got.val_idx, want.val_idx)
    for f in ("fl_x", "fl_y", "cx", "cy", "width", "height", "k1", "k2", "p1", "p2"):
        assert getattr(got.intrinsics, f) == getattr(want.intrinsics, f), f
    assert (got.near, got.far, got.aabb_scale, got.use_ndc) == \
        (want.near, want.far, want.aabb_scale, want.use_ndc)
    assert abs(np.linalg.det(got.poses[1, :3, :3]) - 1.0) < 1e-5
    # a JSON without images: poses only, as the reference gives them
    _, p, intr, aabb = tngp.load_transforms_json(
        str(ngp_scene / "transforms_test_video.json"), require_images=False)
    _, jp, jintr, jaabb = jngp.load_transforms_json(
        str(ngp_scene / "transforms_test_video.json"), require_images=False)
    np.testing.assert_array_equal(p, jp)
    assert (intr.width, aabb) == (jintr.width, jaabb) == (0, 2.0)


def test_ngp_loader_reads_the_blender_layout(scene):
    """The port's blender scene through the ngp loader: the blender loader's
    train views (both composite onto white)."""
    from nerf_kinematics_tpu_torch.data import load_dataset

    ds = load_dataset(tcfg.config_from_dict(
        {"dataset": {"basedir": os.path.join(scene, "transforms_train.json"),
                     "type": "ngp", "near": 2.0, "far": 6.0}}).dataset)
    bl = load_dataset(tcfg.config_from_dict({"dataset": {"basedir": scene}}).dataset,
                      white_background=True)
    np.testing.assert_array_equal(ds.images, bl.images[bl.train_idx])
    assert len(ds.val_idx) == 0 and ds.intrinsics.fl_x == bl.intrinsics.fl_x


# ------------------------------------------------------------ run_nerf

def test_run_nerf_train_validate_checkpoint_resume(scene, tmp_path, capsys):
    from nerf_kinematics_tpu_torch.io.torch_compat import import_legacy_checkpoint
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    cfg_path = _write_yaml(tmp_path / "classic.yml", _classic_raw(scene, str(tmp_path / "logs")))
    res = run_nerf.main(["--config", cfg_path, "--export-legacy", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final val_psnr=" in out and "throughput=" in out
    assert res["step"] == 12 and np.isfinite(res["val_psnr"])
    rundir = str(tmp_path / "logs" / "classic")
    assert os.path.isfile(os.path.join(rundir, "metrics.jsonl"))
    assert os.path.isfile(os.path.join(rundir, "checkpoint12.ckpt"))
    assert import_legacy_checkpoint(os.path.join(rundir, "checkpoint12.ckpt"))["step"] == 12

    # resume: a fresh trainer picks up at 12 and continues to 15
    tr = Trainer(tcfg.load_config(cfg_path), device="cpu")
    assert tr.ckpt.latest_step() == 12
    state = tr.init_or_resume()
    assert int(state.step) == 12
    assert int(tr.fit(max_iters=15).state.step) == 15
    tr.close()

    # --eval: the latest checkpoint (15); a step; the legacy file of step 12
    ev = run_nerf.main(["--config", cfg_path, "--eval", "--device", "cpu"])
    assert "val_psnr=" in capsys.readouterr().out and np.isfinite(ev["val_psnr"])
    at12 = run_nerf.main(["--config", cfg_path, "--eval", "--load-checkpoint", "12",
                          "--device", "cpu"])
    assert at12["val_psnr"] == pytest.approx(res["val_psnr"], abs=1e-9)
    legacy = run_nerf.main(["--config", cfg_path, "--eval", "--device", "cpu",
                            "--load-checkpoint", os.path.join(rundir, "checkpoint12.ckpt")])
    assert legacy["val_psnr"] == pytest.approx(res["val_psnr"], abs=1e-5)
    from nerf_kinematics_tpu_torch.io.image import read_png

    pair = [read_png(os.path.join(rundir, "imgs", d, "val_0.png")) for d in ("rendered", "reals")]
    assert pair[0].shape == pair[1].shape == (SIZE, SIZE, 3)

    # --render-video: PNG frames and a video (mp4 with ffmpeg, else a GIF)
    vid = run_nerf.main(["--config", cfg_path, "--render-video", "--device", "cpu"])
    assert "fps render" in capsys.readouterr().out
    assert vid["frames"] == 40 and vid["fps"] > 0 and os.path.getsize(vid["video"]) > 0
    assert len([f for f in os.listdir(vid["outdir"]) if f.startswith("frame_")]) == 40
    with pytest.raises(SystemExit):
        run_nerf.main(["--config", cfg_path, "--render-video", "--fast", "--device", "cpu"])
    # --mesh without a process group is the single-device path, to the bit
    runs = []
    for i, flags in enumerate(([], ["--mesh"])):
        path = _write_yaml(tmp_path / f"m{i}.yml", _classic_raw(scene, str(tmp_path / f"m{i}")))
        runs.append(run_nerf.main(["--config", path, "--max-iters", "6", "--device", "cpu",
                                   *flags]))
    assert runs[0]["step"] == runs[1]["step"] == 6
    assert runs[1]["val_psnr"] == runs[0]["val_psnr"] and np.isfinite(runs[0]["val_psnr"])


def test_run_nerf_silent_run_and_plot_metrics(scene, tmp_path, capsys):
    from nerf_kinematics_tpu_torch.cli.plot_metrics import main as plot_main

    silent = _write_yaml(tmp_path / "silent.yml", _classic_raw(
        scene, str(tmp_path / "logs"), print_every=0, validate_every=0, save_every=0))
    res = run_nerf.main(["--config", silent, "--max-iters", "5", "--device", "cpu"])
    assert res["step"] == 5 and res["val_psnr"] is None and res["rays_per_sec"] is None
    cfg_path = _write_yaml(tmp_path / "c.yml", _classic_raw(
        scene, str(tmp_path / "logs2"), print_every=3, validate_every=3))
    run_nerf.main(["--config", cfg_path, "--max-iters", "6", "--device", "cpu"])
    pytest.importorskip("matplotlib")
    written = plot_main([str(tmp_path / "logs2" / "classic")])
    assert f"wrote {len(written)} plots" in capsys.readouterr().out
    files = set(os.listdir(tmp_path / "logs2" / "classic" / "loss"))
    assert {"train_loss.png", "train_psnr.png", "val_loss.png", "val_psnr.png",
            "perf_rays_per_sec.png", "val_psnr_mean.png"} == files == set(written)


# ------------------------------------------------------------ ngp_run

def test_ngp_run_train_snapshot_reload_and_screenshots(scene, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = _write_yaml(tmp_path / "ngp.yml", _ngp_raw(scene, str(tmp_path / "logs")))
    train_json = os.path.join(scene, "transforms_train.json")
    val_json = os.path.join(scene, "transforms_val.json")
    snap = str(tmp_path / "model.nktsnap")
    first = ngp_run.main([train_json, "--config", cfg_path, "--n_steps", "16",
                          "--save_snapshot", snap, "--test_transforms", val_json,
                          "--mode", "nerf", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "no longer in use" in out and "mean psnr" in out and os.path.isfile(snap)
    # reload: the same PSNR to the last bit (weights and grid in the file)
    again = ngp_run.main([train_json, "--config", cfg_path, "--load_snapshot", snap,
                          "--test_transforms", val_json, "--device", "cpu",
                          "--screenshot_transforms", os.path.join(scene, "transforms_test.json"),
                          "--screenshot_dir", str(tmp_path / "shots"), "--width", "24",
                          "--height", "20"])
    assert "Loaded snapshot" in capsys.readouterr().out
    assert again["test_psnr"] == first["test_psnr"]
    from nerf_kinematics_tpu_torch.io.image import read_png

    shots = sorted(os.listdir(tmp_path / "shots"))
    assert shots == ["r_0.png", "r_1.png", "r_2.png"]
    assert read_png(str(tmp_path / "shots" / "r_0.png")).shape == (20, 24, 3)

    # run_nerf's fast video from the run ngp_run trained (its checkpoint)
    fast_cfg = _write_yaml(tmp_path / "fast.yml",
                           _ngp_raw(scene, str(tmp_path / "logs"), run_id="ngp-transforms_train"))
    vid = run_nerf.main(["--config", fast_cfg, "--render-video", "--fast",
                         "--load-checkpoint", "16", "--device", "cpu"])
    assert "[fast]" in capsys.readouterr().out and vid["frames"] == 40

    # the demo hyperparameters, without --config
    demo = ngp_run.main([train_json, "--n_steps", "2", "--batch", "128", "--samples", "8",
                         "--fine-samples", "8", "--device", "cpu"])
    assert demo == {}
    assert os.path.isdir(tmp_path / "logs" / "ngp-transforms_train")

    # --save_mesh from the snapshot: the PLY loads back to what was printed
    from nerf_kinematics_tpu_torch.export.mesh import load_ply

    ply = str(tmp_path / "m.ply")
    mesh = ngp_run.main([train_json, "--config", cfg_path, "--load_snapshot", snap,
                         "--save_mesh", ply, "--marching_cubes_res", "24",
                         "--marching_cubes_density_thresh", "1.9", "--device", "cpu"])
    assert "Saved mesh" in capsys.readouterr().out
    verts, tris = load_ply(ply)
    assert mesh["mesh"] == (len(verts), len(tris)) and len(tris) > 0
    assert np.abs(verts).max() <= 1.0 + 1e-6  # the scene box

    # --encoder hash without --config: the reference-exact hash grid,
    # through a snapshot and back
    hsnap = str(tmp_path / "hash.nktsnap")
    demo = ["--encoder", "hash", "--batch", "128", "--samples", "8", "--fine-samples", "8",
            "--test_transforms", val_json, "--device", "cpu"]
    hashed = ngp_run.main([train_json, "--n_steps", "2", "--save_snapshot", hsnap, *demo])
    from nerf_kinematics_tpu_torch.io.snapshot import load_snapshot

    payload, _ = load_snapshot(hsnap)
    assert payload["params"]["coarse"]["params"]["hash_table"].shape == (8, 1 << 19, 4)
    back = ngp_run.main([train_json, "--load_snapshot", hsnap, *demo])
    assert back["test_psnr"] == hashed["test_psnr"]


def test_config_flag_keeps_yaml_step_budget(scene, tmp_path):
    """--config supplies the whole recipe: without --n_steps the YAML's
    train_iters survives, and --n_steps still overrides it."""
    cfg_path = _write_yaml(tmp_path / "recipe.yml", _ngp_raw(scene, str(tmp_path), steps=77))
    args = lambda *a: ngp_run.build_parser().parse_args([scene, "--config", cfg_path, *a])
    assert ngp_run.make_config(args()).experiment.train_iters == 77
    assert ngp_run.make_config(args("--n_steps", "5")).experiment.train_iters == 5
    c = ngp_run.make_config(args())
    assert (c.dataset.type, c.dataset.basedir, c.engine) == ("ngp", scene, "ngp")
    assert c.nerf.num_random_rays == 128  # the YAML's, not --batch's
    demo = ngp_run.make_config(ngp_run.build_parser().parse_args([scene]))
    assert demo.experiment.train_iters == 1 and demo.nerf.num_random_rays == 4096


# ------------------------------------------------------------ the whole slice

def test_a_jax_snapshot_scores_the_same_in_both_packages(scene, tmp_path, capsys,
                                                          monkeypatch):
    """The JAX engine's initial state at a tiny f32 config, saved by the JAX
    package, loaded by both ``ngp_run --load_snapshot --test_transforms``."""
    import jax

    from nerf_kinematics_tpu.cli import ngp_run as jngp_run
    from nerf_kinematics_tpu.io.snapshot import save_snapshot as j_save
    from nerf_kinematics_tpu.train.loop import eval_params as j_eval_params

    monkeypatch.setenv("NERF_KINEMATICS_NO_COMPILE_CACHE", "1")
    raw = _ngp_raw(scene, str(tmp_path / "logs"),
                   ngp={"encoder": "cp", "use_occupancy": False})
    cfg_path = _write_yaml(tmp_path / "f32.yml", raw)
    train_json = os.path.join(scene, "transforms_train.json")
    val_json = os.path.join(scene, "transforms_val.json")
    argv = [train_json, "--config", cfg_path]
    jtrainer = jngp_run._make_trainer(jngp_run.build_parser().parse_args(argv))
    state = jtrainer.engine.init_state(3)
    snap = str(tmp_path / "jax.nktsnap")
    j_save(snap, {"params": jax.device_get(j_eval_params(state))}, {"step": 0, "engine": "ngp"})

    jngp_run.main(argv + ["--load_snapshot", snap, "--test_transforms", val_json])
    printed = capsys.readouterr().out
    want = [float(v) for v in re.findall(r"frame \d+: psnr ([-\d.]+) dB", printed)]
    got = ngp_run.main(argv + ["--load_snapshot", snap, "--test_transforms", val_json,
                               "--device", "cpu"])["test_psnr"]
    assert len(want) == len(got) == 2
    # the JAX CLI prints two decimals
    np.testing.assert_allclose(got, want, atol=0.05 + 0.005)


# ------------------------------------------------------------ the GPU by default

def test_every_entry_point_asks_for_the_gpu(scene, tmp_path, monkeypatch):
    from nerf_kinematics_tpu_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    classic = _write_yaml(tmp_path / "c.yml", _classic_raw(scene, str(tmp_path / "logs")))
    train_json = os.path.join(scene, "transforms_train.json")
    for call in (lambda: run_nerf.main(["--config", classic]),
                 lambda: run_nerf.main(["--config", classic, "--eval"]),
                 lambda: ngp_run.main([train_json, "--n_steps", "1"]),
                 lambda: bench.main(["--data", scene])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(tmp_path / "logs")


def test_bench_on_the_cpu(scene, capsys):
    """``--device cpu``: the JAX bench's CPU scale, one JSON line, MFU null."""
    from nerf_kinematics_tpu_torch import bench

    out = bench.main(["--device", "cpu", "--data", scene])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert out["metric"] == "train_rays_per_sec_per_chip" and out["unit"] == "rays/s"
    assert out["value"] > 0 and out["samples_per_ray"] == 32
    assert out["mfu_hw_pct"] is None and out["mfu_useful_pct"] is None
    assert out["time_to_25db_s"] is None and out["device"] == "cpu"
    assert out["scene"]["resolution"] == SIZE
    assert out["vs_baseline"] == pytest.approx(out["samples_per_sec_per_chip"] / (56.78 * 262144))
