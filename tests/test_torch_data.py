"""The port's image codec, scene generator, loaders, dataset cache,
``Trainer(cfg)`` from disk and ``make_scene`` against Pillow and the JAX
package, on the CPU at tiny sizes.

Tolerances: the PNG codec and the loaders are exact (the same bytes decode
to the same pixels, the same float operations composite them); LANCZOS is
held to one 8-bit level of Pillow's (it computes Pillow's fixed-point sums,
and is exact on these images); the field's sigma to rtol 1e-4 / atol 1e-3
(sigma = 400 / (1 + exp(sdf / 0.005)) multiplies an SDF's last-bit
differences by up to 2e4) and renders to 1e-5 (the transcendental functions
of two libraries differ in their last bits). The files the two generators
write: alpha and RGB within one 8-bit level where a float lies on a rounding
boundary; RGBA color is un-premultiplied, so it is held as composited, within
two levels.
"""

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_kinematics_tpu.data import blender as jblender
from nerf_kinematics_tpu.data import cache as jcache
from nerf_kinematics_tpu.data import llff as jllff
from nerf_kinematics_tpu.data import machina as jmachina
from nerf_kinematics_tpu.data import machina_llff as jmachina_llff
from nerf_kinematics_tpu.train import config as jcfg
from nerf_kinematics_tpu_torch.data import LOADERS, load_dataset
from nerf_kinematics_tpu_torch.data import blender as tblender
from nerf_kinematics_tpu_torch.data import cache as tcache
from nerf_kinematics_tpu_torch.data import llff as tllff
from nerf_kinematics_tpu_torch.data import machina as tmachina
from nerf_kinematics_tpu_torch.data import machina_llff as tmachina_llff
from nerf_kinematics_tpu_torch.io import image as timage
from nerf_kinematics_tpu_torch.train import config as tcfg

SIZE, SAMPLES = 16, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _test_image(h=37, w=53, c=4, seed=0):
    """Smooth gradients plus noise: Pillow's adaptive filter then picks every
    row filter somewhere in the image."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(0.2 * x + k) * np.cos(0.15 * y - k) for k in range(c)], -1)
    img = 127.5 + 100.0 * base + rng.integers(-20, 21, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- PNG

@pytest.mark.parametrize("mode,channels", [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)])
def test_png_codec_against_pillow(mode, channels):
    img = _test_image(c=channels)
    arr = img[..., 0] if channels == 1 else img
    # the port writes, Pillow reads
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(timage.encode_png(arr)))), arr)
    # Pillow writes (a filter chosen per row), the port reads
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        buf = io.BytesIO()
        Image.fromarray(arr, mode).save(buf, format="PNG", **kw)
        got = timage.decode_png(buf.getvalue())
        assert np.array_equal(got.reshape(arr.shape), arr), kw


def test_png_reader_undoes_every_filter_and_reads_palettes():
    """Rows written with each of the five filters by hand, and a palette
    image with transparency; unsupported files raise."""
    import struct
    import zlib

    img = _test_image(h=10, w=7, c=3)
    H, W, C = img.shape
    flat = img.reshape(H, W * C).astype(np.int64)
    rows = []
    for y in range(H):
        ft = y % 5
        prev = flat[y - 1] if y else np.zeros(W * C, np.int64)
        left = np.concatenate([np.zeros(C, np.int64), flat[y, :-C]])
        upleft = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        pred = [np.zeros_like(prev), left, prev, (left + prev) // 2,
                timage._paeth(left, prev, upleft)][ft]
        rows.append(np.concatenate([[ft], (flat[y] - pred) & 255]).astype(np.uint8))
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    data = (timage._SIGNATURE + timage._chunk(b"IHDR", ihdr)
            + timage._chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes()))
            + timage._chunk(b"IEND", b""))
    assert np.array_equal(timage.decode_png(data), img)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    pal = Image.fromarray(img).convert("P")
    pal.info["transparency"] = 3
    buf = io.BytesIO()
    pal.save(buf, format="PNG", transparency=3)
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGBA"))
    assert np.array_equal(timage.decode_png(buf.getvalue()), want)
    buf = io.BytesIO()
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(buf, format="PNG")
    with pytest.raises(ValueError, match="8-bit"):
        timage.decode_png(buf.getvalue())


def test_save_and_load_image(tmp_path):
    img = _test_image(c=3).astype(np.float32) / 255.0
    path = str(tmp_path / "a.png")
    timage.save_image(path, img)
    want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(timage.load_image(path), want)
    # the same float -> 8-bit conversion as the reference's save_image
    np.testing.assert_array_equal(
        np.asarray(Image.open(path)), np.clip(img * 255.0, 0, 255).astype(np.uint8))
    gray = str(tmp_path / "g.png")
    timage.write_png(gray, _test_image(c=1)[..., 0])
    assert timage.load_image(gray).shape == (37, 53, 3)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(_test_image(c=3)).save(jpg)
    np.testing.assert_array_equal(
        timage.load_image(jpg), np.asarray(Image.open(jpg).convert("RGB"), np.float32) / 255.0)


@pytest.mark.parametrize("size", [(26, 18), (53, 37), (17, 5), (53, 12), (40, 60)])
@pytest.mark.parametrize("channels", [1, 3])
def test_lanczos_against_pillow(size, channels):
    img = _test_image(c=channels, seed=4)
    arr = img[..., 0] if channels == 1 else img
    want = np.asarray(Image.fromarray(arr).resize(size, Image.LANCZOS)).astype(int)
    got = timage.resize_lanczos(arr, *size).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


# ---------------------------------------------------------------- scene

def test_machina_field_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.1, 1.1, (4096, 3)).astype(np.float32)
    # on and near the parts: the plate, a stud, a wheel's teeth, the scoop
    pts[:4] = [[0.1, 0.1, -0.37], [0.0, 0.0, -0.345], [0.55, 0.68, -0.15], [0.88, 0.0, -0.17]]
    rgb_j, sig_j = jmachina.machina_field(jnp.asarray(pts))
    rgb_t, sig_t = tmachina.machina_field(torch.tensor(pts))
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4, atol=1e-3)
    # the part (hence the color) may only differ where two SDFs tie in their
    # last bits
    same = np.all(np.abs(rgb_t.numpy() - np.asarray(rgb_j)) <= 1e-5, axis=-1)
    assert same.mean() > 0.999
    assert (sig_t > 1.0).float().mean() > 0.05  # the sample sees the object


def test_render_view_matches_jax():
    c2w = jmachina.hemisphere_poses(2, seed=7)[1]
    focal = 0.5 * SIZE / np.tan(0.5 * jmachina.CAMERA_ANGLE_X)
    cj, aj = jmachina.render_view(c2w, SIZE, SIZE, focal, SAMPLES)
    ct, at = tmachina.render_view(c2w, SIZE, SIZE, focal, SAMPLES, device="cpu",
                                  chunk_rays=100)
    assert ct.shape == (SIZE, SIZE, 3) and at.shape == (SIZE, SIZE)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5, atol=1e-5)
    assert 0.05 < float(at.mean()) < 0.95


def test_poses_match_jax():
    np.testing.assert_array_equal(tmachina.hemisphere_poses(9, seed=8),
                                  jmachina.hemisphere_poses(9, seed=8))
    np.testing.assert_array_equal(tmachina.orbit_poses(5), jmachina.orbit_poses(5))
    np.testing.assert_array_equal(tmachina_llff.forward_facing_poses(6, seed=11),
                                  jmachina_llff.forward_facing_poses(6, seed=11))
    c2w = jmachina.orbit_poses(3)[1]
    np.testing.assert_array_equal(tmachina_llff.nerf_to_llff_pose(c2w, 16, 16, 20.0),
                                  jmachina_llff.nerf_to_llff_pose(c2w, 16, 16, 20.0))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Tiny datasets written by the JAX package and by the port."""
    root = tmp_path_factory.mktemp("scenes")
    kw = dict(resolution=SIZE, n_train=3, n_val=2, n_test=1, seed=7, n_samples=32)
    out = {
        "jax_blender": jmachina.write_machina_dataset(str(root / "jb"), **kw),
        "torch_blender": tmachina.write_machina_dataset(str(root / "tb"), device="cpu", **kw),
        "jax_llff": jmachina_llff.write_machina_llff_dataset(
            str(root / "jl"), resolution=SIZE, n_views=5, n_samples=32),
        "torch_llff": tmachina_llff.write_machina_llff_dataset(
            str(root / "tl"), resolution=SIZE, n_views=5, n_samples=32, device="cpu"),
    }
    return out


def _same_dataset(got, want):
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.poses, want.poses)
    for k in ("fl_x", "fl_y", "cx", "cy", "width", "height"):
        assert getattr(got.intrinsics, k) == getattr(want.intrinsics, k), k
    for k in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.near, got.far, got.use_ndc) == (want.near, want.far, want.use_ndc)
    np.testing.assert_allclose(got.render_poses, want.render_poses, rtol=0, atol=1e-6)


@pytest.mark.parametrize("half_res", [False, True], ids=["full", "half_res"])
@pytest.mark.parametrize("white", [True, False], ids=["white", "black"])
def test_load_blender_matches_jax(written, half_res, white):
    raw = {"basedir": written["jax_blender"], "type": "blender", "half_res": half_res}
    want = jblender.load_blender(jcfg.config_from_dict({"dataset": raw}).dataset, white)
    got = tblender.load_blender(tcfg.config_from_dict({"dataset": raw}).dataset, white)
    _same_dataset(got, want)
    assert got.images.shape == (6, SIZE // (2 if half_res else 1), SIZE // (2 if half_res else 1), 3)
    assert len(got.val_idx) == 2 and len(got.test_idx) == 1


@pytest.mark.parametrize("ndc,factor", [(True, 1), (False, 2)], ids=["ndc", "no_ndc-factor2"])
def test_load_llff_matches_jax(written, ndc, factor):
    raw = {"basedir": written["jax_llff"], "type": "llff", "no_ndc": not ndc,
           "downsample_factor": factor, "llffhold": 2}
    want = jllff.load_llff(jcfg.config_from_dict({"dataset": raw}).dataset)
    got = tllff.load_llff(tcfg.config_from_dict({"dataset": raw}).dataset)
    _same_dataset(got, want)


def test_port_writes_what_the_reference_writes(written):
    """Same files, same frames and poses; pixels within one 8-bit level."""
    for kind, split_files in (("blender", ["transforms_train.json", "transforms_val.json",
                                           "transforms_test.json", ".machina.json"]),
                              ("llff", ["poses_bounds.npy", ".machina_llff.json"])):
        j, t = written[f"jax_{kind}"], written[f"torch_{kind}"]
        for name in split_files:
            a, b = os.path.join(j, name), os.path.join(t, name)
            if name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(b), np.load(a))
            else:
                with open(a) as fa, open(b) as fb:
                    assert json.load(fb) == json.load(fa), name
        pngs = sorted(os.path.relpath(os.path.join(d, f), j)
                      for d, _, fs in os.walk(j) for f in fs if f.endswith(".png"))
        assert len(pngs) == (6 if kind == "blender" else 5)
        for rel in pngs:
            a = np.asarray(Image.open(os.path.join(j, rel))).astype(int)
            b = timage.read_png(os.path.join(t, rel)).astype(int)
            # RGBA: the color is un-premultiplied, so where alpha is a few
            # levels its last-bit differences grow; held as composited
            # (below), alpha itself within one level
            assert a.shape == b.shape and np.abs(a - b)[..., -1].max() <= 1, rel
            if kind == "llff":
                assert np.abs(a - b).max() <= 1, rel
    raw = lambda d: tcfg.config_from_dict({"dataset": {"basedir": d}}).dataset
    want = tblender.load_blender(raw(written["jax_blender"]), True).images
    got = tblender.load_blender(raw(written["torch_blender"]), True).images
    assert np.abs(got - want).max() <= 2.0 / 255.0
    # idempotent: a matching marker renders nothing
    before = os.path.getmtime(os.path.join(written["torch_blender"], "train", "r_0.png"))
    tmachina.write_machina_dataset(written["torch_blender"], resolution=SIZE, n_train=3,
                                   n_val=2, n_test=1, seed=7, n_samples=32, device="cpu")
    assert os.path.getmtime(os.path.join(written["torch_blender"], "train", "r_0.png")) == before


def test_dataset_cache_round_trip(written, tmp_path):
    raw = {"basedir": written["jax_blender"], "type": "blender",
           "cachedir": str(tmp_path / "cache")}
    tc = tcfg.config_from_dict({"dataset": raw}).dataset
    first = load_dataset(tc, white_background=True)
    path = tcache.cache_path(tc, extra={"white_background": True})
    assert os.path.isfile(path)
    # the same key as the reference's: either package reads the other's file
    jc = jcfg.config_from_dict({"dataset": raw}).dataset
    assert path == jcache.cache_path(jc, extra={"white_background": True})
    again = load_dataset(tc, white_background=True)
    _same_dataset(again, first)
    _same_dataset(jcache.load_cached(path), first)
    assert tcache.load_cached(str(tmp_path / "missing.npz")) is None
    # the robot loader is ported: a capture's poses.txt and indexed images
    from test_torch_poses import slide_poses, write_capture

    cap = write_capture(tmp_path / "capture", slide_poses(10), size=(16, 8), seed=1)
    rob = LOADERS["robot"](tc.__class__(type="robot", basedir=cap, downsample_factor=2))
    assert rob.images.shape == (10, 4, 8, 3) and list(rob.val_idx) == [0, 8]
    assert rob.render_poses.shape == (60, 4, 4) and rob.use_ndc is False
    # the synthetic scenes are ported: the sphere at the config's near / far
    syn = LOADERS["synthetic"](tc.__class__(type="synthetic", near=0.5, far=3.5),
                               n_views=3, resolution=8, device="cpu")
    assert syn.images.shape == (3, 8, 8, 3) and (syn.near, syn.far) == (0.5, 3.5)
    # the ngp loader is ported: the blender scene's train JSON gives the
    # blender loader's train views (both composite onto white)
    ngp = LOADERS["ngp"](tc.__class__(
        type="ngp", basedir=os.path.join(written["jax_blender"], "transforms_train.json")))
    np.testing.assert_array_equal(ngp.images, first.images[first.train_idx])
    np.testing.assert_array_equal(ngp.poses, first.poses[first.train_idx])
    with pytest.raises(ValueError, match="unknown dataset type"):
        load_dataset(tc.__class__(type="colmap"))


def test_trainer_loads_its_dataset_from_basedir(written, tmp_path):
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    raw = {
        "engine": "ngp",
        "ngp": {"encoder": "cp_pallas", "n_levels": 2, "n_components": 8,
                "table_size": 32, "base_resolution": 8, "max_resolution": 32,
                "density_width": 16, "density_out": 16, "color_width": 16,
                "color_layers": 2, "use_occupancy": True, "occ_resolution": 16,
                "occ_bins": 8, "fused_train": "full", "occ_update_every": 4},
        "dataset": {"basedir": written["torch_blender"], "type": "blender",
                    "half_res": True},
        "experiment": {"logdir": str(tmp_path), "id": "disk", "print_every": 0,
                       "validate_every": 0, "save_every": 0, "train_iters": 4},
        "nerf": {"train": {"num_coarse": 8, "num_fine": 6, "white_background": True,
                           "num_random_rays": 128},
                 "validation": {"num_coarse": 8, "num_fine": 6, "perturb": False,
                                "white_background": True},
                 "coarse_loss_weight": 0.0},
    }
    cfg = tcfg.config_from_dict(raw)
    tr = Trainer(cfg, device="cpu")
    want = load_dataset(cfg.dataset, white_background=True)
    _same_dataset(tr.dataset, want)
    assert tr.images.shape == (3, SIZE // 2, SIZE // 2, 3)
    res = tr.fit()
    assert len(res.losses) == 4 and np.isfinite(res.losses).all()
    assert tr.engine.fused_objective_fn(2.0, 6.0, cfg.nerf.train).__name__ == "objective_full"
    tr.close()


@pytest.mark.parametrize("fmt", ["blender", "llff"])
def test_make_scene_cli(fmt, tmp_path, capsys):
    from nerf_kinematics_tpu_torch.cli import make_scene

    out = str(tmp_path / fmt)
    make_scene.main(["--out", out, "--resolution", "8", "--views", "3", "--val", "1",
                     "--test", "1", "--samples", "16", "--format", fmt,
                     "--device", "cpu"])
    assert f"machina dataset at {out}" in capsys.readouterr().out
    cfg = tcfg.config_from_dict({"dataset": {"basedir": out, "type": fmt,
                                             "llffhold": 2}}).dataset
    ds = load_dataset(cfg, white_background=True)
    assert ds.images.shape[1:] == (8, 8, 3) and np.isfinite(ds.images).all()
    assert len(ds.images) == (5 if fmt == "blender" else 3)
