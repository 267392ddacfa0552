"""The port's lens model, batch rays and 16-bit depth maps against the JAX
package, on the CPU.

``distort_normalized`` and ``get_ray_batch`` take the same float32 operations
in the same order as the JAX functions: held to 1e-6 relative (XLA may fuse a
multiply-add where PyTorch rounds twice). ``save_depth16`` writes through the
port's own PNG codec (the machine with the card has no Pillow); its file must
hold the same 16-bit samples as the JAX package's Pillow-written one (read
here by Pillow; the port's reader takes 8-bit files only).
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerf_kinematics_tpu.cameras import rays as jrays
from nerf_kinematics_tpu.io import image as jimage
from nerf_kinematics_tpu_torch.cameras import rays as trays
from nerf_kinematics_tpu_torch.io import image as timage

DISTS = {
    "none": None,
    "barrel": (-0.12, 0.03, 0.0, 0.0),
    "webcam": (0.08, -0.02, 0.0012, -0.0009),
}


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["barrel", "webcam"])
def test_distort_normalized_matches_jax(name):
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.8, 0.8, 200).astype(np.float32)
    y = rng.uniform(-0.6, 0.6, 200).astype(np.float32)
    k = DISTS[name]
    xd, yd = trays.distort_normalized(torch.from_numpy(x), torch.from_numpy(y), *k)
    jx, jy = jrays.distort_normalized(jnp.asarray(x), jnp.asarray(y), *k)
    _close(xd, jx)
    _close(yd, jy)
    # the port's undistortion inverts it
    ux, uy = trays.undistort_normalized(xd, yd, *k)
    _close(ux, x, atol=1e-5)
    _close(uy, y, atol=1e-5)


@pytest.mark.parametrize("name", sorted(DISTS))
@pytest.mark.parametrize("focal_y", [None, 61.5])
def test_get_ray_batch_matches_jax(name, focal_y):
    rng = np.random.default_rng(7)
    H, W = 48, 64
    pix = np.stack([rng.integers(0, H, 300), rng.integers(0, W, 300)], -1)
    pix = pix.astype(np.float32) + rng.uniform(0, 1, (300, 2)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.concatenate([q, rng.normal(size=(3, 1))], 1).astype(np.float32)
    args = (55.0, c2w, 31.5, 23.0)
    o, d = trays.get_ray_batch(torch.from_numpy(pix), *args, focal_y=focal_y,
                               dist=DISTS[name])
    jo, jd = jrays.get_ray_batch(pix, *args, focal_y=focal_y, dist=DISTS[name])
    assert o.shape == d.shape == (300, 3) and o.dtype == d.dtype == torch.float32
    _close(o, jo)
    _close(d, jd, atol=1e-5)
    # at whole pixels the batch is get_rays' grid
    ij = np.stack(np.meshgrid(np.arange(H), np.arange(W), indexing="ij"), -1)
    ob, db = trays.get_ray_batch(ij.reshape(-1, 2), *args, focal_y=focal_y,
                                 dist=DISTS[name])
    og, dg = trays.get_rays(H, W, 55.0, torch.from_numpy(c2w), 31.5, 23.0,
                            focal_y=focal_y, dist=DISTS[name])
    assert torch.equal(ob, og.reshape(-1, 3)) and torch.equal(db, dg.reshape(-1, 3))


@pytest.mark.parametrize("near_far", [(None, None), (2.0, 6.0), (3.0, 4.0)])
def test_save_depth16_matches_jax(tmp_path, near_far):
    rng = np.random.default_rng(11)
    depth = rng.uniform(1.5, 6.5, (37, 53)).astype(np.float32)
    depth[3, 4] = depth.min() - 1.0  # clipped below near where near is given
    near, far = near_far
    tp, jp = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    timage.save_depth16(tp, depth, near=near, far=far)
    jimage.save_depth16(jp, depth, near=near, far=far)
    with Image.open(jp) as im:
        want = np.asarray(im).astype(np.uint16)
    with Image.open(tp) as im:
        assert im.mode.startswith("I") and im.size == (53, 37)
        got = np.asarray(im).astype(np.uint16)
    assert np.array_equal(got, want)
    # the samples themselves, big-endian after the filter byte of each row
    data = open(tp, "rb").read()
    assert data[24:26] == bytes([16, 0])  # bit depth 16, gray
    raw = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:-16]), np.uint8)
    rows = raw.reshape(37, 1 + 53 * 2)
    assert (rows[:, 0] == 0).all()
    assert np.array_equal(rows[:, 1:].copy().view(">u2"), want)
