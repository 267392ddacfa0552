"""Robot FK-capture loader (``dataset.type: robot``) — the author's custom
dataset for the wheel capture.

Reads ``poses.txt`` (bracket-and-semicolon 4x4 FK matrices) + an image folder
straight from a capture directory, runs the pose-normalization pipeline
(recenter to train centroid, unit max radius, Z-flip — the same path the
converter CLI uses), downsamples by ``downsample_factor``, and splits
validation every ``llffhold``-th frame (config surface:
trained_models/nerf-pytorch/wheel_robot6/config.yml:1-8 — basedir,
downsample_factor: 8, llffhold: 8, near: 0, far: 1, type: robot).

Intrinsics default to the RealSense D405 FOV (87°x58°) used by the capture
rig (README.md:46-49): on a non-square image fl_x and fl_y differ.

Counterpart of ``nerf_kinematics_tpu/data/robot.py``. Images are read by the
port's PNG codec (``io/image.py``; JPEG through a Pillow imported there),
converted to RGB, and shrunk by its LANCZOS, which equals Pillow's on uint8.
"""

from __future__ import annotations

import math
import os

import numpy as np

from ..io.image import read_image_u8, resize_lanczos, to_rgb
from ..poses.normalize import normalize_poses
from ..poses.orbit import generate_orbit_poses
from ..poses.parser import parse_poses_file
from .types import Intrinsics, NerfDataset

DEFAULT_FOV_X_DEG = 87.0
DEFAULT_FOV_Y_DEG = 58.0


def _find_image_dir(basedir: str):
    for name in ("images_robot", "images"):
        d = os.path.join(basedir, name)
        if os.path.isdir(d):
            return d
    raise FileNotFoundError(f"no images_robot/ or images/ under {basedir}")


def indexed_images(imgdir: str) -> dict:
    """index -> path of the images whose name ends in an integer
    ("TestNERF 7.png", "frame_7.jpg")."""
    files = {}
    for f in os.listdir(imgdir):
        stem, ext = os.path.splitext(f)
        if ext.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        tokens = stem.replace("_", " ").split()
        if tokens and tokens[-1].isdigit():
            files[int(tokens[-1])] = os.path.join(imgdir, f)
    if not files:
        raise FileNotFoundError(f"no indexed images in {imgdir}")
    return files


def load_robot(cfg, device=None) -> NerfDataset:
    """Load a robot capture (on the host: ``device`` is accepted as every
    loader accepts it, and not used; the trainer moves the arrays)."""
    basedir = cfg.basedir
    factor = max(int(getattr(cfg, "downsample_factor", 1)), 1)
    hold = max(int(getattr(cfg, "llffhold", 8)), 1)

    mats = parse_poses_file(os.path.join(basedir, "poses.txt"))
    files = indexed_images(_find_image_dir(basedir))

    # Match pose k to image "<prefix> k.jpg" by ascending index, skipping
    # missing files — same pairing rule as the converter.
    order = sorted(files)
    n = min(len(order), mats.shape[0])
    order, mats = order[:n], mats[:n]

    imgs = []
    for k in order:
        im = to_rgb(read_image_u8(files[k]))
        if factor > 1:
            im = resize_lanczos(im, im.shape[1] // factor, im.shape[0] // factor)
        imgs.append(im.astype(np.float32) / 255.0)
    imgs = np.stack(imgs)
    H, W = imgs.shape[1:3]

    # Normalize all poses together (recentered to the full capture's centroid,
    # unit max radius, Z-flip). normalize_poses treats index 0 as held-out but
    # applies the identical affine map to it, so concatenating back preserves
    # capture order.
    norm = normalize_poses(mats, recenter=True, scale_trans=1.0)
    poses = np.concatenate([norm.val[None], norm.train], axis=0).astype(np.float32)

    fl_x = 0.5 * W / math.tan(math.radians(DEFAULT_FOV_X_DEG) / 2)
    fl_y = 0.5 * H / math.tan(math.radians(DEFAULT_FOV_Y_DEG) / 2)

    idx = np.arange(n)
    val_idx = idx[::hold]
    train_idx = np.array([i for i in idx if i % hold != 0])

    # Novel-view path: the converter's 360° orbit convention
    # (generate_video_poses' 5·sin(4θ) wobble), rescaled to the normalized
    # capture (unit max radius) so --render-video works on robot datasets
    # loaded directly from a capture dir.
    center = poses[:, :3, 3].mean(0)
    radius = float(np.linalg.norm(poses[:, :3, 3] - center, axis=1).mean())
    radius = radius if radius > 1e-6 else 1.0
    render_poses = generate_orbit_poses(
        center, radius, 60, height_wobble=0.125 * radius, wobble_freq=4
    ).numpy().astype(np.float32)

    return NerfDataset(
        images=imgs,
        poses=poses,
        intrinsics=Intrinsics(fl_x, fl_y, W / 2.0, H / 2.0, W, H),
        near=float(getattr(cfg, "near", 0.0)),
        far=float(getattr(cfg, "far", 1.0)),
        train_idx=train_idx,
        val_idx=val_idx,
        use_ndc=not getattr(cfg, "no_ndc", True),
        aabb_scale=2.0,
        render_poses=render_poses,
    )
