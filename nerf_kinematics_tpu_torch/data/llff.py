"""LLFF (forward-facing) loader (``dataset.type: llff``).

Format: ``poses_bounds.npy``, (N, 17) rows of a 3x5 pose matrix ([R | t |
hwf]) and two depth bounds, plus an ``images/`` (or ``images_{factor}/``)
directory. The classic pipeline: axis permutation from LLFF's [down, right,
back] to NeRF's [right, up, back], the bd_factor 0.75 rescale, recentering
on the average pose, the ``llffhold`` validation split, NDC bounds 0 / 1
unless ``no_ndc``, and a spiral render path. ``downsample_factor`` resizes
with the port's LANCZOS (``io/image.py``) where no ``images_{factor}/``
exists; images are converted to RGB before the resize (Pillow resizes an
RGBA image premultiplied, then drops alpha: the same for opaque images).

Counterpart of ``nerf_kinematics_tpu/data/llff.py``.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.image import read_image_u8, resize_lanczos, to_rgb
from .types import Intrinsics, NerfDataset


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """(3, 4) central pose: mean position, mean viewing direction, mean up."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _viewmatrix(z, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses so that the average pose is the identity."""
    c2w = np.eye(4)
    c2w[:3] = average_pose(poses)
    return np.linalg.inv(c2w) @ poses


def spiral_render_path(poses, bounds, n_views: int = 120, n_rots: int = 2):
    """The classic LLFF spiral novel-view path around the average pose."""
    c2w = average_pose(poses)
    up = _normalize(poses[:, :3, 1].sum(0))
    close, inf = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close + dt / inf)
    radii = np.percentile(np.abs(poses[:, :3, 3] - c2w[:3, 3]), 90, axis=0)
    radii = np.append(radii, 1.0)
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views, endpoint=False):
        c = c2w[:3, :4] @ (
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * 0.5), 1.0]) * radii
        )
        z = _normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        m = np.eye(4, dtype=np.float32)
        m[:3] = _viewmatrix(z, up, c)
        out.append(m)
    return np.stack(out)


def _load_images(basedir: str, factor: int):
    for name in ([f"images_{factor}", "images"] if factor > 1 else ["images"]):
        imgdir = os.path.join(basedir, name)
        if os.path.isdir(imgdir):
            break
    else:
        raise FileNotFoundError(f"no images dir in {basedir}")
    files = sorted(
        f for f in os.listdir(imgdir)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    native = "images_" in os.path.basename(imgdir)
    imgs = []
    for f in files:
        im = to_rgb(read_image_u8(os.path.join(imgdir, f)))
        if factor > 1 and not native:
            im = resize_lanczos(im, im.shape[1] // factor, im.shape[0] // factor)
        imgs.append(im.astype(np.float32) / 255.0)
    return np.stack(imgs)


def load_llff(cfg, device=None) -> NerfDataset:
    """Load an LLFF capture (on the host: ``device`` is accepted as every
    loader accepts it, and not used)."""
    factor = max(int(getattr(cfg, "downsample_factor", 1)), 1)
    pb = np.load(os.path.join(cfg.basedir, "poses_bounds.npy"))  # (N, 17)
    poses_hwf = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, 15:17]

    # LLFF stores [down, right, back]; permute to NeRF's [right, up, back].
    poses = np.concatenate(
        [poses_hwf[:, :, 1:2], -poses_hwf[:, :, 0:1], poses_hwf[:, :, 2:4]], axis=2
    )
    hwf = poses_hwf[:, :, 4]
    H, W, focal = hwf[0]
    H, W, focal = int(H) // factor, int(W) // factor, float(focal) / factor

    imgs = _load_images(cfg.basedir, factor)
    if imgs.shape[0] != poses.shape[0]:
        raise ValueError(
            f"{imgs.shape[0]} images vs {poses.shape[0]} poses in {cfg.basedir}"
        )
    if imgs.shape[1] != H or imgs.shape[2] != W:
        H, W = imgs.shape[1], imgs.shape[2]

    poses4 = np.tile(np.eye(4, dtype=np.float32), (poses.shape[0], 1, 1))
    poses4[:, :3, :4] = poses

    # Rescale so that the scene sits at unit-ish depth (bd_factor 0.75).
    scale = 1.0 / (bounds.min() * 0.75)
    poses4[:, :3, 3] *= scale
    bounds = bounds * scale
    poses4 = recenter_poses(poses4).astype(np.float32)

    use_ndc = not getattr(cfg, "no_ndc", True)
    if use_ndc:
        near, far = 0.0, 1.0
    else:
        near, far = float(bounds.min() * 0.9), float(bounds.max())

    hold = max(int(getattr(cfg, "llffhold", 8)), 1)
    idx = np.arange(imgs.shape[0])
    val_idx = idx[::hold]
    train_idx = np.array([i for i in idx if i % hold != 0])

    return NerfDataset(
        images=imgs,
        poses=poses4,
        intrinsics=Intrinsics(focal, focal, W / 2.0, H / 2.0, W, H),
        near=near,
        far=far,
        train_idx=train_idx,
        val_idx=val_idx,
        render_poses=spiral_render_path(poses4, bounds).astype(np.float32),
        use_ndc=use_ndc,
    )
