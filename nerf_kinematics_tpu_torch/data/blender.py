"""Blender / nerf_synthetic loader (``dataset.type: blender``).

Format: ``transforms_{train,val,test}.json`` with ``camera_angle_x`` and
frames ``{file_path: "./train/r_0", transform_matrix}``; PNGs with alpha.
Supports ``half_res`` (a 2x LANCZOS downscale, as Pillow's) and ``testskip``
(every k-th val / test frame). Alpha is composited at load time: onto white
if ``white_background`` else onto black. Images are decoded by the port's
own PNG reader (``io/image.py``): no Pillow needed.

Counterpart of ``nerf_kinematics_tpu/data/blender.py``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..io.image import read_image_u8, resize_lanczos
from .types import Intrinsics, NerfDataset


def _load_split(basedir: str, split: str, skip: int):
    with open(os.path.join(basedir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = meta["frames"][:: max(skip, 1)]
    imgs, poses = [], []
    for fr in frames:
        path = os.path.join(basedir, fr["file_path"])
        if not os.path.splitext(path)[1]:
            path = path + ".png"
        imgs.append(read_image_u8(path).astype(np.float32) / 255.0)
        poses.append(np.asarray(fr["transform_matrix"], dtype=np.float32))
    return np.stack(imgs), np.stack(poses), float(meta["camera_angle_x"])


def _pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """c2w on a sphere looking at the origin: the blender dataset's
    novel-view path convention (nerf-pytorch's ``pose_spherical``).
    OpenGL-style camera (x right, y up, z back)."""
    t, p = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    c2w = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, radius], [0, 0, 0, 1]],
        np.float32,
    )
    rot_phi = np.array(
        [[1, 0, 0, 0],
         [0, np.cos(p), -np.sin(p), 0],
         [0, np.sin(p), np.cos(p), 0],
         [0, 0, 0, 1]], np.float32,
    )
    rot_theta = np.array(
        [[np.cos(t), 0, -np.sin(t), 0],
         [0, 1, 0, 0],
         [np.sin(t), 0, np.cos(t), 0],
         [0, 0, 0, 1]], np.float32,
    )
    flip = np.array(
        [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
        np.float32,
    )
    return flip @ rot_theta @ rot_phi @ c2w


def _spherical_render_path(near: float, far: float, n: int = 40) -> np.ndarray:
    radius = 0.5 * (near + far)
    thetas = np.linspace(-180.0, 180.0, n + 1)[:-1]
    return np.stack([_pose_spherical(t, -30.0, radius) for t in thetas])


def load_blender(cfg, white_background: bool = False, device=None) -> NerfDataset:
    """Load a nerf_synthetic-format dataset (on the host: ``device`` is
    accepted as every loader accepts it, and not used).

    ``white_background`` is the train settings' flag
    (``nerf.train.white_background``), not the dataset section's: ground
    truth must be composited as the renderer composites, or white-rendered
    pixels train against black targets."""
    skip = getattr(cfg, "testskip", 1)
    splits = {}
    for split, s in (("train", 1), ("val", skip), ("test", skip)):
        if split != "train" and not os.path.isfile(
                os.path.join(cfg.basedir, f"transforms_{split}.json")):
            continue
        splits[split] = _load_split(cfg.basedir, split, s)
    imgs = np.concatenate([splits[s][0] for s in splits])
    poses = np.concatenate([splits[s][1] for s in splits])
    cax = splits["train"][2]

    counts = np.cumsum([0] + [splits[s][0].shape[0] for s in splits])
    idx_of = {s: np.arange(counts[i], counts[i + 1]) for i, s in enumerate(splits)}

    H, W = imgs.shape[1:3]
    focal = 0.5 * W / np.tan(0.5 * cax)

    if imgs.shape[-1] == 4:
        rgb, a = imgs[..., :3], imgs[..., 3:]
        imgs = rgb * a + (1.0 if white_background else 0.0) * (1.0 - a)

    if getattr(cfg, "half_res", False):
        H, W, focal = H // 2, W // 2, focal / 2.0
        small = np.empty((imgs.shape[0], H, W, 3), np.float32)
        for i, im in enumerate(imgs):
            # the reference truncates to 8 bits before its LANCZOS resize
            small[i] = resize_lanczos((im * 255).astype(np.uint8), W, H) / 255.0
        imgs = small

    return NerfDataset(
        images=imgs.astype(np.float32),
        poses=poses.astype(np.float32),
        intrinsics=Intrinsics(focal, focal, W / 2.0, H / 2.0, W, H),
        near=float(cfg.near),
        far=float(cfg.far),
        train_idx=idx_of.get("train", np.zeros(0, np.int64)),
        val_idx=idx_of.get("val", np.zeros(0, np.int64)),
        test_idx=idx_of.get("test", np.zeros(0, np.int64)),
        use_ndc=False,
        render_poses=_spherical_render_path(float(cfg.near), float(cfg.far)),
    )
