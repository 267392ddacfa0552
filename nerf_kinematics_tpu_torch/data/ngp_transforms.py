"""Instant-NGP ``transforms.json`` loader (``dataset.type: ngp``).

Reads the transforms.json schema (camera_angle_x/y, fl_x/fl_y, k1/k2/p1/p2,
cx/cy, w/h, aabb_scale, frames[]), normalizes rotations whose determinant
drifts from 1 with instant-ngp's warning ("Rotation of camera matrix in
frame N has a scaling component (determinant!=1). Normalizing"), and
resolves image paths relative to the JSON file, so a val JSON may sit apart
from its images. PNGs go through the port's own codec (``io/image.py``);
other formats through Pillow, imported when needed. Images with alpha are
composited onto white.

Counterpart of ``nerf_kinematics_tpu/data/ngp_transforms.py``; gives its
images, poses and intrinsics.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np

from ..io.image import _is_png, _pillow, decode_png
from .types import Intrinsics, NerfDataset

log = logging.getLogger(__name__)


def normalize_rotations(poses: np.ndarray, warn: bool = True) -> np.ndarray:
    """Rescale rotation blocks so det(R) == 1, warning per drifting frame."""
    poses = poses.copy()
    dets = np.linalg.det(poses[:, :3, :3])
    bad = np.abs(dets - 1.0) > 1e-4
    if warn:
        for i in np.nonzero(bad)[0]:
            log.warning(
                "Rotation of camera matrix in frame %d has a scaling component "
                "(determinant!=1). Normalizing.", int(i))
    # det(sR) = s^3 det(R): divide by cbrt(det) (sign-preserving)
    scale = np.cbrt(np.abs(dets))
    poses[:, :3, :3] /= scale[:, None, None]
    return poses


def _resolve(json_dir: str, file_path: str):
    """A frame's file_path: as given, relative to the JSON, or by basename
    next to the JSON or in a sibling image directory. An extension-less path
    (the blender transforms_*.json convention, "./train/r_0") gets image
    extensions appended, as instant-ngp's loader does."""
    candidates = [
        file_path,
        os.path.join(json_dir, file_path),
        os.path.join(json_dir, os.path.basename(file_path)),
        os.path.join(json_dir, "..", os.path.basename(file_path)),
    ]
    for parent in ("images", "images_robot"):
        candidates.append(os.path.join(json_dir, "..", parent, os.path.basename(file_path)))
    if not os.path.splitext(file_path)[1]:
        candidates += [c + ext for c in list(candidates)
                       for ext in (".png", ".jpg", ".jpeg")]
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def _over_white(rgba_u8: np.ndarray) -> np.ndarray:
    rgba = rgba_u8.astype(np.float32) / 255.0
    a = rgba[..., 3:4]
    return rgba[..., :3] * a + (1.0 - a)


def _rgb(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32) / 255.0


def read_frame(path: str) -> np.ndarray:
    """(H, W, 3) float32: an image with an alpha channel (gray + alpha,
    RGBA) composited onto white, any other as RGB."""
    if _is_png(path):
        with open(path, "rb") as f:
            data = f.read()
        img = decode_png(data)
        ctype = data[25]  # IHDR's color type: 4 gray + alpha, 6 RGBA
        if ctype in (4, 6):
            if ctype == 4:
                img = np.concatenate([np.repeat(img[..., :1], 3, -1), img[..., 1:]], -1)
            return _over_white(img)
        if img.shape[2] in (1, 2):
            img = np.repeat(img[..., :1], 3, -1)
        return _rgb(img[..., :3])
    with _pillow().open(path) as im:
        if im.mode in ("RGBA", "LA", "PA"):
            return _over_white(np.asarray(im.convert("RGBA")))
        return _rgb(np.asarray(im.convert("RGB")))


def load_transforms_json(path: str, require_images: bool = True):
    """One transforms*.json -> (images | None, poses, intrinsics, aabb).
    Frames without ``transform_matrix`` take ``transform_matrix_start``
    (the test-orbit schema)."""
    with open(path) as f:
        meta = json.load(f)
    json_dir = os.path.dirname(os.path.abspath(path))

    poses, images, missing = [], [], 0
    for i, fr in enumerate(meta["frames"]):
        mat = fr.get("transform_matrix", fr.get("transform_matrix_start"))
        if mat is None:
            raise ValueError(f"frame {i} in {path} has no transform matrix")
        img = None
        if "file_path" in fr:
            resolved = _resolve(json_dir, fr["file_path"])
            if resolved is not None:
                img = read_frame(resolved)
        if img is None:
            missing += 1
            if require_images:
                continue
        poses.append(np.asarray(mat, np.float32))
        images.append(img)

    if missing and require_images:
        log.warning("%d/%d frames in %s had no resolvable image; skipped.",
                    missing, len(meta["frames"]), path)
    poses = normalize_rotations(np.stack(poses))

    first = images[0] if images and images[0] is not None else None
    w = int(meta.get("w") or (first.shape[1] if first is not None else 0))
    h = int(meta.get("h") or (first.shape[0] if first is not None else 0))
    if "fl_x" in meta:
        fl_x = float(meta["fl_x"])
        fl_y = float(meta.get("fl_y", fl_x))
    else:
        fl_x = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
        fl_y = float(meta.get("camera_angle_y")
                     and 0.5 * h / np.tan(0.5 * meta["camera_angle_y"]) or fl_x)
    intr = Intrinsics(
        fl_x, fl_y, float(meta.get("cx", w / 2)), float(meta.get("cy", h / 2)), w, h,
        k1=float(meta.get("k1", 0.0)), k2=float(meta.get("k2", 0.0)),
        p1=float(meta.get("p1", 0.0)), p2=float(meta.get("p2", 0.0)),
    )
    aabb = float(meta.get("aabb_scale", 1.0))
    imgs = (np.stack([im for im in images if im is not None])
            if require_images and any(im is not None for im in images) else None)
    return imgs, poses, intr, aabb


def load_ngp_transforms(cfg, device=None) -> NerfDataset:
    """Dataset from a directory holding transforms.json (or the JSON itself),
    with the frames of its ``_val.json`` as the val split and the poses of
    its ``_test_video.json`` as the render path; read on the host (``device``
    is accepted as every loader accepts it, and not used)."""
    base = cfg.basedir
    train_json = base if base.endswith(".json") else os.path.join(base, "transforms.json")
    imgs, poses, intr, aabb = load_transforms_json(train_json)
    if imgs is None:
        raise FileNotFoundError(f"no images resolvable from {train_json}")

    val_json = train_json.replace(".json", "_val.json")
    n_train = imgs.shape[0]
    if os.path.isfile(val_json):
        vimgs, vposes, _, _ = load_transforms_json(val_json)
        if vimgs is not None:
            imgs = np.concatenate([imgs, vimgs])
            poses = np.concatenate([poses, vposes])
    n_total = imgs.shape[0]

    video_json = train_json.replace(".json", "_test_video.json")
    render_poses = None
    if os.path.isfile(video_json):
        _, render_poses, _, _ = load_transforms_json(video_json, require_images=False)

    return NerfDataset(
        images=imgs,
        poses=poses,
        intrinsics=intr,
        near=float(getattr(cfg, "near", 0.05)),
        far=float(getattr(cfg, "far", max(aabb, 2.0))),
        train_idx=np.arange(n_train),
        val_idx=np.arange(n_train, n_total),
        render_poses=render_poses,
        use_ndc=False,
        aabb_scale=aabb,
    )
