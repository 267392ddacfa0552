"""End-to-end FK-pose → transforms.json conversion pipeline.

Produces the four JSON outputs of the reference converter
(parser_instant_ngp.py:174-355):

- ``transforms.json``            train frames (poses 1..N-1, images matched by
                                 ascending index skipping missing files)
- ``transforms_val.json``        one held-out frame (pose 0, first image found)
- ``transforms_test.json``       8 orbit poses (radius 50), key
                                 ``transform_matrix_start``
- ``transforms_test_video.json`` 60 orbit poses (radius 40, height wobble)

Counterpart of ``nerf_kinematics_tpu/poses/pipeline.py``: the same dicts in
the same key order. The image size comes from the port's PNG header
(``io/image.py::image_size``; other formats through Pillow, imported there),
and the orbits from the port's ``poses/orbit.py`` (float64 tensors on the
CPU, written as lists).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..io.image import image_size
from .normalize import aabb_scale_for, camera_centers, normalize_poses
from .orbit import generate_test_poses, generate_video_poses
from .parser import parse_poses_file
from .sharpness import compute_sharpness


def intrinsics_from_fov(w: int, h: int, fov_x_deg: float, fov_y_deg: float) -> dict:
    """Pinhole intrinsics from horizontal/vertical FOV in degrees
    (parser_instant_ngp.py:266-272); defaults 87°x58° = RealSense D405."""
    cax = math.radians(fov_x_deg)
    cay = math.radians(fov_y_deg)
    return {
        "camera_angle_x": cax,
        "camera_angle_y": cay,
        "fl_x": 0.5 * w / math.tan(cax / 2),
        "fl_y": 0.5 * h / math.tan(cay / 2),
        "cx": w / 2.0,
        "cy": h / 2.0,
        "w": w,
        "h": h,
    }


def base_transforms_dict(
    w, h, fov_x_deg, fov_y_deg, k1, k2, p1, p2, aabb_scale
) -> dict:
    """Base transforms.json structure (parser_instant_ngp.py:128-145)."""
    out = intrinsics_from_fov(w, h, fov_x_deg, fov_y_deg)
    # Key order matches the reference schema.
    return {
        "camera_angle_x": out["camera_angle_x"],
        "camera_angle_y": out["camera_angle_y"],
        "fl_x": out["fl_x"],
        "fl_y": out["fl_y"],
        "k1": k1,
        "k2": k2,
        "p1": p1,
        "p2": p2,
        "cx": out["cx"],
        "cy": out["cy"],
        "w": w,
        "h": h,
        "aabb_scale": aabb_scale,
        "frames": [],
    }


@dataclass
class ConversionResult:
    train: dict
    val: dict
    test: dict
    video: dict
    scale_factor: float
    center: np.ndarray
    aabb_scale: float
    paths: dict = field(default_factory=dict)


def _find_images(folder: str, prefix: str, ext: str, max_idx: int):
    """Yield (idx, path) for existing images named '{prefix}{idx}.{ext}'."""
    for idx in range(max_idx):
        path = os.path.join(folder, f"{prefix}{idx}.{ext}")
        if os.path.isfile(path):
            yield idx, path


def convert_poses(
    poses_path: str,
    image_folder: str,
    image_prefix: str = "TestNERF ",
    image_ext: str = "jpg",
    fov_x_deg: float = 87.0,
    fov_y_deg: float = 58.0,
    k1: float = 0.0,
    k2: float = 0.0,
    p1: float = 0.0,
    p2: float = 0.0,
    recenter: bool = False,
    scale_trans: float = 1.0,
    output: Optional[str] = "transforms.json",
    with_sharpness: bool = True,
) -> ConversionResult:
    """Run the full conversion. If ``output`` is None nothing is written; the
    four dicts are returned either way."""
    mats = parse_poses_file(poses_path)
    n_mats = mats.shape[0]

    norm = normalize_poses(mats, recenter=recenter, scale_trans=scale_trans)
    train_mats, val_mat = norm.train, norm.val
    aabb = aabb_scale_for(train_mats)
    scene_center = camera_centers(train_mats).mean(axis=0)

    # Probe first available image for resolution.
    found = list(_find_images(image_folder, image_prefix, image_ext, n_mats * 2))
    if not found:
        raise FileNotFoundError(
            f"no images matching {image_prefix}*.{image_ext} in {image_folder}"
        )
    w, h = image_size(found[0][1])

    def base():
        return base_transforms_dict(w, h, fov_x_deg, fov_y_deg, k1, k2, p1, p2, aabb)

    def frame(path, mat):
        f = {"file_path": path}
        if with_sharpness:
            f["sharpness"] = compute_sharpness(path)
        f["transform_matrix"] = np.asarray(mat).tolist()
        return f

    # Train: poses 1.. matched to images with index >= 1 in ascending order,
    # each image used at most once (parser_instant_ngp.py:277-295).
    train_imgs = [p for i, p in found if i >= 1]
    if len(train_imgs) < train_mats.shape[0]:
        raise FileNotFoundError(
            f"need {train_mats.shape[0]} train images, found {len(train_imgs)}"
        )
    train_out = base()
    train_out["frames"] = [
        frame(p, m) for p, m in zip(train_imgs, train_mats)
    ]

    # Val: first available image overall, paired with the held-out pose.
    val_out = base()
    val_out["frames"] = [frame(found[0][1], val_mat)]

    # Test orbit: 8 poses, radius 50, stored under ``transform_matrix_start``.
    test_out = base()
    test_out["frames"] = [
        {"file_path": f"./Test{i}.jpg", "transform_matrix_start": pose.tolist()}
        for i, pose in enumerate(generate_test_poses(scene_center).numpy())
    ]

    # Video orbit: 60 poses, radius 40, height wobble.
    video_out = base()
    video_out["frames"] = [
        {"transform_matrix": pose.tolist()}
        for pose in generate_video_poses(scene_center).numpy()
    ]

    paths = {}
    if output is not None:
        paths = {
            "train": output,
            "val": output.replace(".json", "_val.json"),
            "test": output.replace(".json", "_test.json"),
            "video": output.replace(".json", "_test_video.json"),
        }
        for key, obj in (
            ("train", train_out),
            ("val", val_out),
            ("test", test_out),
            ("video", video_out),
        ):
            with open(paths[key], "w") as f:
                json.dump(obj, f, indent=2)

    return ConversionResult(
        train=train_out,
        val=val_out,
        test=test_out,
        video=video_out,
        scale_factor=norm.scale_factor,
        center=norm.center,
        aabb_scale=aabb,
        paths=paths,
    )
