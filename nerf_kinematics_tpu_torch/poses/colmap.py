"""COLMAP text model -> transforms.json converter (cv2-free).

Parses a COLMAP TXT export (cameras.txt / images.txt), converts the
world-to-camera quaternion poses into NeRF camera-to-world convention,
turns the average up vector to +Z, moves the center of attention (the
least-squares closest point to all optical axes) to the origin, scales the
average camera distance to 4.0, scores each frame's sharpness and writes the
transforms.json schema, printing the up vector, the center of attention and
the average camera distance.

Counterpart of ``nerf_kinematics_tpu/poses/colmap.py`` (numpy, float64, no
device): the same functions, dicts and printed lines. Sharpness goes
through the port's ``poses/sharpness.py`` (PNG through the port's codec,
other formats through a Pillow imported there).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from .sharpness import compute_sharpness


@dataclass
class ColmapCamera:
    model: str
    width: int
    height: int
    params: List[float]

    def intrinsics(self) -> dict:
        m, p = self.model, self.params
        if m == "SIMPLE_PINHOLE":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = (0.0, 0.0, 0.0, 0.0)
        elif m == "PINHOLE":
            fl_x, fl_y, cx, cy = p[:4]
            dist = (0.0, 0.0, 0.0, 0.0)
        elif m == "SIMPLE_RADIAL":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = (p[3], 0.0, 0.0, 0.0)
        elif m == "RADIAL":
            fl_x = fl_y = p[0]
            cx, cy = p[1], p[2]
            dist = (p[3], p[4], 0.0, 0.0)
        elif m == "OPENCV":
            fl_x, fl_y, cx, cy = p[:4]
            dist = tuple(p[4:8])
        else:
            raise ValueError(f"unsupported COLMAP camera model {m!r}")
        return {
            "fl_x": fl_x, "fl_y": fl_y, "cx": cx, "cy": cy,
            "k1": dist[0], "k2": dist[1], "p1": dist[2], "p2": dist[3],
            "w": self.width, "h": self.height,
            "camera_angle_x": 2 * math.atan(self.width / (2 * fl_x)),
            "camera_angle_y": 2 * math.atan(self.height / (2 * fl_y)),
        }


def parse_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            cams[int(toks[0])] = ColmapCamera(
                model=toks[1], width=int(toks[2]), height=int(toks[3]),
                params=[float(t) for t in toks[4:]],
            )
    return cams


def qvec_to_rotmat(q) -> np.ndarray:
    """COLMAP quaternion (w, x, y, z) → 3x3 rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def parse_images_txt(path: str) -> List[dict]:
    """Image registrations: every other line holds the pose row."""
    out = []
    with open(path) as f:
        expecting_pose = True
        for line in f:
            line = line.strip()
            if line.startswith("#"):
                continue
            if not line and expecting_pose:
                continue  # blank separator; a blank POINTS2D line still toggles
            if expecting_pose:
                toks = line.split()
                out.append({
                    "image_id": int(toks[0]),
                    "qvec": [float(t) for t in toks[1:5]],
                    "tvec": [float(t) for t in toks[5:8]],
                    "camera_id": int(toks[8]),
                    "name": toks[9],
                })
                expecting_pose = False
            else:
                expecting_pose = True  # skip the POINTS2D line
    return out


def colmap_pose_to_c2w(qvec, tvec) -> np.ndarray:
    """COLMAP world→camera (R, t) → NeRF camera→world (OpenGL axes).

    COLMAP cameras look down +z with y down; NeRF uses -z forward, y up —
    flip the y and z camera axes after inverting."""
    R = qvec_to_rotmat(qvec)
    t = np.asarray(tvec)
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    c2w[:3, 1:3] *= -1.0
    return c2w


def _closest_point_to_rays(origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Least-squares point minimizing distance to all lines (o_i + t d_i) —
    the 'center of attention'."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for o, d in zip(origins, dirs):
        d = d / np.linalg.norm(d)
        P = np.eye(3) - np.outer(d, d)
        A += P
        b += P @ o
    return np.linalg.lstsq(A, b, rcond=None)[0]


def _rotation_aligning(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation taking unit vector a to unit vector b (Rodrigues)."""
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    if np.linalg.norm(v) < 1e-12:
        return np.eye(3) if c > 0 else -np.eye(3)
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


def colmap_to_transforms(
    text_dir: str,
    images_dir: Optional[str] = None,
    aabb_scale: float = 16.0,
    out_path: Optional[str] = None,
    keep_colmap_coords: bool = False,
    target_avg_distance: float = 4.0,
    with_sharpness: bool = True,
    verbose: bool = True,
) -> dict:
    """Convert a COLMAP TXT model directory into a transforms.json dict."""
    cams = parse_cameras_txt(os.path.join(text_dir, "cameras.txt"))
    images = parse_images_txt(os.path.join(text_dir, "images.txt"))
    if not images:
        raise ValueError(f"no registered images in {text_dir}/images.txt")

    intr = cams[images[0]["camera_id"]].intrinsics()
    out = {**intr, "aabb_scale": aabb_scale, "frames": []}

    poses = np.stack(
        [colmap_pose_to_c2w(im["qvec"], im["tvec"]) for im in images]
    )

    if not keep_colmap_coords:
        # Reorient: average camera up → +Z.
        up = poses[:, :3, 1].sum(0)
        up /= np.linalg.norm(up)
        if verbose:
            print(f"up vector was {up}")
        R = np.eye(4)
        R[:3, :3] = _rotation_aligning(up, np.array([0.0, 0.0, 1.0]))
        poses = R @ poses

        # Center of attention: closest point to all optical axes (-z cols).
        center = _closest_point_to_rays(poses[:, :3, 3], -poses[:, :3, 2])
        if verbose:
            print(f"center of attention: {center}")
        poses[:, :3, 3] -= center

        avg_dist = np.linalg.norm(poses[:, :3, 3], axis=1).mean()
        if verbose:
            print(f"avg camera distance from origin: {avg_dist}")
        poses[:, :3, 3] *= target_avg_distance / avg_dist

    for im, pose in zip(images, poses):
        frame = {"file_path": (
            os.path.join(images_dir, im["name"]) if images_dir else im["name"]
        )}
        if with_sharpness and images_dir:
            full = os.path.join(images_dir, im["name"])
            if os.path.isfile(full):
                frame["sharpness"] = compute_sharpness(full)
        frame["transform_matrix"] = pose.tolist()
        out["frames"].append(frame)

    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
        if verbose:
            print(f"wrote {out_path} with {len(out['frames'])} frames")
    return out
