"""Pose layer: robot forward-kinematics pose parsing and NeRF-convention
conversion (the reference's ``parser_instant_ngp.py``), the orbit poses and
camera paths.

Counterpart of ``nerf_kinematics_tpu/poses/__init__.py``, with the same
exports; the CLI wrapper is ``nerf_kinematics_tpu_torch.cli.parse_poses``.
COLMAP import, SfM and pose refinement follow (ROADMAP A.8b, A.8c).
"""

from .parser import parse_poses_file, parse_poses_text
from .normalize import (
    aabb_scale_for,
    normalize_poses,
    camera_centers,
)
from .orbit import generate_orbit_poses, generate_test_poses, generate_video_poses
from .sharpness import compute_sharpness
from .pipeline import ConversionResult, convert_poses

__all__ = [
    "parse_poses_file",
    "parse_poses_text",
    "aabb_scale_for",
    "normalize_poses",
    "camera_centers",
    "generate_orbit_poses",
    "generate_test_poses",
    "generate_video_poses",
    "compute_sharpness",
    "convert_poses",
    "ConversionResult",
]
