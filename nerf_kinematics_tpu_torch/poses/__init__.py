"""Pose layer: robot forward-kinematics pose parsing and NeRF-convention
conversion (the reference's ``parser_instant_ngp.py``), the orbit poses and
camera paths; the other pose sources as modules of their own: COLMAP import
(``colmap.py``), structure-from-motion with its bundle adjustment on the
device (``sfm.py``) and photometric pose refinement against a trained field
(``refine.py``).

Counterpart of ``nerf_kinematics_tpu/poses/__init__.py``, with the same
exports; the CLI wrappers are ``nerf_kinematics_tpu_torch.cli.parse_poses``,
``cli.colmap2nerf`` and ``cli.sfm2nerf``.
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
