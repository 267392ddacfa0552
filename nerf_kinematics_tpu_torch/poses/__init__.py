"""Pose tools of the port. Ported so far: the orbit poses (``orbit.py``);
the parser, normalization, SfM, COLMAP, camera paths and refinement follow
(ROADMAP A.8)."""

from .orbit import (
    generate_orbit_poses,
    generate_test_poses,
    generate_video_poses,
)

__all__ = ["generate_orbit_poses", "generate_test_poses", "generate_video_poses"]
