"""Camera constants and pose synthesis of the "machina" benchmark scene
(400x400, lego-like orbit). The scene generator itself is not ported yet."""

from __future__ import annotations

import numpy as np

from .types import Intrinsics

# Matches nerf_synthetic/lego's horizontal FOV (transforms_train.json).
CAMERA_ANGLE_X = 0.6911112070083618
RADIUS = 4.0311289
NEAR, FAR = 2.0, 6.0


def _look_at_poses(positions: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Camera-to-world matrices looking from ``positions`` (N, 3) at
    ``center`` (3,), world-up = +Z. Columns are [right, up, -forward,
    position]: OpenGL camera convention, -Z forward."""
    forward = center[None, :] - positions
    forward = forward / np.linalg.norm(forward, axis=1, keepdims=True)
    world_up = np.array([0.0, 0.0, 1.0])
    right = np.cross(forward, world_up[None, :])
    right = right / np.linalg.norm(right, axis=1, keepdims=True)
    up = np.cross(right, forward)

    n = positions.shape[0]
    poses = np.zeros((n, 4, 4))
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up
    poses[:, :3, 2] = -forward
    poses[:, :3, 3] = positions
    poses[:, 3, 3] = 1.0
    return poses


def orbit_poses(n: int, elev_deg: float = 30.0, radius: float = RADIUS) -> np.ndarray:
    """(n, 4, 4) f32 poses on a circle at fixed elevation, looking at the
    origin."""
    theta = 2 * np.pi * np.arange(n) / n
    e = np.radians(elev_deg)
    pos = np.stack(
        [
            radius * np.cos(e) * np.cos(theta),
            radius * np.cos(e) * np.sin(theta),
            np.full(n, radius * np.sin(e)),
        ],
        axis=1,
    )
    return _look_at_poses(pos, np.zeros(3)).astype(np.float32)


def machina_intrinsics(size: int = 400) -> Intrinsics:
    """Pinhole intrinsics of a ``size x size`` machina view."""
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    return Intrinsics(fl_x=focal, fl_y=focal, cx=size / 2.0, cy=size / 2.0,
                      width=size, height=size)
