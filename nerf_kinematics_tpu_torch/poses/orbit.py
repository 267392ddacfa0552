"""Orbit poses for test and video renders: circular look-at orbits around the
scene center, 8 test poses at radius 50 and 60 video poses at radius 40 with a
``5 sin(4 theta)`` height wobble (instant-ngp's ``parser_instant_ngp.py``).

Counterpart of ``nerf_kinematics_tpu/poses/orbit.py``. Poses are float64
tensors on the given device (``device=None``: the positions' device, the CPU
for numpy input), as the reference's numpy poses are float64.
"""

from __future__ import annotations

import math

import torch


def _look_at_poses(positions, center) -> torch.Tensor:
    """Camera-to-world matrices (N, 4, 4) looking from ``positions`` (N, 3)
    at ``center`` (3,), world up +Z. Columns are [right, up, -forward,
    position]: the OpenGL convention, -Z forward."""
    positions = torch.as_tensor(positions, dtype=torch.float64)
    center = torch.as_tensor(center, dtype=torch.float64, device=positions.device)
    forward = center[None, :] - positions
    forward = forward / torch.linalg.norm(forward, dim=1, keepdim=True)
    world_up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64,
                            device=positions.device)
    right = torch.linalg.cross(forward, world_up.expand_as(forward), dim=1)
    right = right / torch.linalg.norm(right, dim=1, keepdim=True)
    up = torch.linalg.cross(right, forward, dim=1)

    n = positions.shape[0]
    poses = torch.zeros((n, 4, 4), dtype=torch.float64, device=positions.device)
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up
    poses[:, :3, 2] = -forward
    poses[:, :3, 3] = positions
    poses[:, 3, 3] = 1.0
    return poses


def generate_orbit_poses(center, radius: float, n_poses: int,
                         height_wobble: float = 0.0, wobble_freq: int = 4,
                         device=None) -> torch.Tensor:
    """(n_poses, 4, 4) camera-to-world poses on a circle of ``radius`` around
    ``center`` in the XY plane, optionally with a sinusoidal height offset."""
    center = torch.as_tensor(center, dtype=torch.float64, device=device)
    theta = 2.0 * math.pi * torch.arange(n_poses, dtype=torch.float64,
                                         device=center.device) / n_poses
    positions = torch.stack([
        center[0] + radius * torch.cos(theta),
        center[1] + radius * torch.sin(theta),
        center[2] + height_wobble * torch.sin(wobble_freq * theta),
    ], dim=1)
    return _look_at_poses(positions, center)


def generate_test_poses(center, radius: float = 50.0, n_poses: int = 8,
                        device=None) -> torch.Tensor:
    """The 8 static test poses."""
    return generate_orbit_poses(center, radius, n_poses, device=device)


def generate_video_poses(center, radius: float = 40.0, n_poses: int = 60,
                         device=None) -> torch.Tensor:
    """The 60 video poses, with a ``5 sin(4 theta)`` height wobble."""
    return generate_orbit_poses(center, radius, n_poses, height_wobble=5.0,
                                wobble_freq=4, device=device)
