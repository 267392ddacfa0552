"""Pose normalization: recenter, rescale, and axis-flip into NeRF convention.

Reference semantics: parser_instant_ngp.py:148-171 (aabb power-of-2 bound) and
:209-244 (recenter to train-set centroid, scale max camera radius to
``scale_trans``, then invert the Z axis — third rotation column and Z
translation — for the Instant-NGP camera convention).

All operations are vectorized over the pose batch dimension.

Counterpart of ``nerf_kinematics_tpu/poses/normalize.py``: the same float64
numpy operations, so the results are equal to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def camera_centers(mats: np.ndarray) -> np.ndarray:
    """Camera positions: translation column of each (…, 4, 4) pose."""
    return np.asarray(mats)[..., :3, 3]


def aabb_scale_for(mats: np.ndarray, scale_multiplier: float = 1.0) -> float:
    """Power-of-2 aabb_scale in [1, 128] bounding 2x the max camera distance
    from the camera centroid (parser_instant_ngp.py:148-171)."""
    centers = camera_centers(mats)
    centroid = centers.mean(axis=0)
    max_dist = float(np.linalg.norm(centers - centroid, axis=1).max())
    target = max_dist * 2.0 * scale_multiplier
    aabb = 1.0
    while aabb < target and aabb < 128.0:
        aabb *= 2.0
    return aabb


class NormalizedPoses(NamedTuple):
    train: np.ndarray  # (N-1, 4, 4)
    val: np.ndarray  # (4, 4)
    center: np.ndarray  # (3,) centroid subtracted (zeros if recenter=False)
    scale_factor: float  # applied to translations (1.0 if recenter=False)


def _flip_z(mats: np.ndarray) -> np.ndarray:
    """Invert the Z axis in-place-free: negate the third rotation column and the
    Z translation (parser_instant_ngp.py:225-229)."""
    out = mats.copy()
    out[..., :3, 2] *= -1.0
    out[..., 2, 3] *= -1.0
    return out


def normalize_poses(
    mats: np.ndarray,
    recenter: bool = True,
    scale_trans: float = 1.0,
) -> NormalizedPoses:
    """Split poses into val (first) / train (rest) and normalize.

    When ``recenter`` is set: translations are recentered to the *train-set*
    centroid and scaled so the max train camera radius equals ``scale_trans``,
    then the Z axis is inverted (NeRF/Instant-NGP convention). The identical
    affine transform is applied to the held-out validation pose.

    When ``recenter`` is not set, poses pass through untouched — faithfully
    matching the reference, whose no-recenter branch only *logs* a Z-flip
    without performing one (parser_instant_ngp.py:242-244).
    """
    mats = np.asarray(mats, dtype=np.float64)
    if mats.shape[0] < 2:
        raise ValueError("need at least 2 poses to split train/validation")
    val, train = mats[0], mats[1:]

    if not recenter:
        return NormalizedPoses(train.copy(), val.copy(), np.zeros(3), 1.0)

    centers = camera_centers(train)
    center = centers.mean(axis=0)
    max_dist = float(np.linalg.norm(centers - center, axis=1).max())
    scale_factor = scale_trans / max_dist

    def _apply(m: np.ndarray) -> np.ndarray:
        out = m.copy()
        out[..., :3, 3] = (out[..., :3, 3] - center) * scale_factor
        return _flip_z(out)

    return NormalizedPoses(_apply(train), _apply(val), center, scale_factor)
