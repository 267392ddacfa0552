"""Camera-path interpolation for smooth video rendering.

Counterpart of ``nerf_kinematics_tpu/poses/camera_path.py`` and of
instant-ngp's src/camera_path.cu: keyframe camera poses → a smooth interpolated
trajectory. Rotations travel the geodesic (quaternion slerp), positions
follow a Catmull-Rom spline through the keyframes. Pairs with the pose
converter's ``*_test_video.json`` orbits (parser_instant_ngp.py:94-125) and
the renderer's video export. The poses are small float64 numpy arrays
on the host, as the reference's are.
"""

from __future__ import annotations

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) rotation → (w, x, y, z) unit quaternion (Shepperd's method)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
            q = [(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                 (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
        elif i == 1:
            s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
            q = [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                 0.25 * s, (R[1, 2] + R[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
            q = [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                 (R[1, 2] + R[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    """Spherical linear interpolation between unit quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0:  # take the short arc
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    theta = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * theta) * q0 + np.sin(t * theta) * q1) / np.sin(theta)


def _catmull_rom(p0, p1, p2, p3, t):
    t2, t3 = t * t, t * t * t
    return (
        0.5 * ((2 * p1) + (-p0 + p2) * t
               + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t2
               + (-p0 + 3 * p1 - 3 * p2 + p3) * t3)
    )


def interpolate_path(
    keyframes: np.ndarray,
    n_frames: int,
    loop: bool = False,
) -> np.ndarray:
    """(K, 4, 4) keyframe poses → (n_frames, 4, 4) smooth trajectory.

    Positions: Catmull-Rom spline; rotations: per-segment slerp. ``loop``
    closes the path (video orbits).
    """
    kf = np.asarray(keyframes, np.float64)
    K = kf.shape[0]
    if K < 2:
        return np.repeat(kf, n_frames, axis=0)

    quats = [rotmat_to_quat(m[:3, :3]) for m in kf]
    pos = kf[:, :3, 3]

    n_segments = K if loop else K - 1
    out = np.zeros((n_frames, 4, 4))
    for f in range(n_frames):
        s = f * n_segments / n_frames if loop else f * n_segments / max(n_frames - 1, 1)
        seg = min(int(s), n_segments - 1)
        t = s - seg

        def P(i):
            return pos[i % K] if loop else pos[np.clip(i, 0, K - 1)]

        p = _catmull_rom(P(seg - 1), P(seg), P(seg + 1), P(seg + 2), t)
        q = slerp(quats[seg % K], quats[(seg + 1) % K], t)
        out[f, :3, :3] = quat_to_rotmat(q)
        out[f, :3, 3] = p
        out[f, 3, 3] = 1.0
    return out
