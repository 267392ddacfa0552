"""LLFF-format variant of the machina benchmark scene: the machina field
rendered from a forward-facing camera cluster and written in the on-disk
LLFF layout (``poses_bounds.npy``: (N, 17) rows of 3x5 [down, right, back |
t | hwf] pose blocks and per-view depth bounds, plus ``images/`` of RGB
PNGs), so that ``data/llff.py`` runs its whole real-data path: axis
permutation, bd_factor rescale, recentering, llffhold split, NDC bounds,
spiral render path.

Counterpart of ``nerf_kinematics_tpu/data/machina_llff.py``: the same poses
(the same ``default_rng`` stream), the same files; rendering on the card by
default (``data/machina.py::render_view``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .machina import (CAMERA_ANGLE_X, RADIUS, _look_at_poses, _marker_matches,
                      _on_sphere, render_view)


def forward_facing_poses(n: int, seed: int = 0, radius: float = RADIUS,
                         azim_deg: float = 14.0, elev_deg: float = 26.0,
                         spread_deg: float = 9.0) -> np.ndarray:
    """n c2w poses in a forward-facing cluster looking at the origin."""
    rng = np.random.default_rng(seed)
    azim = np.radians(azim_deg + rng.uniform(-spread_deg, spread_deg, n))
    elev = np.radians(elev_deg + rng.uniform(-spread_deg, spread_deg, n))
    r = radius * rng.uniform(0.92, 1.08, n)
    return _look_at_poses(_on_sphere(r, elev, azim), np.zeros(3)).astype(np.float32)


def nerf_to_llff_pose(c2w: np.ndarray, H: int, W: int,
                      focal: float) -> np.ndarray:
    """NeRF [right, up, back] c2w (3x4 or 4x4) -> LLFF 3x5 [down, right,
    back | t | hwf] block: the inverse of data/llff.py's permutation."""
    r, u, b, t = c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3]
    hwf = np.array([H, W, focal], np.float32)
    return np.stack([-u, r, b, t, hwf], axis=1).astype(np.float32)


def write_machina_llff_dataset(
    outdir: str,
    resolution: int = 400,
    n_views: int = 32,
    seed: int = 11,
    n_samples: int = 1024,
    object_radius: float = 1.6,
    force: bool = False,
    device=None,
) -> str:
    """Render and write the forward-facing dataset in LLFF layout.
    Idempotent through a marker file. Returns ``outdir``."""
    from ..io.image import write_png

    marker = os.path.join(outdir, ".machina_llff.json")
    params = {
        "resolution": resolution, "n_views": n_views, "seed": seed,
        "n_samples": n_samples, "object_radius": object_radius, "version": 1,
    }
    if not force and _marker_matches(marker, params):
        return outdir

    H = W = resolution
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    poses = forward_facing_poses(n_views, seed=seed)

    imgdir = os.path.join(outdir, "images")
    os.makedirs(imgdir, exist_ok=True)
    rows = []
    for k, c2w in enumerate(poses):
        comp, acc = render_view(c2w, H, W, focal, n_samples, device=device)
        comp, acc = comp.cpu().numpy(), acc.cpu().numpy()
        # LLFF scenes have opaque backgrounds: composite onto white.
        rgb = np.clip(comp + (1.0 - acc[..., None]), 0.0, 1.0)
        write_png(os.path.join(imgdir, f"image{k:03d}.png"),
                  (rgb * 255).astype(np.uint8))
        dist = float(np.linalg.norm(c2w[:3, 3]))
        near = max(dist - object_radius, 0.3)
        far = dist + object_radius
        rows.append(np.concatenate(
            [nerf_to_llff_pose(c2w, H, W, focal).reshape(-1),
             np.array([near, far], np.float32)]))
    np.save(os.path.join(outdir, "poses_bounds.npy"),
            np.stack(rows).astype(np.float64))
    with open(marker, "w") as f:
        json.dump(params, f)
    return outdir
