"""Procedural scenes with an analytically known radiance field: a soft-edged
colored sphere (``sphere``), six striped blobs (``blobs``) and a unit-scale
subject with far satellites over a bound-16 box (``halo``, the large-AABB
regime where scene contraction is needed). Each field is volume-rendered
through the same compositing the framework trains against, from orbit
cameras, optionally through a distorting lens.

Counterpart of ``nerf_kinematics_tpu/data/synthetic.py``, in PyTorch on the
given device (``device=None``: the GPU). The fields keep the reference's
types: the sphere's arithmetic in f32, the blobs' and the halo's distances
and weights in f64 (their tables are f64), as numpy promotes them.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..cameras.rays import get_rays
from ..poses.orbit import _look_at_poses, generate_orbit_poses
from .types import Intrinsics, NerfDataset

# Points (rays x samples) per chunk of the ground-truth renderer.
CHUNK_POINTS = 1 << 22


def field_fn(pts: torch.Tensor):
    """Ground truth: a smooth sphere (r = 0.5) at the origin with a
    position-dependent color. Returns (rgb in [0, 1], sigma >= 0)."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    sigma = 40.0 / (1.0 + torch.exp((r - 0.5) * 30.0))
    rgb = torch.clamp(0.5 + pts, 0.05, 0.95)
    return rgb, sigma


# The blob layout of the "blobs" variant: x, y, z, radius.
_BLOBS = np.array([
    [0.00, 0.00, 0.00, 0.30],
    [0.55, 0.10, 0.15, 0.18],
    [-0.45, 0.35, -0.20, 0.15],
    [0.15, -0.55, 0.25, 0.12],
    [-0.25, -0.30, -0.45, 0.20],
    [0.35, 0.45, -0.35, 0.10],
])
_BLOB_COLORS = np.array([
    [0.9, 0.2, 0.2], [0.2, 0.8, 0.3], [0.2, 0.3, 0.9],
    [0.9, 0.8, 0.1], [0.8, 0.2, 0.8], [0.1, 0.8, 0.8],
])

# The satellites of the "halo" variant, far from the origin: x, y, z, radius.
_HALO_SATS = np.array([
    [6.0, 0.0, 1.0, 1.2],
    [-5.0, 4.0, -1.0, 1.0],
    [0.0, -6.5, 2.0, 1.4],
    [-3.5, -4.5, -2.0, 0.9],
])
_HALO_COLORS = np.array(
    [[0.9, 0.3, 0.2], [0.2, 0.8, 0.4], [0.25, 0.35, 0.9], [0.9, 0.8, 0.2]])


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=like.device)


def field_fn_blobs(pts: torch.Tensor):
    """Six colored blobs with high-frequency stripes."""
    flat = pts.reshape(-1, 3)
    blobs = _table(_BLOBS, pts)
    d = torch.linalg.vector_norm(flat[:, None, :] - blobs[None, :, :3], dim=-1)
    act = 1.0 / (1.0 + torch.exp((d - blobs[None, :, 3]) * 40.0))  # (N, B)
    sigma = 60.0 * act.amax(dim=1)
    w = act / (act.sum(dim=1, keepdim=True) + 1e-9)
    base = w @ _table(_BLOB_COLORS, pts)
    stripes = 0.25 * torch.sin(14.0 * flat[:, 0:1] + 9.0 * flat[:, 2:3])
    rgb = torch.clamp(base + stripes, 0.02, 0.98)
    return rgb.reshape(*pts.shape[:-1], 3), sigma.reshape(pts.shape[:-1])


def field_fn_halo(pts: torch.Tensor):
    """The sphere of :func:`field_fn` at the origin plus big diffuse
    satellites out to radius ~7: content over an aabb_scale-16-class volume
    around a unit-scale subject."""
    flat = pts.reshape(-1, 3)
    rgb_c, sigma_c = field_fn(flat)
    sats = _table(_HALO_SATS, pts)
    d = torch.linalg.vector_norm(flat[:, None, :] - sats[None, :, :3], dim=-1)
    act = 1.0 / (1.0 + torch.exp((d - sats[None, :, 3]) * 10.0))  # (N, S)
    sigma_s = 30.0 * act.amax(dim=1)
    w = act / (act.sum(dim=1, keepdim=True) + 1e-9)
    rgb_s = w @ _table(_HALO_COLORS, pts)
    central = sigma_c >= sigma_s
    sigma = torch.where(central, sigma_c.to(sigma_s.dtype), sigma_s)
    rgb = torch.where(central[:, None], rgb_c.to(rgb_s.dtype), rgb_s)
    return (torch.clamp(rgb, 0.02, 0.98).reshape(*pts.shape[:-1], 3),
            sigma.reshape(pts.shape[:-1]))


FIELDS = {"sphere": field_fn, "blobs": field_fn_blobs, "halo": field_fn_halo}


def _render_gt(pose, H, W, focal, near, far, n_samples=192, field=field_fn,
               dist=None, device=None):
    """Analytic volume render of a ground-truth field along pinhole rays:
    (H, W, 3) f32 on ``device``. ``dist`` = (k1, k2, p1, p2) simulates
    capture through a distorting lens: pixel (i, j) observes along the ray
    of its undistorted coordinates."""
    dev = resolve_device(device)
    pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
    rays_o, rays_d = get_rays(H, W, focal, pose, dist=dist)
    # numpy's linspace and diff, as the reference computes them
    t_np = np.linspace(near, far, n_samples, dtype=np.float32)
    t = torch.from_numpy(t_np).to(dev)
    dists = torch.from_numpy(np.append(np.diff(t_np), 1e10).astype(np.float32)).to(dev)
    rows = max(1, CHUNK_POINTS // (W * n_samples))
    out = []
    for r0 in range(0, H, rows):
        o, d = rays_o[r0:r0 + rows], rays_d[r0:r0 + rows]
        pts = o[..., None, :] + d[..., None, :] * t[:, None]
        rgb, sigma = field(pts)
        dd = dists * torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-sigma * dd)
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
        weights = alpha * trans
        out.append((weights[..., None] * rgb).sum(dim=-2).to(torch.float32))
    return torch.cat(out)


def scene_poses(n_views: int, radius: float, device=None) -> torch.Tensor:
    """(n_views, 4, 4) f32: an orbit in the XY plane plus two elevated
    rings (z +-0.9, radius x 0.85) for vertical parallax, all aimed at the
    origin."""
    per_ring = max(-(-n_views // 3), 2)
    poses = []
    for z, r in ((0.0, radius), (0.9, radius * 0.85), (-0.9, radius * 0.85)):
        ring = generate_orbit_poses(torch.zeros(3, dtype=torch.float64), r,
                                    per_ring, device=device)
        ring[:, 2, 3] += z
        # re-aim at the origin from the shifted positions
        poses.append(_look_at_poses(ring[:, :3, 3], torch.zeros(3)))
    return torch.cat(poses)[:n_views].to(torch.float32)


def make_synthetic_scene(cfg=None, n_views: int = 12, resolution: int = 64,
                         radius: float = 2.0, near: float = 0.5, far: float = 3.5,
                         seed: int = 0, variant: str = "sphere", dist=None,
                         device=None) -> NerfDataset:
    """The synthetic dataset; ``cfg`` (a ``DatasetConfig``) may override
    ``near`` / ``far``. ``variant``: "sphere" (easy), "blobs" (many objects,
    high frequency) or "halo" (unit-scale subject and far satellites:
    cameras at radius 11, near 2.5, far 20 and aabb_scale 32, a bound-16
    scene). ``dist``: optional (k1, k2, p1, p2); the images are captured
    through that lens and the intrinsics carry it. The last two views are
    held out. ``seed`` is accepted as the reference accepts it; the scene
    draws nothing. Images and poses come back as numpy arrays (the
    dataset's types)."""
    del seed
    dev = resolve_device(device)
    aabb_scale = 1.0
    if variant == "halo":
        radius, near, far, aabb_scale = 11.0, 2.5, 20.0, 32.0
    if cfg is not None:
        near = float(getattr(cfg, "near", near))
        far = float(getattr(cfg, "far", far))
    field = FIELDS[variant]

    H = W = resolution
    focal = 0.9 * resolution
    poses = scene_poses(n_views, radius, device=dev)
    images = torch.stack([
        _render_gt(p, H, W, focal, near, far, field=field, dist=dist, device=dev)
        for p in poses
    ])

    k1, k2, p1, p2 = dist if dist is not None else (0.0, 0.0, 0.0, 0.0)
    idx = np.arange(n_views)
    return NerfDataset(
        images=images.cpu().numpy(),
        poses=poses.cpu().numpy(),
        intrinsics=Intrinsics(focal, focal, W / 2.0, H / 2.0, W, H,
                              k1=k1, k2=k2, p1=p1, p2=p2),
        near=near,
        far=far,
        train_idx=idx[:-2],
        val_idx=idx[-2:],
        use_ndc=False,
        aabb_scale=aabb_scale,
    )
