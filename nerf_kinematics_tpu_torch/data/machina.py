"""The "machina" benchmark scene (400x400, lego-like): its analytic field,
the ground-truth volume renderer, the camera poses and the dataset writer.

A multi-part textured rig (a checkered plate with a stud grid, a cabin with
a carved window, two angled arms, a thin shell scoop, four gear-toothed
wheels, an exhaust stack) as a closed-form density / color field,
volume-rendered with the compositing the framework trains against and
written as a blender-format dataset (``transforms_{train,val,test}.json`` +
RGBA PNGs). The reference's generator is ``nerf_kinematics_tpu/data/
machina.py``, in jnp; this one is plain PyTorch and renders on the card in
chunks (``device=None``), or on the CPU when asked. Same field, same poses
(the same ``default_rng`` streams), same files; PNGs through the port's own
writer (``io/image.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..cameras.rays import get_rays
from ..ops.sampling import linspace
from .types import Intrinsics

# Matches nerf_synthetic/lego's horizontal FOV (transforms_train.json).
CAMERA_ANGLE_X = 0.6911112070083618
RADIUS = 4.0311289
NEAR, FAR = 2.0, 6.0

_SIGMA_MAX = 400.0
_SOFT = 0.005  # SDF -> density softness; edge width 0.02, about 3 px at 400

# Rays per chunk of the ground-truth renderer (times n_samples points).
GPU_CHUNK_RAYS = 16384
CPU_CHUNK_RAYS = 4096


# ---------------------------------------------------------------------------
# SDF primitives, broadcast over (..., 3) points
# ---------------------------------------------------------------------------
def _box(p, half):
    q = p.abs() - half
    outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(q.amax(dim=-1), max=0.0)
    return outside + inside


def _rot_y(p, angle):
    c, s = float(np.cos(angle)), float(np.sin(angle))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def _mix(t, a, b):
    """t * a + (1 - t) * b for a scalar field t and two colors."""
    return t[..., None] * a + (1 - t)[..., None] * b


def machina_field(pts: torch.Tensor):
    """Ground-truth field: (..., 3) points -> (rgb (..., 3) in [0, 1],
    sigma (...,) >= 0), on the points' device."""
    p = torch.as_tensor(pts, dtype=torch.float32)
    vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=p.device)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    sdfs, cols = [], []

    # -- base plate: checkered box
    sdfs.append(_box(p - vec(0.0, 0.0, -0.42), vec(0.95, 0.62, 0.05)))
    checker = torch.remainder(torch.floor(x * 5.0) + torch.floor(y * 5.0), 2.0)
    cols.append(_mix(checker, vec(0.13, 0.35, 0.16), vec(0.25, 0.55, 0.28)))

    # -- stud grid on the plate top (repeat-mod cylinders; fine geometry)
    lx = torch.remainder(x + 0.9 + 0.1, 0.2) - 0.1      # x pitch 0.2
    ly = torch.remainder(y + 0.5 + 0.125, 0.25) - 0.125  # y pitch 0.25
    r_stud = torch.sqrt(lx**2 + ly**2)
    d_stud = torch.maximum(r_stud - 0.055, (z + 0.345).abs() - 0.028)
    in_plate = (x.abs() < 0.86) & (y.abs() < 0.56)
    sdfs.append(torch.where(in_plate, d_stud, torch.full_like(d_stud, 1e3)))
    cols.append(vec(0.32, 0.68, 0.30).expand(p.shape))

    # -- cabin: yellow box with a carved window
    d_cab = _box(p - vec(-0.55, 0.0, -0.10), vec(0.26, 0.30, 0.27))
    d_win = _box(p - vec(-0.45, 0.0, 0.02), vec(0.24, 0.22, 0.12))
    sdfs.append(torch.maximum(d_cab, -d_win))
    band = 0.5 + 0.5 * torch.sin(24.0 * z)
    cols.append(_mix(band, vec(0.92, 0.76, 0.12), vec(0.70, 0.54, 0.05)))

    # -- two angled arm segments with diagonal hazard stripes
    d_arm_a = _box(_rot_y(p - vec(0.05, 0.0, 0.28), -0.6), vec(0.42, 0.075, 0.055))
    d_arm_b = _box(_rot_y(p - vec(0.60, 0.0, 0.34), 0.8), vec(0.33, 0.065, 0.05))
    stripe = 0.5 + 0.5 * torch.sin(28.0 * (x + z))
    col_arm = _mix(stripe, vec(0.90, 0.45, 0.08), vec(0.15, 0.12, 0.10))
    sdfs.extend([d_arm_a, d_arm_b])
    cols.extend([col_arm, col_arm])

    # -- scoop: thin spherical shell cut by a plane
    pc = p - vec(0.88, 0.0, 0.02)
    shell = (torch.linalg.vector_norm(pc, dim=-1) - 0.20).abs() - 0.025
    sdfs.append(torch.maximum(shell, pc[..., 2] - 0.06))
    glint = 0.5 + 0.25 * torch.sin(40.0 * pc[..., 0]) * torch.sin(40.0 * pc[..., 1])
    cols.append(glint[..., None] * vec(0.62, 0.63, 0.68))

    # -- four gear-toothed wheels (mirror trick: one evaluation, 4 wheels)
    wx = x.abs() - 0.55
    wy = y.abs() - 0.68
    wz = z + 0.33
    ang = torch.atan2(wz, wx)
    r_eff = 0.17 + 0.018 * torch.sin(9.0 * ang)
    sdfs.append(torch.maximum(torch.sqrt(wx**2 + wz**2) - r_eff, wy.abs() - 0.07))
    spoke = 0.5 + 0.5 * torch.sin(5.0 * ang)
    cols.append(_mix(spoke, vec(0.10, 0.10, 0.12), vec(0.45, 0.42, 0.40)))

    # -- exhaust stack
    sdfs.append(torch.maximum(
        torch.sqrt((x + 0.72) ** 2 + (y - 0.22) ** 2) - 0.05,
        (z - 0.28).abs() - 0.14,
    ))
    cols.append(vec(0.80, 0.16, 0.12).expand(p.shape))

    sdf_all = torch.stack(sdfs, dim=-1)         # (..., P)
    col_all = torch.stack(cols, dim=-2)         # (..., P, 3)
    part = torch.argmin(sdf_all, dim=-1)        # the first minimum, as jnp
    sdf = torch.gather(sdf_all, -1, part[..., None])[..., 0]
    idx = part[..., None, None].expand(*part.shape, 1, 3)
    rgb = torch.gather(col_all, -2, idx)[..., 0, :]
    sigma = _SIGMA_MAX / (1.0 + torch.exp(sdf / _SOFT))
    return torch.clamp(rgb, 0.0, 1.0), sigma


# ---------------------------------------------------------------------------
# Analytic volume renderer, chunked
# ---------------------------------------------------------------------------
def _render_ray_chunk(rays_o, rays_d, n_samples: int):
    t = linspace(NEAR, FAR, n_samples, device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    rgb, sigma = machina_field(pts)
    delta = (FAR - NEAR) / (n_samples - 1)
    dists = delta * torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = alpha * trans
    return (w[..., None] * rgb).sum(dim=-2), w.sum(dim=-1)


@torch.no_grad()
def render_view(c2w, H: int, W: int, focal, n_samples: int = 1024,
                device=None, chunk_rays: Optional[int] = None):
    """Render one ground-truth view on ``device`` (None: the GPU): returns
    (rgb composited on black (H, W, 3), alpha (H, W)), float32 tensors on
    that device. The samples are the blended ``linspace(NEAR, FAR, n)``."""
    dev = resolve_device(device)
    if chunk_rays is None:
        chunk_rays = GPU_CHUNK_RAYS if dev.type == "cuda" else CPU_CHUNK_RAYS
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    rays_o, rays_d = get_rays(H, W, focal, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    comps, accs = [], []
    for s in range(0, rays_o.shape[0], chunk_rays):
        comp, acc = _render_ray_chunk(rays_o[s:s + chunk_rays],
                                      rays_d[s:s + chunk_rays], n_samples)
        comps.append(comp)
        accs.append(acc)
    return torch.cat(comps).reshape(H, W, 3), torch.cat(accs).reshape(H, W)


# ---------------------------------------------------------------------------
# Pose synthesis (lego-like: random upper hemisphere train, orbit test)
# ---------------------------------------------------------------------------
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


def _on_sphere(radius, elev, azim) -> np.ndarray:
    return np.stack(
        [
            radius * np.cos(elev) * np.cos(azim),
            radius * np.cos(elev) * np.sin(azim),
            radius * np.sin(elev) * np.ones_like(azim),
        ],
        axis=1,
    )


def hemisphere_poses(n: int, seed: int = 0, radius: float = RADIUS,
                     elev_range=(3.0, 62.0)) -> np.ndarray:
    """n c2w poses on the upper hemisphere at fixed radius, looking at the
    origin: the nerf_synthetic train-view distribution."""
    rng = np.random.default_rng(seed)
    azim = rng.uniform(0.0, 2 * np.pi, n)
    elev = np.radians(rng.uniform(*elev_range, n))
    return _look_at_poses(_on_sphere(radius, elev, azim), np.zeros(3)).astype(np.float32)


def orbit_poses(n: int, elev_deg: float = 30.0, radius: float = RADIUS) -> np.ndarray:
    """(n, 4, 4) f32 poses on a circle at fixed elevation, looking at the
    origin."""
    theta = 2 * np.pi * np.arange(n) / n
    e = np.radians(elev_deg)
    return _look_at_poses(_on_sphere(radius, e, theta), np.zeros(3)).astype(np.float32)


def machina_intrinsics(size: int = 400) -> Intrinsics:
    """Pinhole intrinsics of a ``size x size`` machina view."""
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    return Intrinsics(fl_x=focal, fl_y=focal, cx=size / 2.0, cy=size / 2.0,
                      width=size, height=size)


# ---------------------------------------------------------------------------
# Dataset writer (blender format on disk)
# ---------------------------------------------------------------------------
def _marker_matches(marker: str, params: dict) -> bool:
    if not os.path.isfile(marker):
        return False
    with open(marker) as f:
        try:
            return json.load(f) == params
        except json.JSONDecodeError:
            return False


def write_machina_dataset(
    outdir: str,
    resolution: int = 400,
    n_train: int = 100,
    n_val: int = 8,
    n_test: int = 16,
    seed: int = 7,
    n_samples: int = 1024,
    force: bool = False,
    device=None,
) -> str:
    """Render and write the dataset as transforms_{train,val,test}.json +
    RGBA PNGs. Idempotent: nothing is rendered when a marker file with the
    same parameters exists (``force`` renders anyway). Returns ``outdir``."""
    from ..io.image import write_png

    marker = os.path.join(outdir, ".machina.json")
    params = {
        "resolution": resolution, "n_train": n_train, "n_val": n_val,
        "n_test": n_test, "seed": seed, "n_samples": n_samples, "version": 1,
    }
    if not force and _marker_matches(marker, params):
        return outdir

    H = W = resolution
    focal = 0.5 * W / np.tan(0.5 * CAMERA_ANGLE_X)
    splits = {
        "train": hemisphere_poses(n_train, seed=seed),
        "val": hemisphere_poses(n_val, seed=seed + 1),
        "test": orbit_poses(n_test),
    }
    for split, poses in splits.items():
        d = os.path.join(outdir, split)
        os.makedirs(d, exist_ok=True)
        frames = []
        for k, c2w in enumerate(poses):
            comp, acc = render_view(c2w, H, W, focal, n_samples, device=device)
            comp, acc = comp.cpu().numpy(), acc.cpu().numpy()
            # Un-premultiply, so that the loader's rgb * a + bg * (1 - a)
            # gives the analytic composite back (8-bit quantization aside).
            rgb = np.clip(comp / np.maximum(acc[..., None], 1e-6), 0.0, 1.0)
            rgba = np.concatenate([rgb, np.clip(acc, 0, 1)[..., None]], axis=-1)
            write_png(os.path.join(d, f"r_{k}.png"),
                      (rgba * 255).round().astype(np.uint8))
            frames.append({"file_path": f"./{split}/r_{k}",
                           "transform_matrix": c2w.tolist()})
        meta = {"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}
        with open(os.path.join(outdir, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    with open(marker, "w") as f:
        json.dump(params, f)
    return outdir
