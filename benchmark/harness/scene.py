"""The benchmark's scenes, made once per checkout and cached on disk.

Frozen copies, at commit 83f8678 of this repository, of:

  * ``nerf_kinematics_tpu_torch/data/machina.py``: ``machina_field`` and its
    SDF helpers, ``_render_ray_chunk`` / ``render_view`` (the ground-truth
    renderer), ``hemisphere_poses`` / ``_look_at_poses`` / ``_on_sphere``,
    ``CAMERA_ANGLE_X``, ``RADIUS``, ``NEAR``, ``FAR``;
  * ``nerf_kinematics_tpu_torch/data/synthetic.py``: ``field_fn``,
    ``field_fn_halo``, ``_render_gt``, ``scene_poses`` and the halo variant
    of ``make_synthetic_scene``;
  * ``nerf_kinematics_tpu_torch/poses/orbit.py``: ``_look_at_poses``,
    ``generate_orbit_poses``;
  * ``nerf_kinematics_tpu_torch/cameras/rays.py``: ``get_rays`` and
    ``pixel_dirs`` for a pinhole camera;
  * ``nerf_kinematics_tpu_torch/ops/sampling.py``: ``linspace``.

They import nothing of the program, so a later change to the program's data
modules cannot change what the benchmark trains on. A scene is written into
``benchmark/cache/scenes/<name>/`` behind a lock and an atomic rename; later
runs in the same checkout load it.

Machina is kept as the 8-bit RGBA its PNG files would hold, and composited
onto the background when loaded, as ``data/blender.py`` does; the halo scene
is kept as the float32 images ``make_synthetic_scene`` returns.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import shutil

import numpy as np
import torch

SCENES_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "cache", "scenes")

# ---------------------------------------------------------------- cameras


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """``num`` values from ``start`` to ``stop`` as the blend
    ``start * (1 - i/(num-1)) + stop * (i/(num-1))``, the end set exactly."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = float(start) * (1.0 - step) + float(stop) * step
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def pixel_dirs(i, j, fl_x, fl_y, cx, cy) -> torch.Tensor:
    """Camera-space directions of pixel columns ``i`` and rows ``j``."""
    x = (i - cx) / fl_x
    y = (j - cy) / fl_y
    x, y = torch.broadcast_tensors(x, y)
    return torch.stack([x, -y, -torch.ones_like(x)], dim=-1)


def get_rays(H: int, W: int, focal, c2w, cx=None, cy=None, focal_y=None):
    """Per-pixel origins and directions (H, W, 3) of a pinhole view."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    cx = W * 0.5 if cx is None else cx
    cy = H * 0.5 if cy is None else cy
    fy = focal if focal_y is None else focal_y
    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    rays_d = pixel_dirs(i, j, focal, fy, cx, cy) @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def look_at_np(positions: np.ndarray, center: np.ndarray) -> np.ndarray:
    """(N, 4, 4) camera-to-world matrices looking from ``positions`` at
    ``center``, world up +Z; columns [right, up, -forward, position]."""
    forward = center[None, :] - positions
    forward = forward / np.linalg.norm(forward, axis=1, keepdims=True)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0])[None, :])
    right = right / np.linalg.norm(right, axis=1, keepdims=True)
    up = np.cross(right, forward)
    poses = np.zeros((positions.shape[0], 4, 4))
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up
    poses[:, :3, 2] = -forward
    poses[:, :3, 3] = positions
    poses[:, 3, 3] = 1.0
    return poses


def on_sphere(radius, elev, azim) -> np.ndarray:
    return np.stack([radius * np.cos(elev) * np.cos(azim),
                     radius * np.cos(elev) * np.sin(azim),
                     radius * np.sin(elev) * np.ones_like(azim)], axis=1)


def _look_at_torch(positions: torch.Tensor, center) -> torch.Tensor:
    positions = torch.as_tensor(positions, dtype=torch.float64)
    center = torch.as_tensor(center, dtype=torch.float64, device=positions.device)
    forward = center[None, :] - positions
    forward = forward / torch.linalg.norm(forward, dim=1, keepdim=True)
    world_up = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=positions.device)
    right = torch.linalg.cross(forward, world_up.expand_as(forward), dim=1)
    right = right / torch.linalg.norm(right, dim=1, keepdim=True)
    up = torch.linalg.cross(right, forward, dim=1)
    poses = torch.zeros((positions.shape[0], 4, 4), dtype=torch.float64,
                        device=positions.device)
    poses[:, :3, 0] = right
    poses[:, :3, 1] = up
    poses[:, :3, 2] = -forward
    poses[:, :3, 3] = positions
    poses[:, 3, 3] = 1.0
    return poses


def _orbit_torch(radius: float, n: int, device) -> torch.Tensor:
    center = torch.zeros(3, dtype=torch.float64, device=device)
    theta = 2.0 * math.pi * torch.arange(n, dtype=torch.float64, device=device) / n
    positions = torch.stack([radius * torch.cos(theta), radius * torch.sin(theta),
                             torch.zeros_like(theta)], dim=1)
    return _look_at_torch(positions, center)


# ---------------------------------------------------------------- machina

CAMERA_ANGLE_X = 0.6911112070083618
RADIUS = 4.0311289
NEAR, FAR = 2.0, 6.0
_SIGMA_MAX = 400.0
_SOFT = 0.005


def _box(p, half):
    q = p.abs() - half
    outside = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1)
    return outside + torch.clamp(q.amax(dim=-1), max=0.0)


def _rot_y(p, angle):
    c, s = float(np.cos(angle)), float(np.sin(angle))
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([c * x + s * z, y, -s * x + c * z], dim=-1)


def _mix(t, a, b):
    return t[..., None] * a + (1 - t)[..., None] * b


def machina_field(pts: torch.Tensor):
    """(..., 3) points -> (rgb in [0, 1], sigma >= 0)."""
    p = torch.as_tensor(pts, dtype=torch.float32)
    vec = lambda *v: torch.tensor(v, dtype=torch.float32, device=p.device)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    sdfs, cols = [], []
    sdfs.append(_box(p - vec(0.0, 0.0, -0.42), vec(0.95, 0.62, 0.05)))
    checker = torch.remainder(torch.floor(x * 5.0) + torch.floor(y * 5.0), 2.0)
    cols.append(_mix(checker, vec(0.13, 0.35, 0.16), vec(0.25, 0.55, 0.28)))
    lx = torch.remainder(x + 0.9 + 0.1, 0.2) - 0.1
    ly = torch.remainder(y + 0.5 + 0.125, 0.25) - 0.125
    d_stud = torch.maximum(torch.sqrt(lx**2 + ly**2) - 0.055, (z + 0.345).abs() - 0.028)
    in_plate = (x.abs() < 0.86) & (y.abs() < 0.56)
    sdfs.append(torch.where(in_plate, d_stud, torch.full_like(d_stud, 1e3)))
    cols.append(vec(0.32, 0.68, 0.30).expand(p.shape))
    d_cab = _box(p - vec(-0.55, 0.0, -0.10), vec(0.26, 0.30, 0.27))
    d_win = _box(p - vec(-0.45, 0.0, 0.02), vec(0.24, 0.22, 0.12))
    sdfs.append(torch.maximum(d_cab, -d_win))
    band = 0.5 + 0.5 * torch.sin(24.0 * z)
    cols.append(_mix(band, vec(0.92, 0.76, 0.12), vec(0.70, 0.54, 0.05)))
    d_arm_a = _box(_rot_y(p - vec(0.05, 0.0, 0.28), -0.6), vec(0.42, 0.075, 0.055))
    d_arm_b = _box(_rot_y(p - vec(0.60, 0.0, 0.34), 0.8), vec(0.33, 0.065, 0.05))
    stripe = 0.5 + 0.5 * torch.sin(28.0 * (x + z))
    col_arm = _mix(stripe, vec(0.90, 0.45, 0.08), vec(0.15, 0.12, 0.10))
    sdfs.extend([d_arm_a, d_arm_b])
    cols.extend([col_arm, col_arm])
    pc = p - vec(0.88, 0.0, 0.02)
    shell = (torch.linalg.vector_norm(pc, dim=-1) - 0.20).abs() - 0.025
    sdfs.append(torch.maximum(shell, pc[..., 2] - 0.06))
    glint = 0.5 + 0.25 * torch.sin(40.0 * pc[..., 0]) * torch.sin(40.0 * pc[..., 1])
    cols.append(glint[..., None] * vec(0.62, 0.63, 0.68))
    wx, wy, wz = x.abs() - 0.55, y.abs() - 0.68, z + 0.33
    ang = torch.atan2(wz, wx)
    r_eff = 0.17 + 0.018 * torch.sin(9.0 * ang)
    sdfs.append(torch.maximum(torch.sqrt(wx**2 + wz**2) - r_eff, wy.abs() - 0.07))
    spoke = 0.5 + 0.5 * torch.sin(5.0 * ang)
    cols.append(_mix(spoke, vec(0.10, 0.10, 0.12), vec(0.45, 0.42, 0.40)))
    sdfs.append(torch.maximum(torch.sqrt((x + 0.72) ** 2 + (y - 0.22) ** 2) - 0.05,
                              (z - 0.28).abs() - 0.14))
    cols.append(vec(0.80, 0.16, 0.12).expand(p.shape))
    sdf_all = torch.stack(sdfs, dim=-1)
    col_all = torch.stack(cols, dim=-2)
    part = torch.argmin(sdf_all, dim=-1)
    sdf = torch.gather(sdf_all, -1, part[..., None])[..., 0]
    idx = part[..., None, None].expand(*part.shape, 1, 3)
    rgb = torch.gather(col_all, -2, idx)[..., 0, :]
    sigma = _SIGMA_MAX / (1.0 + torch.exp(sdf / _SOFT))
    return torch.clamp(rgb, 0.0, 1.0), sigma


def _machina_chunk(rays_o, rays_d, n_samples: int):
    t = linspace(NEAR, FAR, n_samples, device=rays_o.device)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * t[:, None]
    rgb, sigma = machina_field(pts)
    dists = (FAR - NEAR) / (n_samples - 1) * torch.linalg.vector_norm(
        rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = alpha * trans
    return (w[..., None] * rgb).sum(dim=-2), w.sum(dim=-1)


@torch.no_grad()
def machina_view(c2w, size: int, n_samples: int, device, chunk_rays: int):
    """One ground-truth view: (composite on black (H, W, 3), alpha (H, W))."""
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    rays_o, rays_d = get_rays(size, size, focal, c2w)
    rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    comps, accs = [], []
    for s in range(0, rays_o.shape[0], chunk_rays):
        comp, acc = _machina_chunk(rays_o[s:s + chunk_rays], rays_d[s:s + chunk_rays],
                                   n_samples)
        comps.append(comp)
        accs.append(acc)
    return torch.cat(comps).reshape(size, size, 3), torch.cat(accs).reshape(size, size)


def hemisphere_poses(n: int, seed: int, radius: float = RADIUS,
                     elev_range=(3.0, 62.0)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    azim = rng.uniform(0.0, 2 * np.pi, n)
    elev = np.radians(rng.uniform(*elev_range, n))
    return look_at_np(on_sphere(radius, elev, azim), np.zeros(3)).astype(np.float32)


def make_machina(p: dict, device) -> dict:
    """The train views of the machina scene: 8-bit RGBA as its PNGs hold."""
    size, n = int(p["resolution"]), int(p["n_train"])
    poses = hemisphere_poses(n, seed=int(p["seed"]))
    chunk = 16384 if torch.device(device).type == "cuda" else 4096
    rgba = np.empty((n, size, size, 4), np.uint8)
    for k, c2w in enumerate(poses):
        comp, acc = machina_view(c2w, size, int(p["n_samples"]), device, chunk)
        comp, acc = comp.cpu().numpy(), acc.cpu().numpy()
        rgb = np.clip(comp / np.maximum(acc[..., None], 1e-6), 0.0, 1.0)
        rgba[k] = (np.concatenate([rgb, np.clip(acc, 0, 1)[..., None]], -1) * 255
                   ).round().astype(np.uint8)
    focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
    return {"rgba": rgba, "poses": poses,
            "intrinsics": np.array([focal, focal, size / 2.0, size / 2.0, size, size]),
            "near_far_aabb": np.array([NEAR, FAR, 1.0])}


# ---------------------------------------------------------------- halo

_HALO_SATS = np.array([[6.0, 0.0, 1.0, 1.2], [-5.0, 4.0, -1.0, 1.0],
                       [0.0, -6.5, 2.0, 1.4], [-3.5, -4.5, -2.0, 0.9]])
_HALO_COLORS = np.array([[0.9, 0.3, 0.2], [0.2, 0.8, 0.4], [0.25, 0.35, 0.9],
                         [0.9, 0.8, 0.2]])
_HALO_CHUNK_POINTS = 1 << 22


def _sphere_field(pts):
    r = torch.linalg.vector_norm(pts, dim=-1)
    sigma = 40.0 / (1.0 + torch.exp((r - 0.5) * 30.0))
    return torch.clamp(0.5 + pts, 0.05, 0.95), sigma


def halo_field(pts: torch.Tensor):
    flat = pts.reshape(-1, 3)
    rgb_c, sigma_c = _sphere_field(flat)
    sats = torch.as_tensor(_HALO_SATS, dtype=torch.float64, device=pts.device)
    d = torch.linalg.vector_norm(flat[:, None, :] - sats[None, :, :3], dim=-1)
    act = 1.0 / (1.0 + torch.exp((d - sats[None, :, 3]) * 10.0))
    sigma_s = 30.0 * act.amax(dim=1)
    w = act / (act.sum(dim=1, keepdim=True) + 1e-9)
    rgb_s = w @ torch.as_tensor(_HALO_COLORS, dtype=torch.float64, device=pts.device)
    central = sigma_c >= sigma_s
    sigma = torch.where(central, sigma_c.to(sigma_s.dtype), sigma_s)
    rgb = torch.where(central[:, None], rgb_c.to(rgb_s.dtype), rgb_s)
    return (torch.clamp(rgb, 0.02, 0.98).reshape(*pts.shape[:-1], 3),
            sigma.reshape(pts.shape[:-1]))


@torch.no_grad()
def _halo_view(pose, H, W, focal, near, far, n_samples, device):
    pose = torch.as_tensor(pose, dtype=torch.float32, device=device)
    rays_o, rays_d = get_rays(H, W, focal, pose)
    t_np = np.linspace(near, far, n_samples, dtype=np.float32)
    t = torch.from_numpy(t_np).to(device)
    dists = torch.from_numpy(np.append(np.diff(t_np), 1e10).astype(np.float32)).to(device)
    rows = max(1, _HALO_CHUNK_POINTS // (W * n_samples))
    out = []
    for r0 in range(0, H, rows):
        o, d = rays_o[r0:r0 + rows], rays_d[r0:r0 + rows]
        rgb, sigma = halo_field(o[..., None, :] + d[..., None, :] * t[:, None])
        alpha = 1.0 - torch.exp(-sigma * (dists * torch.linalg.vector_norm(
            d, dim=-1, keepdim=True)))
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
        out.append(((alpha * trans)[..., None] * rgb).sum(dim=-2).to(torch.float32))
    return torch.cat(out)


def halo_poses(n_views: int, radius: float, device) -> torch.Tensor:
    per_ring = max(-(-n_views // 3), 2)
    poses = []
    for z, r in ((0.0, radius), (0.9, radius * 0.85), (-0.9, radius * 0.85)):
        ring = _orbit_torch(r, per_ring, device)
        ring[:, 2, 3] += z
        poses.append(_look_at_torch(ring[:, :3, 3], torch.zeros(3)))
    return torch.cat(poses)[:n_views].to(torch.float32)


def make_halo(p: dict, device) -> dict:
    """The halo scene's train views (its last two views are held out, as
    ``make_synthetic_scene`` holds them out, and are not made)."""
    res, n_views = int(p["resolution"]), int(p["n_views"])
    radius, near, far, aabb = 11.0, 2.5, 20.0, 32.0
    focal = 0.9 * res
    poses = halo_poses(n_views, radius, device)[: n_views - 2]
    images = torch.stack([_halo_view(q, res, res, focal, near, far, 192, device)
                          for q in poses])
    return {"images": images.cpu().numpy(), "poses": poses.cpu().numpy(),
            "intrinsics": np.array([focal, focal, res / 2.0, res / 2.0, res, res]),
            "near_far_aabb": np.array([near, far, aabb])}


GENERATORS = {"machina": make_machina, "halo": make_halo}


# ---------------------------------------------------------------- the cache


def scene_key(spec: dict) -> str:
    return spec["name"] + "-" + "-".join(f"{k}{spec['params'][k]}"
                                         for k in sorted(spec["params"]))


def load_scene(spec: dict, device, root: str = None) -> dict:
    """The scene ``spec`` names ({"generator", "name", "params",
    "background"}), made on ``device`` when the cache has none. Returns
    {"images" (N, H, W, 3) f32 composited, "poses" (N, 4, 4) f32,
    "intrinsics" [fl_x, fl_y, cx, cy, W, H], "near", "far", "aabb_scale"}."""
    root = root or SCENES_DIR
    path = os.path.join(root, scene_key(spec))
    if not os.path.isfile(os.path.join(path, "done.json")):
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isfile(os.path.join(path, "done.json")):
                arrays = GENERATORS[spec["generator"]](spec["params"], device)
                tmp = path + ".partial"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                for k, v in arrays.items():
                    np.save(os.path.join(tmp, k + ".npy"), v)
                with open(os.path.join(tmp, "done.json"), "w") as f:
                    json.dump(spec, f)
                os.rename(tmp, path)
    arrays = {k: np.load(os.path.join(path, k + ".npy"))
              for k in ("poses", "intrinsics", "near_far_aabb")}
    if os.path.isfile(os.path.join(path, "rgba.npy")):
        rgba = np.load(os.path.join(path, "rgba.npy")).astype(np.float32) / 255.0
        rgb, a = rgba[..., :3], rgba[..., 3:]
        bg = 1.0 if spec.get("background") == "white" else 0.0
        images = (rgb * a + bg * (1.0 - a)).astype(np.float32)
    else:
        images = np.load(os.path.join(path, "images.npy"))
    near, far, aabb = (float(v) for v in arrays["near_far_aabb"])
    return {"images": images, "poses": arrays["poses"].astype(np.float32),
            "intrinsics": [float(v) for v in arrays["intrinsics"]],
            "near": near, "far": far, "aabb_scale": aabb}


def camera(spec: dict, resolution: int) -> dict:
    """The scene's camera at ``resolution`` pixels square, without making
    the scene: {"intrinsics", "near", "far", "aabb_scale"}."""
    if spec["generator"] == "machina":
        focal = 0.5 * resolution / np.tan(0.5 * CAMERA_ANGLE_X)
        near, far, aabb = NEAR, FAR, 1.0
    elif spec["generator"] == "halo":
        focal, near, far, aabb = 0.9 * resolution, 2.5, 20.0, 32.0
    else:
        raise ValueError(f"unknown scene generator {spec['generator']!r}")
    return {"intrinsics": [focal, focal, resolution / 2.0, resolution / 2.0,
                           resolution, resolution],
            "near": near, "far": far, "aabb_scale": aabb}
