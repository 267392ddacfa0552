"""Ray generation from camera intrinsics and camera-to-world poses.

Convention: OpenGL/NeRF camera -- x right, y up, camera looks along -z. A
pixel (i, j) (column i, row j) maps to the camera-space direction
``[(i - cx)/fl_x, -(j - cy)/fl_y, -1]``.
"""

from __future__ import annotations

import torch


def distort_normalized(x, y, k1, k2, p1, p2):
    """Forward OpenCV lens model on normalized camera coordinates (x right,
    y down, OpenCV's convention): undistorted -> distorted. Its inverse is
    :func:`undistort_normalized`."""
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def undistort_normalized(xd, yd, k1, k2, p1, p2, iters: int = 8):
    """Invert the OpenCV lens model by fixed-point iteration:
    x <- (xd - tangential(x)) / radial(x)."""
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * k2)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def pixel_dirs(i, j, fl_x, fl_y, cx, cy, dist=None) -> torch.Tensor:
    """Camera-space direction(s) for pixel coords (column ``i``, row ``j``).
    With ``dist`` = (k1, k2, p1, p2) the pixel grid is treated as distorted
    observations and undistorted first (OpenCV coords are y-down, so the y
    flip happens after)."""
    x = (i - cx) / fl_x
    y = (j - cy) / fl_y  # y-down (OpenCV) at this point
    if dist is not None:
        x, y = undistort_normalized(x, y, *dist)
    x, y = torch.broadcast_tensors(x, y)
    return torch.stack([x, -y, -torch.ones_like(x)], dim=-1)


def get_rays(H: int, W: int, focal, c2w, cx=None, cy=None, focal_y=None,
             dist=None):
    """Per-pixel ray origins and directions for a full image.

    ``c2w``: (4, 4) or (3, 4) camera-to-world tensor; the rays live on its
    device. Returns ``rays_o, rays_d``, each (H, W, 3); directions are not
    normalized (z-depth parameterization along -z)."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    dev = c2w.device
    cx = W * 0.5 if cx is None else cx
    cy = H * 0.5 if cy is None else cy
    fy = focal if focal_y is None else focal_y

    i = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs = pixel_dirs(i, j, focal, fy, cx, cy, dist=dist)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def get_ray_batch(pixels_ij, focal, c2w, cx, cy, focal_y=None, dist=None):
    """Rays for an (N, 2) batch of (row j, column i) pixel coordinates, on
    ``c2w``'s device. Returns (N, 3) origins and directions (not
    normalized)."""
    c2w = torch.as_tensor(c2w, dtype=torch.float32)
    pixels_ij = torch.as_tensor(pixels_ij, dtype=torch.float32, device=c2w.device)
    fy = focal if focal_y is None else focal_y
    j, i = pixels_ij[:, 0], pixels_ij[:, 1]
    dirs = pixel_dirs(i, j, focal, fy, cx, cy, dist=dist)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near, rays_o: torch.Tensor,
             rays_d: torch.Tensor):
    """Warp rays into NDC space for forward-facing (LLFF) scenes: shift the
    origins to the near plane, then apply the perspective projection, so the
    frustum maps to the [-1, 1] cube and t in [0, 1] spans near to infinity."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    ox, oy, oz = rays_o[..., 0], rays_o[..., 1], rays_o[..., 2]
    dx, dy, dz = rays_d[..., 0], rays_d[..., 1], rays_d[..., 2]
    o0 = -1.0 / (W / (2.0 * focal)) * ox / oz
    o1 = -1.0 / (H / (2.0 * focal)) * oy / oz
    o2 = 1.0 + 2.0 * near / oz
    d0 = -1.0 / (W / (2.0 * focal)) * (dx / dz - ox / oz)
    d1 = -1.0 / (H / (2.0 * focal)) * (dy / dz - oy / oz)
    d2 = -2.0 * near / oz
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)
