"""Volume-rendering compositing for the fused (channels-first) path."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RenderOutputs(NamedTuple):
    rgb: torch.Tensor  # (..., 3)
    disp: torch.Tensor  # (...,)
    acc: torch.Tensor  # (...,)
    weights: torch.Tensor  # (..., S)
    depth: torch.Tensor  # (...,)


def raw2outputs_cf(
    raw4: torch.Tensor,
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    noise_std: float = 0.0,
    white_background: bool = False,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Composite per-sample radiance and density into per-ray maps.

    ``raw4``: (4, R*S), rgb logit rows 0-2, row 3 sigma **already
    exp-activated** by the fused kernel, points flattened ray-major. The
    relu below is therefore a no-op, and ``noise_std`` noise (standard
    normal draws from ``generator``, or ``noise`` of shape (R, S)) is added
    after the activation. alpha = 1 - exp(-relu(sigma) * delta); the last
    interval is 1e10 * ||d||; transmittance is the exclusive cumulative
    product of (1 - alpha + 1e-10)."""
    R, S = z_vals.shape[-2], z_vals.shape[-1]
    sigma = raw4[3, :].reshape(R, S)
    rgb_l = raw4[0:3, :].reshape(3, R, S)

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)

    if noise_std > 0.0:
        if noise is None:
            if generator is None:
                raise ValueError("noise_std > 0 requires a generator or noise")
            noise = torch.randn(sigma.shape, generator=generator,
                                dtype=sigma.dtype, device=generator.device)
        sigma = sigma + noise_std * noise.to(sigma.device)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)

    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    weights = alpha * trans  # (R, S)

    rgb = torch.sigmoid(rgb_l)  # (3, R, S)
    rgb_map = torch.einsum("rs,crs->rc", weights, rgb)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    disp_map = 1.0 / torch.clamp(
        depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10
    )
    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])

    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)
