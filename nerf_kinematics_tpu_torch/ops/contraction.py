"""Scene contraction for large-AABB scenes (``aabb_scale`` > 2): one smooth
coordinate map in place of instant-ngp's nested occupancy cascades (the
mip-NeRF 360 idea in the L-infinity norm, so the image is a cube):

    contract(x) = x                          |x|inf <= 1
                  (2 - 1/|x|inf) x / |x|inf  |x|inf >  1

maps all of R^3 into [-2, 2]^3: the central box keeps half of each grid
axis and every doubling of distance costs a constant slab of cells. The
occupancy grid and the feature-grid encoder both work in contracted space.

Counterpart of ``nerf_kinematics_tpu/ops/contraction.py``: elementwise maps
of ``(..., 3)`` tensors (the norm is over the last axis; a channels-first
operand must be transposed first).
"""

from __future__ import annotations

import torch

_EPS = 1e-9
_MAX = 2.0 - 1e-6  # contracted coordinates never quite reach the boundary


def contract(pts: torch.Tensor, inner: float = 1.0) -> torch.Tensor:
    """World points (..., 3) -> contracted coordinates in [-2, 2]^3.
    ``inner``: half-width (world units) of the central linear region, which
    maps onto [-1, 1]^3."""
    x = pts / inner
    n = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=_EPS)
    scale = torch.where(n <= 1.0, torch.ones_like(n), (2.0 - 1.0 / n) / n)
    return x * scale


def uncontract(u: torch.Tensor, inner: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`contract`. For |u|inf = m in (1, 2),
    x = u / (m (2 - m)); m is clamped just below 2 so that cells on the
    outer boundary map to finite (far) points."""
    m = torch.clamp(u.abs().amax(dim=-1, keepdim=True), _EPS, _MAX)
    scale = torch.where(m <= 1.0, torch.ones_like(m), 1.0 / (m * (2.0 - m)))
    return u * scale * inner


def contract_to_unit(pts: torch.Tensor, inner: float = 1.0) -> torch.Tensor:
    """World points -> [0, 1]^3 (the contracted cube rescaled): the
    coordinate the encoders and the occupancy grid take."""
    return contract(pts, inner) * 0.25 + 0.5


def unit_to_world(u01: torch.Tensor, inner: float = 1.0) -> torch.Tensor:
    """Inverse of :func:`contract_to_unit`."""
    return uncontract((u01 - 0.5) * 4.0, inner)
