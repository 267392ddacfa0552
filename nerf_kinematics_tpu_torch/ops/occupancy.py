"""Occupancy grid: density-aware sample placement with static shapes.

A maintained EMA occupancy volume reweights each ray's uniform depth bins and
resamples them through the inverse CDF, so samples concentrate in occupied
space while every shape stays static.

Ported: the full-sweep update (:func:`update_grid`) and the visual-hull
proposal (``mode="hull"``). The ``grid`` / ``projected`` proposals and the
incremental update are not ported yet.

The grid is stored ``density[x, y, z]`` (axis 0 = x).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .occupancy_cuda import occupancy_at_hull_cuda, occupancy_at_hull_cuda_ref
from .sampling import _uniform, linspace, sample_pdf


class OccupancyGrid(NamedTuple):
    density: torch.Tensor  # (R, R, R) EMA of queried densities
    bound: torch.Tensor  # scalar: grid spans [-bound, bound]^3

    @property
    def resolution(self) -> int:
        return self.density.shape[0]


def init_grid(resolution: int = 128, bound: float = 1.0,
              device=None) -> OccupancyGrid:
    """Optimistic init (all-occupied) so early training sees everything."""
    return OccupancyGrid(
        density=torch.ones((resolution,) * 3, dtype=torch.float32, device=device),
        bound=torch.tensor(float(bound), dtype=torch.float32, device=device),
    )


def _linear_to_unit(grid: OccupancyGrid):
    return lambda pts: pts / (2.0 * grid.bound) + 0.5


def _linear_from_unit(grid: OccupancyGrid):
    return lambda u01: (u01 * 2.0 - 1.0) * grid.bound


def _cell_points(grid: OccupancyGrid, from_unit, generator=None, u=None):
    """World-space jittered cell-center points for every cell, (R^3, 3).
    ``u``: optional (R^3, 3) uniform draws in [0, 1) replacing the
    generator's."""
    R = grid.resolution
    dev = grid.density.device
    lin = (torch.arange(R, dtype=torch.float32, device=dev) + 0.5) / R
    xs, ys, zs = torch.meshgrid(lin, lin, lin, indexing="ij")
    u01 = torch.stack([xs, ys, zs], -1).reshape(-1, 3)
    jitter = (_uniform(u01.shape, u, generator, dev, torch.float32) - 0.5) / R
    return from_unit(torch.clamp(u01 + jitter, 0.0, 1.0))


def update_grid(
    grid: OccupancyGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    decay: float = 0.95,
    chunk: int = 65536,
    from_unit: Optional[Callable] = None,
    u: Optional[torch.Tensor] = None,
) -> OccupancyGrid:
    """Full-sweep EMA update: query density at one jittered point per cell
    and take max(decay * old, new), for all cells."""
    from_unit = from_unit or _linear_from_unit(grid)
    R = grid.resolution
    pts = _cell_points(grid, from_unit, generator=generator, u=u)
    with torch.no_grad():
        sigmas = torch.cat(
            [density_fn(pts[s : s + chunk]) for s in range(0, pts.shape[0], chunk)]
        )
    new = torch.maximum(grid.density * decay, sigmas.reshape(R, R, R))
    return grid._replace(density=new)


def pair_projections(grid: OccupancyGrid) -> torch.Tensor:
    """(3, R, R) per-axis-pair max-projections: Pxy (max over z), Pxz (max
    over y), Pyz (max over x): the visual-hull factorization of the grid."""
    d = grid.density
    return torch.stack([d.amax(dim=2), d.amax(dim=1), d.amax(dim=0)], dim=0)


def occupancy_at_hull(proj2: torch.Tensor, pts: torch.Tensor,
                      to_unit: Callable) -> torch.Tensor:
    """Visual-hull occupancy proxy at world points (..., 3) -> (...,):
    ``min(Pxy[x,y], Pxz[x,z], Pyz[y,z])`` at the nearest cell, the
    projections rounded to bf16. Channels-last form of the plain version."""
    xt = to_unit(pts).reshape(-1, 3).T
    return occupancy_at_hull_cuda_ref(proj2, xt).reshape(pts.shape[:-1])


def occupancy_proposal_hull(
    grid: OccupancyGrid,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    z_bins: torch.Tensor,
    floor: float = 1e-2,
    to_unit: Optional[Callable] = None,
) -> torch.Tensor:
    """Per-bin proposal weights from the visual-hull proxy at bin centers,
    normalized by the per-ray maximum, plus a uniform ``floor`` so unseen
    space keeps receiving samples. Returns (..., n_bins - 1) weights."""
    linear = to_unit is None
    to_unit = to_unit or _linear_to_unit(grid)
    proj2 = pair_projections(grid)
    mids = 0.5 * (z_bins[..., 1:] + z_bins[..., :-1])
    if linear and rays_o.dim() == 2:
        # Channels-first operand built directly: the default map is
        # elementwise, so it applies to a (3, N) array as well.
        pts_cf = (rays_o.T[:, :, None]
                  + rays_d.T[:, :, None] * mids[None, :, :])  # (3, R, B)
        xt = to_unit(pts_cf.reshape(3, -1)).contiguous()
        occ = occupancy_at_hull_cuda(proj2, xt).reshape(mids.shape)
    else:
        pts = rays_o[..., None, :] + rays_d[..., None, :] * mids[..., :, None]
        xt = to_unit(pts).reshape(-1, 3).T.contiguous()
        occ = occupancy_at_hull_cuda(proj2, xt).reshape(pts.shape[:-1])
    occ = occ / (torch.amax(occ, dim=-1, keepdim=True) + 1e-9)
    return occ + floor


def occupancy_sample(
    grid: OccupancyGrid,
    rays_o,
    rays_d,
    near,
    far,
    num_samples: int,
    num_bins: int = 64,
    deterministic: bool = False,
    to_unit: Optional[Callable] = None,
    mode: str = "hull",
    floor: float = 1e-2,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Occupancy-weighted depth sampling: uniform bins -> occupancy PDF ->
    inverse-CDF resample at stratified positions (sorted, no per-ray sort).
    Only ``mode="hull"`` is ported."""
    if mode != "hull":
        if mode in ("grid", "projected"):
            raise NotImplementedError(
                f"occupancy proposal mode {mode!r} is not ported yet "
                "(ROADMAP: update_grid_incremental and the grid / projected "
                "proposals)"
            )
        raise ValueError(
            f"unknown occupancy proposal mode {mode!r}; expected one of "
            "['grid', 'hull', 'projected']"
        )
    n_rays = rays_o.shape[0]
    bins = linspace(
        float(near), float(far), num_bins + 1, device=rays_o.device
    ).expand(n_rays, num_bins + 1)
    weights = occupancy_proposal_hull(
        grid, rays_o, rays_d, bins, to_unit=to_unit, floor=floor
    )
    return sample_pdf(
        bins, weights, num_samples, deterministic=deterministic,
        stratified_u=True, generator=generator, u=u,
    )
