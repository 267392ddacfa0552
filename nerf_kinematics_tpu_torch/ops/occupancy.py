"""Occupancy grid: density-aware sample placement with static shapes.

A maintained EMA occupancy volume reweights each ray's uniform depth bins and
resamples them through the inverse CDF, so samples concentrate in occupied
space while every shape stays static.

Maintenance: the full sweep (:func:`update_grid`) and the incremental decay
and requery (:func:`update_grid_incremental`). Proposals
(:func:`occupancy_sample`'s ``mode``): ``"hull"``, the visual-hull proxy of
the three pair projections (row 1's kernel); ``"grid"``, the grid itself at
the nearest cell; ``"projected"``, the separable proxy of the three axis
projections. The last two are gathers in plain PyTorch: the reference's
one-hot matmuls stand in for a gather on its chip, and give the gather's
numbers, including the bf16 rounding of the projections.

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


def update_grid_incremental(
    grid: OccupancyGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    generator: Optional[torch.Generator] = None,
    n_cells: int = 65536,
    decay: float = 0.95,
    from_unit: Optional[Callable] = None,
    idx: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
) -> OccupancyGrid:
    """Steady-state maintenance between full sweeps: decay every cell,
    re-query ``n_cells`` uniformly random cells at one jittered point each and
    scatter-max the fresh densities in. Draw order from ``generator``: the
    cell indices, then the jitter; ``idx`` (n_cells,) int64 flat indices
    (x * R^2 + y * R + z) and ``u`` (n_cells, 3) uniforms replace them."""
    from_unit = from_unit or _linear_from_unit(grid)
    R = grid.resolution
    dev = grid.density.device
    if idx is None:
        gdev = generator.device if generator is not None else dev
        idx = torch.randint(0, R * R * R, (n_cells,), generator=generator,
                            device=gdev)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    ix, rem = idx // (R * R), idx % (R * R)
    iy, iz = rem // R, rem % R
    centers = (torch.stack([ix, iy, iz], -1).to(torch.float32) + 0.5) / R
    jitter = (_uniform(centers.shape, u, generator, dev, torch.float32) - 0.5) / R
    pts = from_unit(torch.clamp(centers + jitter, 0.0, 1.0))
    with torch.no_grad():
        sigmas = density_fn(pts).to(torch.float32)
    new = (grid.density * decay).reshape(-1).scatter_reduce(
        0, idx, sigmas, reduce="amax", include_self=True)
    return grid._replace(density=new.reshape(R, R, R))


def occupancy_at(grid: OccupancyGrid, pts: torch.Tensor,
                 to_unit: Optional[Callable] = None) -> torch.Tensor:
    """Trilinear occupancy lookup at world points (..., 3) -> (...,), between
    cell centres, clamped to the outer centres. A NaN coordinate gives NaN
    (its weights are NaN; the gather takes cell 0); +-inf the outer
    centres."""
    to_unit = to_unit or _linear_to_unit(grid)
    R = grid.resolution
    u = torch.clamp(to_unit(pts) * R - 0.5, 0.0, R - 1.0)  # cell-centre coords
    fl = torch.floor(u)
    i0 = torch.clamp(torch.where(torch.isnan(fl), 0.0, fl), 0, R - 2).to(torch.int64)
    w = u - i0
    d = grid.density
    out = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                v = d[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]
                wx = w[..., 0] if dx else 1.0 - w[..., 0]
                wy = w[..., 1] if dy else 1.0 - w[..., 1]
                wz = w[..., 2] if dz else 1.0 - w[..., 2]
                out = out + v * wx * wy * wz
    return out


def occupancy_at_nearest(grid: OccupancyGrid, pts: torch.Tensor,
                         to_unit: Optional[Callable] = None) -> torch.Tensor:
    """Occupancy of the cell holding each world point (..., 3) -> (...,):
    one gather a point. The cell index is the unit coordinate times R
    truncated toward zero, clamped to the grid, as the reference's int32
    cast gives it: a NaN coordinate takes cell 0 on its axis, +inf the last
    cell, -inf the first."""
    to_unit = to_unit or _linear_to_unit(grid)
    R = grid.resolution
    t = torch.trunc(to_unit(pts) * R)
    idx = torch.clamp(torch.where(torch.isnan(t), 0.0, t), 0, R - 1).to(torch.int64)
    flat = idx[..., 0] * (R * R) + idx[..., 1] * R + idx[..., 2]
    return grid.density.reshape(-1)[flat]


def axis_projections(grid: OccupancyGrid) -> torch.Tensor:
    """(R, 3) per-axis max-projections: ``proj[t, a]`` is the largest density
    of the slab at index t of axis a, an upper bound of the occupancy along
    each axis."""
    d = grid.density
    return torch.stack([d.amax(dim=(1, 2)), d.amax(dim=(0, 2)), d.amax(dim=(0, 1))],
                       dim=-1)


def occupancy_at_projected(proj: torch.Tensor, pts: torch.Tensor,
                           to_unit: Callable) -> torch.Tensor:
    """Separable occupancy proxy at world points (..., 3) -> (...,):
    ``min(px[x], py[y], pz[z])`` at the nearest cell, an upper bound of the
    grid's occupancy, with the projections rounded to bf16 as the
    reference's one-hot lookup reads them. A NaN coordinate reads 0 on its
    axis (no cell matches it), so the point's minimum is at most 0; +-inf
    read the end cells."""
    R = proj.shape[0]
    idx = torch.floor(torch.clamp(to_unit(pts) * R, 0.0, R - 1.0)).reshape(-1, 3)
    nan = torch.isnan(idx)
    rows = torch.where(nan, 0.0, idx).to(torch.int64)
    table = proj.to(torch.bfloat16).to(torch.float32)
    vals = torch.gather(table, 0, rows)  # (P, 3): table[rows[p, a], a]
    vals = torch.where(nan, torch.zeros_like(vals), vals)
    return torch.amin(vals, dim=-1).reshape(pts.shape[:-1])


def _bin_points(rays_o, rays_d, z_bins):
    mids = 0.5 * (z_bins[..., 1:] + z_bins[..., :-1])
    return rays_o[..., None, :] + rays_d[..., None, :] * mids[..., :, None]


def _proposal_weights(occ: torch.Tensor, floor: float) -> torch.Tensor:
    occ = occ / (torch.amax(occ, dim=-1, keepdim=True) + 1e-9)
    return occ + floor


def occupancy_proposal(grid: OccupancyGrid, rays_o: torch.Tensor,
                       rays_d: torch.Tensor, z_bins: torch.Tensor,
                       floor: float = 1e-2,
                       to_unit: Optional[Callable] = None) -> torch.Tensor:
    """Per-bin proposal weights from the grid at bin centres (nearest cell,
    :func:`occupancy_at_nearest`), normalized by the per-ray maximum, plus a
    uniform ``floor`` so unseen space keeps receiving samples. Returns
    (..., n_bins - 1) weights."""
    pts = _bin_points(rays_o, rays_d, z_bins)
    return _proposal_weights(occupancy_at_nearest(grid, pts, to_unit=to_unit), floor)


def occupancy_proposal_projected(grid: OccupancyGrid, rays_o: torch.Tensor,
                                 rays_d: torch.Tensor, z_bins: torch.Tensor,
                                 floor: float = 1e-2,
                                 to_unit: Optional[Callable] = None) -> torch.Tensor:
    """Per-bin proposal weights from the separable proxy
    (:func:`occupancy_at_projected`); the contract of
    :func:`occupancy_proposal`."""
    to_unit = to_unit or _linear_to_unit(grid)
    pts = _bin_points(rays_o, rays_d, z_bins)
    occ = occupancy_at_projected(axis_projections(grid), pts, to_unit)
    return _proposal_weights(occ, floor)


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
    return _proposal_weights(occ, floor)


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
    ``mode``: "hull" (the pair-projection proxy, row 1's kernel), "grid"
    (the grid at the nearest cell) or "projected" (the axis-projection
    proxy). ``u`` (n_rays, num_samples) replaces the generator's jitter."""
    proposals = {
        "grid": occupancy_proposal,
        "projected": occupancy_proposal_projected,
        "hull": occupancy_proposal_hull,
    }
    if mode not in proposals:
        raise ValueError(
            f"unknown occupancy proposal mode {mode!r}; expected one of "
            f"{sorted(proposals)}"
        )
    n_rays = rays_o.shape[0]
    bins = linspace(
        float(near), float(far), num_bins + 1, device=rays_o.device
    ).expand(n_rays, num_bins + 1)
    weights = proposals[mode](grid, rays_o, rays_d, bins, to_unit=to_unit, floor=floor)
    return sample_pdf(
        bins, weights, num_samples, deterministic=deterministic,
        stratified_u=True, generator=generator, u=u,
    )
