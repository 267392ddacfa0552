"""Depth samplers: stratified (coarse) and inverse-CDF importance (fine).

Statically shaped and batched over rays. Random draws come from an explicit
``torch.Generator`` or are passed in as ``u`` (uniform in [0, 1), the shape the
function would draw), so a test can hand both packages the same numbers.
"""

from __future__ import annotations

from typing import Optional

import torch


def linspace(start: float, stop: float, num: int, device=None,
             dtype=torch.float32) -> torch.Tensor:
    """``num`` evenly spaced values from ``start`` to ``stop`` inclusive, as
    the blend ``start * (1 - i/(num-1)) + stop * (i/(num-1))`` with the end
    point set exactly: the reference's formula, so depth grids and bin edges
    of both packages agree to within one unit in the last place."""
    if num == 1:
        return torch.full((1,), float(start), dtype=dtype, device=device)
    div = num - 1
    step = torch.arange(div, dtype=dtype, device=device) / div
    out = float(start) * (1.0 - step) + float(stop) * step
    return torch.cat([out, torch.full((1,), float(stop), dtype=dtype, device=device)])


def _uniform(shape, u, generator, device, dtype):
    if u is not None:
        return torch.as_tensor(u, dtype=dtype, device=device).reshape(shape)
    if generator is not None:
        # A generator lives on one device; draw there, then move.
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=generator.device).to(device)
    return torch.rand(shape, dtype=dtype, device=device)


def stratified_sample(
    n_rays: int,
    num_samples: int,
    near,
    far,
    perturb: bool = True,
    lindisp: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """(n_rays, num_samples) depth values t in [near, far].

    Bin midpoints are evenly spaced in depth (or in disparity when
    ``lindisp``); with ``perturb``, one uniform jitter per bin per ray.
    ``near`` / ``far`` may be scalars or (n_rays,) tensors."""
    t = linspace(0.0, 1.0, num_samples, device=device, dtype=dtype)
    near = torch.as_tensor(near, dtype=dtype, device=device)
    far = torch.as_tensor(far, dtype=dtype, device=device)
    if near.dim() > 0:
        near = near[..., None]
    if far.dim() > 0:
        far = far[..., None]
    if lindisp:
        z = 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)
    else:
        z = near * (1.0 - t) + far * t
    z = z.expand(n_rays, num_samples)
    if perturb:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        r = _uniform(z.shape, u, generator, z.device, dtype)
        z = lower + (upper - lower) * r
    return z


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    deterministic: bool = False,
    stratified_u: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inverse-transform sampling from a piecewise-constant PDF over ``bins``.

    Args:
      bins: (..., M+1) bin edges.
      weights: (..., M) unnormalized bin weights.
      num_samples: number of samples to draw.
      deterministic: evenly spaced positions ``linspace(0, 1, S)`` (1.0
        included) instead of random ones.
      stratified_u: jittered-linspace positions instead of iid uniforms; they
        (and so the samples) come out sorted.
      generator / u: source of the uniform draws, ``u`` of shape (..., S).

    Returns (..., num_samples) sample positions.

    The bin of a position is ``clip(#(cdf <= p), 1, M)``: a binary search
    (``searchsorted(right=True)``) and two gathers.
    """
    dtype = weights.dtype
    dev = weights.device
    weights = weights + 1e-5  # avoid NaN for empty rays
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., M+1)
    shape = (*cdf.shape[:-1], num_samples)

    if deterministic:
        pos = linspace(0.0, 1.0, num_samples, device=dev, dtype=dtype)
        pos = pos.expand(shape)
    elif stratified_u:
        base = torch.arange(num_samples, dtype=dtype, device=dev) / num_samples
        pos = base + _uniform(shape, u, generator, dev, dtype) / num_samples
    else:
        pos = _uniform(shape, u, generator, dev, dtype)

    M1 = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=True)
    inds = torch.clamp(inds, 1, M1 - 1)
    below = inds - 1

    bins = bins.expand(*cdf.shape[:-1], M1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, inds)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, inds)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    frac = (pos - cdf_below) / denom
    return bins_below + frac * (bins_above - bins_below)


def hierarchical_sample(
    z_coarse: torch.Tensor,
    weights: torch.Tensor,
    num_fine: int,
    deterministic: bool = False,
    merge: bool = True,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fine-sample depths from coarse weights. Interior weights only
    (first/last dropped), bins at coarse midpoints.

    merge=True (classic scheme): sorted union with the coarse depths,
    (..., num_coarse + num_fine). merge=False (fast engines): only the
    importance samples, drawn at stratified positions so they are already
    sorted, (..., num_fine)."""
    mids = 0.5 * (z_coarse[..., 1:] + z_coarse[..., :-1])
    z_fine = sample_pdf(
        mids,
        weights[..., 1:-1],
        num_fine,
        deterministic=deterministic,
        stratified_u=not merge,
        generator=generator,
        u=u,
    ).detach()
    if not merge:
        return z_fine
    return torch.sort(torch.cat([z_coarse, z_fine], dim=-1), dim=-1).values
