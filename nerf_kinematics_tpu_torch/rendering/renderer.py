"""Hierarchical coarse->fine volume rendering, over the fused kernels
(channels-first entries) or the unfused model (channels-last entries).

Stratified or proposal-placed coarse samples -> coarse pass -> compositing ->
importance samples -> fine pass -> compositing. Full-image rendering is a
Python loop over fixed-size ray chunks (bounded memory).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.sampling import hierarchical_sample, stratified_sample
from ..ops.volume_render import raw2outputs, raw2outputs_cf


@dataclass(frozen=True)
class RenderSettings:
    """Per-phase rendering options (YAML: nerf.train / nerf.validation)."""

    num_coarse: int = 64
    num_fine: int = 0
    perturb: bool = True
    lindisp: bool = False
    radiance_field_noise_std: float = 0.0
    white_background: bool = False
    # Samples per chunk of a full-image render; rays per chunk is this over
    # the per-ray sample count.
    chunksize: int = 131072
    # Merge fine with coarse samples (sorted union) vs fine-only sorted
    # importance samples (the fast engine's choice).
    merge_hierarchical: bool = True
    # Ray-batch source of the train phase: "random" | "shuffled" |
    # "shuffled_epoch".
    pixel_sampler: str = "random"

    @classmethod
    def from_cfg(cls, d: dict) -> "RenderSettings":
        keys = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in d.items() if k in keys})


def _composite(apply_fn, apply_cf, pts, viewdirs, z, rays_d,
               settings: RenderSettings, generator):
    """Query one pass and composite it. With ``apply_cf`` (the channels-first
    fused entry, (pts, vd) -> (4, N)) the result goes to ``raw2outputs_cf``;
    otherwise ``apply_fn`` ((pts, vd) -> (rgb logits (..., S, 3), sigma
    (..., S))) and the classic channels-last ``raw2outputs``."""
    vd = viewdirs[..., None, :].expand(pts.shape) if viewdirs is not None else None
    kw = dict(noise_std=settings.radiance_field_noise_std,
              white_background=settings.white_background, generator=generator)
    if apply_cf is not None:
        return raw2outputs_cf(apply_cf(pts, vd), z, rays_d, **kw)
    raw_rgb, raw_sigma = apply_fn(pts, vd)
    return raw2outputs(raw_rgb, raw_sigma, z, rays_d, **kw)


def render_rays(
    apply_coarse_cf: Optional[Callable],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    settings: RenderSettings,
    generator: Optional[torch.Generator] = None,
    apply_fine_cf: Optional[Callable] = None,
    use_viewdirs: bool = True,
    viewdirs=None,
    proposal_fn=None,
    apply_coarse: Optional[Callable] = None,
    apply_fine: Optional[Callable] = None,
    u_coarse=None,
    u_fine=None,
    coarse_no_grad: bool = False,
):
    """Render a batch of rays. Returns (coarse, fine | None) RenderOutputs.

    ``apply_*_cf``: channels-first entries ((pts (..., 3), vd) -> (4, N));
    where one is None the channels-last ``apply_coarse`` / ``apply_fine``
    ((pts, vd) -> (rgb logits, sigma)) is used. ``near`` / ``far``: scalars
    or (N,) per-ray tensors. ``viewdirs`` overrides the default
    normalize(rays_d). ``proposal_fn`` (rays_o, rays_d, u=None) ->
    (N, num_coarse) depths replaces the stratified coarse sampler
    (occupancy-guided placement).

    Differentiable in whatever the entries close over. The coarse weights
    that place the fine samples are detached, as in the reference. Random
    draws come from ``generator`` in the order coarse jitter, fine jitter,
    or are given as ``u_coarse`` (N, num_coarse) / ``u_fine`` (N, num_fine).
    ``coarse_no_grad`` runs the coarse pass outside autograd (a coarse pass
    that only places the fine samples needs no graph)."""
    n_rays = rays_o.shape[0]
    deterministic = not settings.perturb

    if use_viewdirs and viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    elif not use_viewdirs:
        viewdirs = None

    if proposal_fn is not None:
        z_coarse = (proposal_fn(rays_o, rays_d) if u_coarse is None
                    else proposal_fn(rays_o, rays_d, u_coarse))
    else:
        z_coarse = stratified_sample(
            n_rays, settings.num_coarse, near, far, perturb=settings.perturb,
            lindisp=settings.lindisp, generator=generator, u=u_coarse,
            device=rays_o.device,
        )
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_coarse[..., :, None]
    with torch.set_grad_enabled(torch.is_grad_enabled() and not coarse_no_grad):
        coarse = _composite(apply_coarse, apply_coarse_cf, pts, viewdirs,
                            z_coarse, rays_d, settings, generator)

    fine = None
    if settings.num_fine > 0:
        af = apply_fine if apply_fine is not None else apply_coarse
        af_cf = apply_fine_cf if apply_fine_cf is not None else apply_coarse_cf
        z_all = hierarchical_sample(
            z_coarse, coarse.weights.detach(), settings.num_fine,
            deterministic=deterministic, merge=settings.merge_hierarchical,
            generator=generator, u=u_fine,
        )
        pts_f = rays_o[..., None, :] + rays_d[..., None, :] * z_all[..., :, None]
        fine = _composite(af, af_cf, pts_f, viewdirs, z_all, rays_d, settings,
                          generator)

    return coarse, fine


def render_image(
    apply_coarse_cf: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near,
    far,
    settings: RenderSettings,
    apply_fine_cf: Optional[Callable] = None,
    use_viewdirs: bool = True,
    chunk_rays: Optional[int] = None,
    viewdirs=None,
    proposal_fn=None,
    apply_coarse: Optional[Callable] = None,
    apply_fine: Optional[Callable] = None,
):
    """Render an (H, W) image by looping ``render_rays`` over fixed-size ray
    chunks. The pixel count is padded up to a whole number of chunks with
    all-ones rays that are rendered and discarded, so the result does not
    depend on the chunk size. Evaluation is deterministic (no perturbation,
    no density noise). Returns a dict of the (H, W, 3) rgb image and the
    (H, W) disp / acc / depth maps from the finest pass."""
    H, W = rays_o.shape[:2]
    n = H * W
    per_ray = max(settings.num_coarse + settings.num_fine, 1)
    chunk = chunk_rays or max(settings.chunksize // per_ray, 1)
    chunk = min(chunk, n)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def _chunked(x):
        flat = torch.cat([x.reshape(-1, 3), x.new_ones((pad, 3))])
        return flat.reshape(n_chunks, chunk, 3)

    chunks_o, chunks_d = _chunked(rays_o), _chunked(rays_d)
    chunks_vd = _chunked(viewdirs) if viewdirs is not None else None

    eval_settings = settings if not settings.perturb else RenderSettings(
        **{**settings.__dict__, "perturb": False, "radiance_field_noise_std": 0.0}
    )

    outs = []
    with torch.no_grad():
        for c in range(n_chunks):
            coarse, fine = render_rays(
                apply_coarse_cf, chunks_o[c], chunks_d[c], near, far,
                eval_settings, apply_fine_cf=apply_fine_cf,
                use_viewdirs=use_viewdirs,
                viewdirs=chunks_vd[c] if chunks_vd is not None else None,
                proposal_fn=proposal_fn,
                apply_coarse=apply_coarse, apply_fine=apply_fine,
            )
            out = fine if fine is not None else coarse
            outs.append((out.rgb, out.disp, out.acc, out.depth))
    rgb, disp, acc, depth = (torch.cat(x) for x in zip(*outs))
    unpad = lambda x, ch: x[:n].reshape(H, W, *ch)
    return {
        "rgb": unpad(rgb, (3,)),
        "disp": unpad(disp, ()),
        "acc": unpad(acc, ()),
        "depth": unpad(depth, ()),
    }
