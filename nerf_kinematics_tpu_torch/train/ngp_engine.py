"""Fast-NeRF engine: the Instant-NGP-class model, inference half.

One model serves both render passes: the coarse pass places samples (the
occupancy proposal plus a density-only query), the fine pass produces the
image. The engine owns its ``NGPModel`` (an ``nn.Module``); render functions
take the camera pose and the occupancy grid.

Ported: everything the serving path needs -- the channels-first fused
entries, the occupancy proposal and its full-sweep refresh, the standard
evaluation renderer, the fast renderer (single view and a batch of views) and
the density grid. Anything that trains raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..cameras.rays import get_rays
from ..models.ngp import NGPConfig, NGPModel
from ..ops.ngp_fused_cuda import (
    ngp_fused_apply,
    ngp_fused_apply_cf,
    ngp_fused_sigma_cf,
)
from ..ops.occupancy import OccupancyGrid, init_grid, occupancy_sample, update_grid
from ..ops.sampling import linspace
from ..rendering.fast_render import FastRenderSettings, render_image_fast
from ..rendering.renderer import render_image
from .config import Config

_LATER = "training is ported in a later slice"

# Rays per chunk of the standard full-image render on a GPU: few, large
# launches (6.3 M points per pass at 64 + 128 samples).
GPU_CHUNK_RAYS = 32768


class NGPEngine:
    """Single NGP model for both passes. ``device=None`` means the GPU and
    raises when there is none; pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU."""

    def __init__(self, cfg: Config, scene_bound: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None):
        self.device = resolve_device(device)
        # The fast engine always uses sorted fine-only importance samples.
        cfg = cfg.replace(
            nerf=dataclasses.replace(
                cfg.nerf,
                train=dataclasses.replace(cfg.nerf.train, merge_hierarchical=False),
                validation=dataclasses.replace(
                    cfg.nerf.validation, merge_hierarchical=False
                ),
            )
        )
        self.cfg = cfg
        self.scene_bound = float(scene_bound)
        self.ngp_config: NGPConfig = cfg.ngp if cfg.ngp is not None else NGPConfig()
        mode = self.ngp_config.contraction
        # YAML parses bare on/off as booleans.
        mode = {True: "on", False: "off"}.get(mode, mode)
        self.contracted = mode == "on" or (mode == "auto" and self.scene_bound > 2.0)
        if self.contracted:
            raise NotImplementedError(
                "contracted scenes are not ported yet (ROADMAP: the hash "
                "encoder and contracted scenes)"
            )
        self.model = NGPModel(self.ngp_config, generator=generator).to(self.device)
        self.model.requires_grad_(False)
        self.model_fine = None  # the hierarchical pass shares the parameters

    # -- weights -------------------------------------------------------------
    def load_flax_params(self, tree: dict) -> None:
        """Load a flax-shaped parameter tree of numpy arrays (the reference's
        ``params["coarse"]``) into the model."""
        from ..io.convert import params_from_flax

        self.model.load_state_dict(params_from_flax(tree, device=self.device))

    def init_aux(self) -> Optional[OccupancyGrid]:
        """A fresh (all-occupied) occupancy grid, or None without occupancy."""
        if not self.ngp_config.use_occupancy:
            return None
        return init_grid(self.ngp_config.occ_resolution, self.scene_bound,
                         device=self.device)

    # -- model application with the world -> unit-cube map ------------------
    def _to_unit(self, pts: torch.Tensor) -> torch.Tensor:
        return pts / (2.0 * self.scene_bound) + 0.5

    @property
    def fused(self) -> bool:
        mode = self.ngp_config.fused
        mode = {True: "on", False: "off"}.get(mode, mode)
        return mode == "on" or (
            mode == "auto"
            and self.ngp_config.resolved_encoder() == "cp_pallas"
        )

    def _fused_params(self) -> dict:
        """The module's parameters in the raw-array structure the fused
        kernels take."""
        m = self.model
        d = [getattr(m, n) for n in m.density_names]
        c = [getattr(m, n) for n in m.color_names]
        return {
            "lines": m.cp_lines.detach(),
            "dW": [l.kernel.detach() for l in d],
            "db": [l.bias.detach()[:, None] for l in d],
            "cW": [l.kernel.detach() for l in c],
            "cb": [l.bias.detach()[:, None] for l in c],
        }

    def _cf_inputs(self, pts, vd):
        """(..., 3) pts / vd -> contiguous (3, N) kernel operands. A missing
        direction means (0, 0, 1)."""
        x = self._to_unit(pts.detach())
        xt = x.reshape(-1, 3).T.contiguous()
        if vd is None:
            vdt = torch.zeros_like(xt)
            vdt[2] = 1.0
        else:
            vdt = vd.detach().reshape(-1, 3).T.contiguous()
        return xt, vdt

    def apply_cf(self, pts, vd):
        """Channels-first fused entry for the renderers:
        (pts (..., 3), vd) -> (4, N) rgb logits and sigma."""
        xt, vdt = self._cf_inputs(pts, vd)
        return ngp_fused_apply_cf(self._fused_params(), xt, vdt,
                                  self.ngp_config.cp)

    def apply_sigma_cf(self, pts, vd):
        """Density-only channels-first entry: (4, N) with zero rgb rows, for
        the proposal-only coarse pass (its color is never read)."""
        x = self._to_unit(pts.detach())
        xt = x.reshape(-1, 3).T.contiguous()
        return ngp_fused_sigma_cf(self._fused_params(), xt, self.ngp_config.cp)

    def cf_apply_fns(self):
        """(coarse_cf, fine_cf) for ``render_rays``; (None, None) unless
        fused. The coarse entry drops to the density-only kernel when the
        coarse pass is proposal-only (coarse_loss_weight 0 and a fine pass in
        both the train and the validation settings)."""
        if not self.fused:
            return None, None
        nerf = self.cfg.nerf
        sigma_only = (
            self.resolved_coarse_loss_weight() == 0.0
            and nerf.train.num_fine > 0
            and nerf.validation.num_fine > 0
        )
        coarse = self.apply_sigma_cf if sigma_only else self.apply_cf
        return coarse, self.apply_cf

    def resolved_coarse_loss_weight(self) -> float:
        """NGP default 0.0: the passes share parameters, so the coarse pass
        only places samples."""
        cw = float(self.cfg.nerf.coarse_loss_weight)
        return 0.0 if cw < 0.0 else cw

    def _apply(self, pts, vd):
        """Channels-last query: (rgb logits (..., 3), sigma (...,))."""
        if not self.fused:
            with torch.no_grad():
                return self.model(self._to_unit(pts), vd)
        x = self._to_unit(pts.detach())
        if vd is None:
            vd = torch.zeros_like(x)
            vd[..., 2] = 1.0
        return ngp_fused_apply(self._fused_params(), x, vd.detach(),
                               self.ngp_config.cp)

    def apply_coarse(self, pts, vd):
        return self._apply(pts, vd)

    def apply_fine(self, pts, vd):
        return self._apply(pts, vd)

    # -- occupancy acceleration ---------------------------------------------
    def proposal_for(self, aux: Optional[OccupancyGrid], near, far, settings,
                     generator: Optional[torch.Generator] = None):
        """(rays_o, rays_d) -> (N, num_coarse) occupancy-placed depths, or
        None without a grid."""
        if aux is None or not self.ngp_config.use_occupancy:
            return None

        def proposal(rays_o, rays_d, u=None):
            return occupancy_sample(
                aux, rays_o, rays_d, near, far, settings.num_coarse,
                num_bins=self.ngp_config.occ_bins,
                deterministic=not settings.perturb,
                mode=self.ngp_config.occ_proposal,
                floor=self.ngp_config.occ_floor,
                generator=generator, u=u,
            )

        return proposal

    def _density_fn(self):
        def density_fn(pts):
            sigma, _ = self.model.density(self._to_unit(pts))
            return sigma

        return density_fn

    def update_occupancy(self, aux: Optional[OccupancyGrid], full: bool = True,
                         generator: Optional[torch.Generator] = None,
                         u: Optional[torch.Tensor] = None):
        """Periodic EMA refresh of the occupancy grid; returns the new grid.
        ``full=True`` sweeps every cell (one jittered point per cell, drawn
        from ``generator`` or given as ``u`` of shape (R^3, 3)). The
        incremental refresh (``full=False``) is not ported yet."""
        if aux is None or not self.ngp_config.use_occupancy:
            return aux
        if not full:
            raise NotImplementedError(
                "update_grid_incremental is not ported yet (ROADMAP)"
            )
        return update_grid(aux, self._density_fn(), generator=generator,
                           chunk=65536, u=u)

    # -- training ----------------------------------------------------------
    def init_state(self, *args, **kwargs):
        raise NotImplementedError(_LATER)

    def make_train_step(self, *args, **kwargs):
        raise NotImplementedError(_LATER)

    def make_train_many(self, *args, **kwargs):
        raise NotImplementedError(_LATER)

    def fused_objective_fn(self, *args, **kwargs):
        raise NotImplementedError(_LATER)

    # -- evaluation --------------------------------------------------------
    def _view_rays(self, intrinsics, c2w):
        H, W = intrinsics.height, intrinsics.width
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        rays_o, rays_d = get_rays(
            H, W, intrinsics.fl_x, c2w, cx=intrinsics.cx, cy=intrinsics.cy,
            focal_y=intrinsics.fl_y,
            dist=getattr(intrinsics, "distortion", None),
        )
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        return rays_o, rays_d, viewdirs

    def make_render_fn(self, intrinsics, near, far, use_ndc: bool = False,
                       settings=None, chunk_rays: Optional[int] = None):
        """Full-image renderer: (c2w, aux=None) -> maps dict. ``settings``
        overrides the sample budget (default: cfg.nerf.validation).
        ``chunk_rays``: rays per chunk; by default ``settings.chunksize``
        over the per-ray sample count on the CPU and ``GPU_CHUNK_RAYS`` on
        a GPU (the result does not depend on it)."""
        if use_ndc:
            raise NotImplementedError("NDC rays are not ported yet")
        if not self.fused:
            raise NotImplementedError(
                "the unfused render path is not ported; use the fused "
                "cp_pallas encoder (ngp.fused)"
            )
        cfg = self.cfg
        settings = settings or cfg.nerf.validation
        cf_coarse, cf_fine = self.cf_apply_fns()
        if chunk_rays is None and self.device.type == "cuda":
            chunk_rays = GPU_CHUNK_RAYS

        def render_view(c2w, aux=None):
            rays_o, rays_d, viewdirs = self._view_rays(intrinsics, c2w)
            return render_image(
                cf_coarse, rays_o, rays_d, near, far, settings,
                apply_fine_cf=cf_fine,
                use_viewdirs=cfg.nerf.use_viewdirs,
                chunk_rays=chunk_rays,
                viewdirs=viewdirs if cfg.nerf.use_viewdirs else None,
                proposal_fn=self.proposal_for(aux, near, far, settings),
            )

        return render_view

    def make_fast_render_fn(self, intrinsics, near, far, use_ndc: bool = False,
                            settings: Optional[FastRenderSettings] = None):
        """Serving-rate renderer (rendering/fast_render.py): shared
        stride^2-block coarse pass + one fused full-image fine pass. Needs
        the fused kernel and the occupancy proposal; raises otherwise.
        (c2w, aux) -> maps dict."""
        if use_ndc:
            raise NotImplementedError("NDC rays are not ported yet")
        if not self.fused:
            raise ValueError("fast render needs the fused kernel (ngp.fused)")
        if not self.ngp_config.use_occupancy:
            raise ValueError("fast render needs the occupancy proposal")
        val = self.cfg.nerf.validation
        if settings is None:
            settings = FastRenderSettings(
                num_coarse=val.num_coarse,
                num_fine=val.num_fine or val.num_coarse,
                white_background=val.white_background,
            )
        prop_settings = val.__class__(
            num_coarse=settings.num_coarse, perturb=False
        )

        def render_view(c2w, aux):
            rays_o, rays_d, viewdirs = self._view_rays(intrinsics, c2w)
            return render_image_fast(
                self.apply_cf, rays_o, rays_d, near, far, settings,
                proposal_fn=self.proposal_for(aux, near, far, prop_settings),
                viewdirs=viewdirs,
            )

        return render_view

    def make_fast_render_batch(self, intrinsics, near, far,
                               use_ndc: bool = False, settings=None):
        """Frame-batch serving: (c2ws (F, 4, 4), aux) -> maps dict with a
        leading frame axis. Single device: a loop over the frames, all
        launches enqueued without a host synchronisation in between.
        Sharding the frame axis over several GPUs is not ported yet."""
        render_view = self.make_fast_render_fn(intrinsics, near, far, use_ndc,
                                               settings)

        def batched(c2ws, aux):
            frames = [render_view(c, aux) for c in c2ws]
            return {k: torch.stack([f[k] for f in frames]) for k in frames[0]}

        return batched

    def density_grid(self, resolution: int = 128) -> torch.Tensor:
        """sigma on a regular grid over the scene box: (R, R, R) with
        ``grid[i, j, k] = sigma(x=lin[i], y=lin[j], z=lin[k])``. Feeds
        marching cubes and the occupancy diagnostics. One plane of
        ``resolution^2`` points per model call."""
        b = self.scene_bound
        lin = linspace(-b, b, resolution, device=self.device)
        density = self._density_fn()
        planes = []
        with torch.no_grad():
            ys, zs = torch.meshgrid(lin, lin, indexing="ij")
            for i in range(resolution):
                xs = lin[i].expand_as(ys)
                pts = torch.stack([xs, ys, zs], dim=-1).reshape(-1, 3)
                planes.append(density(pts))
        return torch.stack(planes).reshape(resolution, resolution, resolution)
