"""Fast-NeRF engine: the Instant-NGP-class model, training and inference.

One model serves both render passes: the coarse pass places samples (the
occupancy proposal plus a density-only query), the fine pass produces the
image. The engine owns its ``NGPModel`` (an ``nn.Module``); render functions
take the camera pose and the occupancy grid, and render with whatever
parameters the model is bound to (``bound``).

Training: ``init_state`` makes a :class:`~.loop.TrainState` whose flat
parameter buffer the model's parameters are views of; ``make_train_step`` /
``make_train_many`` build the step (``train/loop.py``). The default step
takes the fused objective (:meth:`fused_objective_fn`: density-only coarse
pass, then ONE kernel call for the fine forward, compositing, loss and the
whole backward); ``ngp.fused_train: off`` takes autograd through the fused
forward's gradient kernel, and ``ngp.fused: off`` autograd through the
unfused model and the CP encoder's gradient kernel. The optimizer is Adam
(b2 0.99, eps 1e-15) over the flat buffer with coupled 1e-6 decay on the MLP
kernels only.
"""

from __future__ import annotations

import contextlib
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
    ngp_fused_train_cf,
)
from ..ops.occupancy import (
    OccupancyGrid,
    init_grid,
    occupancy_sample,
    update_grid,
    update_grid_incremental,
)
from ..ops.sampling import hierarchical_sample, linspace, stratified_sample
from ..ops.volume_render import raw2outputs_cf
from ..rendering.fast_render import FastRenderSettings, render_image_fast
from ..rendering.renderer import render_image
from .config import Config
from .loop import (
    AdamState,
    ParamLayout,
    TrainState,
    build_train_many,
    build_train_step,
    init_ema_shadow,
)

# The reference's fused objective needs a ray count divisible by its 128-ray
# block; the eligibility rule is kept so both packages take the same route.
RAYS_PER_BLOCK = 128

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
        self.layout = ParamLayout(self.model)
        self.model_fine = None  # the hierarchical pass shares the parameters

    # -- weights -------------------------------------------------------------
    def load_flax_params(self, tree: dict) -> None:
        """Load a flax-shaped parameter tree of numpy arrays (the reference's
        ``params["coarse"]``) into the model."""
        from ..io.convert import params_from_flax

        with torch.no_grad():
            for name, value in params_from_flax(tree, device=self.device).items():
                self.model.get_parameter(name).copy_(value)

    @contextlib.contextmanager
    def bound(self, flat: torch.Tensor):
        """Render with the flat parameter buffer ``flat`` (a state's live
        parameters or its EMA shadow) inside the block, then go back to what
        the model showed before."""
        before = {n: p.data for n, p in self.model.named_parameters()}
        self.layout.bind(self.model, flat)
        try:
            yield self
        finally:
            for n, p in self.model.named_parameters():
                p.data = before[n]

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

    def _fused_params(self, detach: bool = False) -> dict:
        """The module's parameters in the raw-array structure the fused
        kernels take: views of the parameters, so a gradient taken through
        them lands on the module's leaves. ``detach`` cuts them off the
        graph (the density-only kernel has no gradient)."""
        m = self.model
        d = [getattr(m, n) for n in m.density_names]
        c = [getattr(m, n) for n in m.color_names]
        leaf = (lambda t: t.detach()) if detach else (lambda t: t)
        return {
            "lines": leaf(m.cp_lines),
            "dW": [leaf(l.kernel) for l in d],
            "db": [leaf(l.bias)[:, None] for l in d],
            "cW": [leaf(l.kernel) for l in c],
            "cb": [leaf(l.bias)[:, None] for l in c],
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
        return ngp_fused_sigma_cf(self._fused_params(detach=True), xt,
                                  self.ngp_config.cp)

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
        """Channels-last query: (rgb logits (..., 3), sigma (...,)).
        Positions and directions are data: no gradient reaches them."""
        x = self._to_unit(pts.detach())
        if not self.fused:
            return self.model(x, None if vd is None else vd.detach())
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
                         u: Optional[torch.Tensor] = None,
                         idx: Optional[torch.Tensor] = None):
        """Periodic EMA refresh of the occupancy grid; returns the new grid.
        ``full=True`` sweeps every cell (one jittered point per cell, drawn
        from ``generator`` or given as ``u`` of shape (R^3, 3));
        ``full=False`` is the cheap steady-state maintenance: decay every
        cell and re-query ``occ_incremental_cells`` random cells (``idx``,
        ``u`` of shape (n_cells, 3) replace the generator's draws). A
        :class:`~.loop.TrainState` may be passed instead of a grid: its grid
        is refreshed with the state's generator and the state returned."""
        if isinstance(aux, TrainState):
            state = aux
            with self.bound(state.params):
                state.aux = self.update_occupancy(
                    state.aux, full=full, generator=state.generator, u=u, idx=idx)
            return state
        if aux is None or not self.ngp_config.use_occupancy:
            return aux
        if full:
            return update_grid(aux, self._density_fn(), generator=generator,
                               chunk=65536, u=u)
        return update_grid_incremental(
            aux, self._density_fn(), generator=generator,
            n_cells=self.ngp_config.occ_incremental_cells, idx=idx, u=u)

    # -- training ----------------------------------------------------------
    def _fused_grads_to_tree(self, d_fused: dict) -> dict:
        """Transpose of :meth:`_fused_params`: the fused kernels' gradients
        -> {parameter name: gradient}. The lines gradient already has the
        parameter layout (see ``ops/ngp_fused_cuda.py``)."""
        from ..io.convert import fused_grads_to_named

        return fused_grads_to_named(d_fused, self.model.density_names,
                                    self.model.color_names)

    def fused_objective_fn(self, near, far, settings):
        """One-call train objective: density-only coarse stage as usual, then
        fine forward + per-ray compositing + MSE + full backward in
        ``ngp_fused_train_cf``. Returns ``objective(batch, aux, generator,
        u_coarse=None, u_fine=None) -> ((loss, (loss_c, loss_f)), grads)``
        with ``grads`` keyed by parameter name, or None when the step shape
        is not eligible (the step then takes autograd).

        Eligibility mirrors the reference's: fused cp encoder, proposal-only
        coarse pass (coarse_loss_weight 0), importance fine samples,
        viewdirs on, no density noise, and a ray count divisible by 128.
        ``loss_c`` is the MSE of the density-only coarse composite (zero rgb
        rows, so the background composite): a metric, never a gradient."""
        mode = getattr(self.ngp_config, "fused_train", "auto")
        mode = {True: "on", False: "off"}.get(mode, mode)
        if mode == "off":
            return None
        if mode == "full":
            raise NotImplementedError(
                "ngp.fused_train: full (the whole-step kernel "
                "ngp_fused_train_full_cf, row 8 of ROADMAP section B) is not "
                "ported yet")
        eligible = (
            self.fused
            and self.resolved_coarse_loss_weight() == 0.0
            and settings.num_fine > 0
            and self.cfg.nerf.use_viewdirs
            and settings.radiance_field_noise_std == 0.0
            and self.cfg.nerf.num_random_rays % RAYS_PER_BLOCK == 0
        )
        if not eligible:
            if mode == "on":
                raise ValueError(
                    "ngp.fused_train: on requires the fused cp encoder, "
                    "coarse_loss_weight 0, num_fine > 0, use_viewdirs, "
                    "noise_std 0, and num_random_rays % 128 == 0"
                )
            return None

        S = settings.num_fine
        white_bg = settings.white_background
        cp = self.ngp_config.cp

        @torch.no_grad()
        def objective(batch, aux, generator=None, u_coarse=None, u_fine=None):
            rays_o, rays_d, viewdirs, target = batch
            n_rays = rays_o.shape[0]
            prop = self.proposal_for(aux, near, far, settings, generator)
            if prop is not None:
                z_coarse = prop(rays_o, rays_d, u_coarse)
            else:
                z_coarse = stratified_sample(
                    n_rays, settings.num_coarse, near, far,
                    perturb=settings.perturb, lindisp=settings.lindisp,
                    generator=generator, u=u_coarse, device=rays_o.device,
                )
            params = self._fused_params(detach=True)
            o_cf, d_cf = rays_o.T[:, :, None], rays_d.T[:, :, None]
            xt_c = self._to_unit((o_cf + d_cf * z_coarse[None]).reshape(3, -1))
            raw4c = ngp_fused_sigma_cf(params, xt_c.contiguous(), cp)
            coarse = raw2outputs_cf(raw4c, z_coarse, rays_d, noise_std=0.0,
                                    white_background=white_bg)
            loss_c = torch.mean((coarse.rgb - target) ** 2)
            z_fine = hierarchical_sample(
                z_coarse, coarse.weights, S, deterministic=not settings.perturb,
                merge=False, generator=generator, u=u_fine,
            )  # (R, S), sorted

            # ---- ray-major kernel inputs (point r * S + s) --------------
            dd = z_fine[:, 1:] - z_fine[:, :-1]
            dd = torch.cat([dd, torch.full_like(dd[:, :1], 1e10)], dim=1)
            dists = (dd * torch.linalg.norm(rays_d, dim=-1, keepdim=True))
            xt = self._to_unit((o_cf + d_cf * z_fine[None]).reshape(3, -1))
            vdt = viewdirs.T[:, :, None].expand(3, n_rays, S).reshape(3, -1)
            err, _maps, d_fused = ngp_fused_train_cf(
                params, xt.contiguous(), vdt.contiguous(),
                dists.reshape(1, -1).contiguous(), target.T.contiguous(), cp,
                S, white_bg, inv_denom=1.0 / (3.0 * n_rays),
            )
            loss_f = torch.sum(err) / (3.0 * n_rays)
            return (loss_f, (loss_c, loss_f)), self._fused_grads_to_tree(d_fused)

        return objective

    def init_state(self, seed: Optional[int] = None,
                   keep_weights: bool = False) -> TrainState:
        """A fresh training state: newly initialised weights from ``seed``
        (default: experiment.randomseed), or the model's present ones with
        ``keep_weights``; zero Adam moments, an all-occupied grid, the EMA
        shadow when the run keeps one, and the step's generator on the
        engine's device. The model's parameters become views of the state's
        flat buffer."""
        seed = self.cfg.experiment.randomseed if seed is None else int(seed)
        # The model may still show an earlier state's buffer: the new one is
        # built beside it and never written through the old views.
        source = self.model if keep_weights else NGPModel(
            self.ngp_config, generator=torch.Generator().manual_seed(seed))
        flat = self.layout.flatten(
            {n: p.detach() for n, p in source.named_parameters()}
        ).to(self.device, copy=True)
        self.layout.bind(self.model, flat)
        zeros = torch.zeros_like(flat)
        gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        return TrainState(
            step=torch.zeros((), dtype=torch.int64, device=self.device),
            params=flat,
            opt_state=AdamState(zeros, zeros.clone(), torch.zeros(
                (), dtype=torch.int64, device=self.device)),
            generator=gen,
            aux=self.init_aux(),
            ema=init_ema_shadow(flat, self.cfg.nerf.ema_decay),
        )

    def make_train_step(self, intrinsics, near, far, use_ndc: bool = False):
        """(state, images, poses, ray_buf=None) -> (state, metrics); see
        ``train/loop.py::build_train_step``."""
        return build_train_step(self, intrinsics, near, far, use_ndc)

    def make_train_many(self, intrinsics, near, far, use_ndc: bool = False,
                        steps_per_call: int = 20):
        """``steps_per_call`` steps per call with no host synchronisation in
        between; see ``train/loop.py::build_train_many``."""
        return build_train_many(self, intrinsics, near, far, use_ndc,
                                steps_per_call)

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
                apply_coarse=self.apply_coarse, apply_fine=self.apply_fine,
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
