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
whole backward); ``ngp.fused_train: full`` puts the whole step, proposal
and coarse pass included, into one call; ``ngp.fused_train: off`` takes
autograd through the fused forward's gradient kernel, and ``ngp.fused:
off`` autograd through the unfused model and the CP encoder's gradient
kernel; ``ngp.encoder: hash`` always takes the unfused model. The optimizer
is Adam (``NGP_ADAM``: b2 0.99, eps 1e-15) over the flat buffer with coupled
1e-6 decay on the MLP kernels only (never the encoder's table).

Scenes whose bound exceeds 2 are contracted (``ngp.contraction: auto``,
``ops/contraction.py``): the model and the occupancy grid both see
``contract_to_unit(x, inner)`` in place of the linear map of the box.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..cameras.rays import get_rays, ndc_rays
from ..models.ngp import NGPConfig, NGPModel
from ..ops.contraction import contract_to_unit, unit_to_world
from ..ops.ngp_fused_cuda import (
    ngp_fused_apply,
    ngp_fused_apply_cf,
    ngp_fused_sigma_cf,
    ngp_fused_train_cf,
    ngp_fused_train_full_cf,
)
from ..ops.occupancy import (
    OccupancyGrid,
    init_grid,
    occupancy_sample,
    pair_projections,
    update_grid,
    update_grid_incremental,
)
from ..ops.sampling import _uniform, hierarchical_sample, linspace, stratified_sample
from ..ops.volume_render import raw2outputs_cf
from ..parallel.mesh import all_gather_rows, shard_batch
from ..rendering.fast_render import FastRenderSettings, render_image_fast
from ..rendering.renderer import render_image
from ..utils import profiling
from .config import Config
from .loop import (
    NGP_ADAM,
    ParamLayout,
    TrainState,
    bound,
    build_train_many,
    build_train_step,
    new_state,
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
    PyTorch versions of the kernels on the CPU. ``mesh``
    (``parallel/mesh.py``): the ranks the train step splits its rays over
    and the frame-batch renderer its frames."""

    adam = NGP_ADAM

    def __init__(self, cfg: Config, scene_bound: float = 1.0, device=None,
                 generator: Optional[torch.Generator] = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
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
        # half-width of the contraction's linear region
        self._inner = float(self.ngp_config.contract_inner) or max(
            1.0, self.scene_bound / 4.0)
        if self.fused and self.ngp_config.resolved_encoder() == "hash":
            raise ValueError("ngp.fused: on needs the CP encoder; the fused "
                             "kernels do not take encoder: hash")
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

    def bound(self, flat: torch.Tensor):
        """Render with the flat parameter buffer ``flat`` (a state's live
        parameters or its EMA shadow) inside the block, then go back to what
        the model showed before."""
        return bound(self.model, self.layout, flat)

    def init_aux(self) -> Optional[OccupancyGrid]:
        """A fresh (all-occupied) occupancy grid, or None without occupancy."""
        if not self.ngp_config.use_occupancy:
            return None
        return init_grid(self.ngp_config.occ_resolution, self.scene_bound,
                         device=self.device)

    # -- model application with the world -> unit-cube map ------------------
    def _to_unit(self, pts: torch.Tensor) -> torch.Tensor:
        """World points (..., 3) -> the model's [0, 1]^3 coordinates."""
        if self.contracted:
            return contract_to_unit(pts, self._inner)
        return pts / (2.0 * self.scene_bound) + 0.5

    def _to_unit_cf(self, pts_cf: torch.Tensor) -> torch.Tensor:
        """The same map of channels-first points (3, N). The linear map is
        elementwise; the contraction takes each point's norm over its three
        coordinates, so it needs them last."""
        if self.contracted:
            return self._to_unit(pts_cf.T).T
        return self._to_unit(pts_cf)

    # -- occupancy-grid coordinate maps (contracted or linear) ---------------
    def _occ_to_unit(self):
        """The occupancy grid's world -> [0, 1]^3 map: the model's on a
        contracted scene, else None (the grid's own linear map of
        [-bound, bound]^3)."""
        return self._to_unit if self.contracted else None

    def _occ_from_unit(self):
        if not self.contracted:
            return None
        return lambda u01: unit_to_world(u01, self._inner)

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
        """(rays_o, rays_d) -> (N, num_coarse) depths placed by the
        ``ngp.occ_proposal`` lookup ("hull", "grid" or "projected"), or None
        without a grid."""
        if aux is None or not self.ngp_config.use_occupancy:
            return None
        to_unit = self._occ_to_unit()

        def proposal(rays_o, rays_d, u=None):
            return occupancy_sample(
                aux, rays_o, rays_d, near, far, settings.num_coarse,
                num_bins=self.ngp_config.occ_bins,
                deterministic=not settings.perturb, to_unit=to_unit,
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
        from_unit = self._occ_from_unit()
        if full:
            return update_grid(aux, self._density_fn(), generator=generator,
                               chunk=65536, from_unit=from_unit, u=u)
        return update_grid_incremental(
            aux, self._density_fn(), generator=generator,
            n_cells=self.ngp_config.occ_incremental_cells,
            from_unit=from_unit, idx=idx, u=u)

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
        viewdirs on, no density noise, a ray count divisible by 128
        (under a mesh, each rank's count too: an eligible step whose
        per-rank count is not raises, rather than take another route). A
        fine ray of any length is taken, as the reference takes it.
        ``ngp.fused_train: full`` takes the whole step in one call instead
        (:meth:`_full_objective`), and needs the hull proposal on a linear
        scene with static near / far. ``loss_c`` is the MSE of the
        density-only coarse composite (zero rgb rows, so the background
        composite): a metric, never a gradient."""
        mode = getattr(self.ngp_config, "fused_train", "auto")
        mode = {True: "on", False: "off"}.get(mode, mode)
        if mode == "off":
            return None
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
        n_global = self.cfg.nerf.num_random_rays
        if self.mesh is not None and (n_global // self.mesh.world) % RAYS_PER_BLOCK:
            raise ValueError(
                f"the fused objective takes rays in blocks of {RAYS_PER_BLOCK}: "
                f"{n_global} rays over {self.mesh.world} ranks leaves "
                f"{n_global // self.mesh.world} a rank")

        S = settings.num_fine
        white_bg = settings.white_background
        cp = self.ngp_config.cp

        # The whole step in one call (row 8 of the kernel table) for the
        # hull proposal on a linear scene with a static depth range; other
        # shapes take the two-call objective below. As in the reference,
        # "full" is the explicit opt-in and "auto" / "on" take two calls.
        full = (
            mode == "full"
            and self.ngp_config.use_occupancy
            and self.ngp_config.occ_proposal == "hull"
            and not self.contracted
            and isinstance(near, (int, float))
            and isinstance(far, (int, float))
        )
        if mode == "full" and not full:
            raise ValueError(
                "ngp.fused_train: full requires the hull occupancy proposal "
                "on a non-contracted scene with static near/far"
            )
        if full:
            return self._full_objective(near, far, settings)

        @torch.no_grad()
        def objective(batch, aux, generator=None, u_coarse=None, u_fine=None,
                      noise_coarse=None, noise_fine=None):
            rays_o, rays_d, viewdirs, target = batch
            n_rays = rays_o.shape[0]
            sp = profiling.begin("obj.proposal")
            prop = self.proposal_for(aux, near, far, settings, generator)
            if prop is not None:
                z_coarse = prop(rays_o, rays_d, u_coarse)
            else:
                z_coarse = stratified_sample(
                    n_rays, settings.num_coarse, near, far,
                    perturb=settings.perturb, lindisp=settings.lindisp,
                    generator=generator, u=u_coarse, device=rays_o.device,
                )
            profiling.end(sp)
            sp = profiling.begin("obj.coarse")
            params = self._fused_params(detach=True)
            o_cf, d_cf = rays_o.T[:, :, None], rays_d.T[:, :, None]
            xt_c = self._to_unit_cf((o_cf + d_cf * z_coarse[None]).reshape(3, -1))
            raw4c = ngp_fused_sigma_cf(params, xt_c.contiguous(), cp)
            coarse = raw2outputs_cf(raw4c, z_coarse, rays_d, noise_std=0.0,
                                    white_background=white_bg)
            loss_c = torch.mean((coarse.rgb - target) ** 2)
            profiling.end(sp)
            sp = profiling.begin("obj.fine_inputs")
            z_fine = hierarchical_sample(
                z_coarse, coarse.weights, S, deterministic=not settings.perturb,
                merge=False, generator=generator, u=u_fine,
            )  # (R, S), sorted

            # ---- ray-major kernel inputs (point r * S + s) --------------
            dd = z_fine[:, 1:] - z_fine[:, :-1]
            dd = torch.cat([dd, torch.full_like(dd[:, :1], 1e10)], dim=1)
            dists = (dd * torch.linalg.norm(rays_d, dim=-1, keepdim=True))
            xt = self._to_unit_cf((o_cf + d_cf * z_fine[None]).reshape(3, -1))
            vdt = viewdirs.T[:, :, None].expand(3, n_rays, S).reshape(3, -1)
            profiling.end(sp)
            sp = profiling.begin("obj.fine")
            err, _maps, d_fused = ngp_fused_train_cf(
                params, xt.contiguous(), vdt.contiguous(),
                dists.reshape(1, -1).contiguous(), target.T.contiguous(), cp,
                S, white_bg, inv_denom=1.0 / (3.0 * n_rays),
            )
            loss_f = torch.sum(err) / (3.0 * n_rays)
            grads = self._fused_grads_to_tree(d_fused)
            profiling.end(sp)
            return (loss_f, (loss_c, loss_f)), grads

        return objective

    def _full_objective(self, near, far, settings):
        """``fused_objective_fn`` for ``ngp.fused_train: full``: one call of
        ``ngp_fused_train_full_cf`` per step. Its inverse-CDF positions are
        ``sample_pdf``'s: ``arange(n) / n + U / n`` from the step's
        generator (``U`` given as ``u_coarse`` (R, Sc) / ``u_fine`` (R, S)
        when passed), or the blended linspace without ``perturb``."""
        S, Sc = settings.num_fine, settings.num_coarse
        white_bg = settings.white_background
        ngp = self.ngp_config

        def sample_u(u, generator, n_rays, n_out, device):
            if not settings.perturb:
                return linspace(0.0, 1.0, n_out, device=device).expand(n_rays, n_out)
            base = torch.arange(n_out, dtype=torch.float32, device=device) / n_out
            return base + _uniform((n_rays, n_out), u, generator, device,
                                   torch.float32) / n_out

        @torch.no_grad()
        def objective_full(batch, aux, generator=None, u_coarse=None, u_fine=None,
                           noise_coarse=None, noise_fine=None):
            rays_o, rays_d, viewdirs, target = batch
            n_rays = rays_o.shape[0]
            dev = rays_o.device
            sp = profiling.begin("obj.proposal")
            u_c = sample_u(u_coarse, generator, n_rays, Sc, dev)
            proj2 = pair_projections(aux).contiguous()
            profiling.end(sp)
            sp = profiling.begin("obj.fine_inputs")
            u_f = sample_u(u_fine, generator, n_rays, S, dev)
            cf = lambda t: t.T.contiguous()
            operands = (cf(rays_o), cf(rays_d), cf(viewdirs), cf(target), cf(u_c), cf(u_f))
            profiling.end(sp)
            sp = profiling.begin("obj.fine")
            err, _maps, err_c, d_fused = ngp_fused_train_full_cf(
                self._fused_params(detach=True), *operands, proj2, ngp.cp, S, Sc,
                ngp.occ_bins, white_bg, inv_denom=1.0 / (3.0 * n_rays), near=near,
                far=far, bound=self.scene_bound, occ_floor=ngp.occ_floor,
            )
            loss_f = torch.sum(err) / (3.0 * n_rays)
            loss_c = torch.sum(err_c) / (3.0 * n_rays)
            grads = self._fused_grads_to_tree(d_fused)
            profiling.end(sp)
            return (loss_f, (loss_c, loss_f)), grads

        return objective_full

    def init_state(self, seed: Optional[int] = None,
                   keep_weights: bool = False) -> TrainState:
        """A fresh training state: newly initialised weights from ``seed``
        (default: experiment.randomseed), or the model's present ones with
        ``keep_weights``; zero Adam moments, an all-occupied grid, the EMA
        shadow when the run keeps one, and the step's generator on the
        engine's device. The model's parameters become views of the state's
        flat buffer."""
        seed = self.cfg.experiment.randomseed if seed is None else int(seed)
        source = self.model if keep_weights else NGPModel(
            self.ngp_config, generator=torch.Generator().manual_seed(seed))
        return new_state(self.layout, self.model, source, self.device, seed,
                         self.cfg.nerf.ema_decay, aux=self.init_aux())

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
    def _view_rays(self, intrinsics, c2w, use_ndc: bool = False):
        """Rays of a full view and their unit directions; with ``use_ndc``
        the rays are warped into NDC space, the directions are not."""
        H, W = intrinsics.height, intrinsics.width
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        rays_o, rays_d = get_rays(
            H, W, intrinsics.fl_x, c2w, cx=intrinsics.cx, cy=intrinsics.cy,
            focal_y=intrinsics.fl_y,
            dist=getattr(intrinsics, "distortion", None),
        )
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if use_ndc:
            rays_o, rays_d = ndc_rays(H, W, intrinsics.fl_x, 1.0, rays_o, rays_d)
        return rays_o, rays_d, viewdirs

    def make_render_fn(self, intrinsics, near, far, use_ndc: bool = False,
                       settings=None, chunk_rays: Optional[int] = None):
        """Full-image renderer: (c2w, aux=None) -> maps dict. ``settings``
        overrides the sample budget (default: cfg.nerf.validation).
        ``chunk_rays``: rays per chunk; by default ``settings.chunksize``
        over the per-ray sample count on the CPU and ``GPU_CHUNK_RAYS`` on
        a GPU (the result does not depend on it)."""
        cfg = self.cfg
        settings = settings or cfg.nerf.validation
        cf_coarse, cf_fine = self.cf_apply_fns()
        if chunk_rays is None and self.device.type == "cuda":
            chunk_rays = GPU_CHUNK_RAYS

        def render_view(c2w, aux=None):
            rays_o, rays_d, viewdirs = self._view_rays(intrinsics, c2w, use_ndc)
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
        (c2w, aux) -> maps dict. Each call is a span ``frame`` (request id:
        the call's number from 0) whose first child ``frame.rays`` makes
        the view's rays; ``render_image_fast`` opens the others."""
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
        calls = 0

        def render_view(c2w, aux):
            nonlocal calls
            span = profiling.begin("frame", calls)
            calls += 1
            sp = profiling.begin("frame.rays")
            rays_o, rays_d, viewdirs = self._view_rays(intrinsics, c2w, use_ndc)
            profiling.end(sp)
            out = render_image_fast(
                self.apply_cf, rays_o, rays_d, near, far, settings,
                proposal_fn=self.proposal_for(aux, near, far, prop_settings),
                viewdirs=viewdirs,
            )
            profiling.end(span)
            return out

        return render_view

    def make_fast_render_batch(self, intrinsics, near, far,
                               use_ndc: bool = False, settings=None):
        """Frame-batch serving: (c2ws (F, 4, 4), aux) -> maps dict with a
        leading frame axis: a loop over the frames, all launches enqueued
        without a host synchronisation in between. Under the engine's mesh
        rank r renders its contiguous block of F / world frames and every
        rank gets all F (``all_gather``); F must be a multiple of the world
        size (``cli/run_nerf.py`` pads the pose batch)."""
        render_view = self.make_fast_render_fn(intrinsics, near, far, use_ndc,
                                               settings)
        mesh = self.mesh

        def batched(c2ws, aux):
            if mesh is not None and len(c2ws) % mesh.world:
                raise ValueError(f"{len(c2ws)} frames do not split over "
                                 f"{mesh.world} ranks; pad the pose batch")
            frames = [render_view(c, aux) for c in shard_batch(c2ws, mesh)]
            return {k: all_gather_rows(torch.stack([f[k] for f in frames]), mesh)
                    for k in frames[0]}

        return batched

    def density_grid(self, resolution: int = 128) -> torch.Tensor:
        """sigma on a regular grid over the scene box: (R, R, R) with
        ``grid[i, j, k] = sigma(x=lin[i], y=lin[j], z=lin[k])`` at world
        points ``lin`` = linspace(-bound, bound), through the engine's
        world -> unit map (the contraction on a contracted scene). Feeds
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
