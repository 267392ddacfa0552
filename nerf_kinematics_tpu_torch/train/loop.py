"""Training state, the train step of both engines, and the classic engine.

The whole step -- ray batch, coarse proposal, fine objective, Adam, EMA --
is enqueued on the device without a host synchronisation: the step counter,
the window offset and every metric stay device tensors until the caller reads
them.

State. All parameters live in ONE flat f32 buffer (``TrainState.params``); the
model's parameters are views of it (``ParamLayout.bind``), so the optimizer is
one fused update over one vector, and the EMA shadow and the Adam moments are
flat buffers of the same length. A step updates its state **in place** and
returns it; ``TrainState.clone()`` makes an independent copy.

Random draws come from ``TrainState.generator`` in a fixed order per step:

  1. the ray batch: the window offset (``shuffled`` sampler, one integer) or
     the image, row and column indices (``random`` sampler, in that order);
  2. the coarse depth jitter, (n_rays, num_coarse) uniforms;
  3. the coarse pass's density noise, standard normals (only with
     ``radiance_field_noise_std`` > 0);
  4. the fine depth jitter, (n_rays, num_fine) uniforms;
  5. the fine pass's density noise.

The train step makes all of them before the objective, which only consumes
them. Every one of them can be passed in instead (``offset=``, ``pixels=``,
``u_coarse=``, ``u_fine=``, ``noise_coarse=``, ``noise_fine=``), which is
how tests feed this package and the reference the same numbers.

Data parallelism (an engine built with ``mesh=``, ``parallel/mesh.py``).
Every rank draws the global batch and the global draws above, in that
order, from the same generator (or takes the same global draws passed in),
then computes its contiguous share of the rays; the flat gradient and the
loss metrics are averaged over the ranks once a step, before Adam. Each
rank's objective already scales by its own ray count, so N ranks take the
step one device takes, and their states stay equal.

Optimizer. Adam over the flat buffer with each engine's constants
(``engine.adam``): the fast engine's (b2 0.99, eps 1e-15, coupled 1e-6 decay
on the MLP kernels) and the classic engine's, optax's defaults (b2 0.999,
eps 1e-8, no decay).
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..cameras.rays import get_rays, ndc_rays, pixel_dirs
from ..parallel.mesh import all_reduce_mean, shard_batch
from ..rendering.renderer import render_image, render_rays
from ..utils import profiling
from ..utils.logging import get_logger

log = get_logger("train")


@dataclass(frozen=True)
class AdamConfig:
    """Adam's constants: ``eps`` is added outside the square root, and
    ``weight_decay`` is a coupled L2 term on the parameters the layout's
    ``decay_mask`` selects."""

    b1: float
    b2: float
    eps: float
    weight_decay: float


# The fast engine's Adam (NGP practice): b2 0.99, eps 1e-15, L2 decay on the
# MLP kernels only.
NGP_ADAM = AdamConfig(0.9, 0.99, 1e-15, 1e-6)
# The classic engine's: optax.adam's defaults, no decay.
CLASSIC_ADAM = AdamConfig(0.9, 0.999, 1e-8, 0.0)
WEIGHT_DECAY = NGP_ADAM.weight_decay


class ParamLayout:
    """Where each of a module's parameters sits in the flat buffer, in
    ``named_parameters()`` order."""

    def __init__(self, module: torch.nn.Module):
        self.entries = []  # (name, shape, offset, numel)
        off = 0
        for name, p in module.named_parameters():
            self.entries.append((name, tuple(p.shape), off, p.numel()))
            off += p.numel()
        self.total = off

    def flatten(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Name -> tensor dict (parameters or gradients) -> one flat vector."""
        return torch.cat([tensors[name].reshape(-1).to(torch.float32)
                          for name, _, _, _ in self.entries])

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {name: flat[off : off + n].view(shape)
                for name, shape, off, n in self.entries}

    def bind(self, module: torch.nn.Module, flat: torch.Tensor) -> None:
        """Make the module's parameters views of ``flat``."""
        params = dict(module.named_parameters())
        for name, view in self.views(flat).items():
            params[name].data = view

    def decay_mask(self, device=None, weight_decay: float = WEIGHT_DECAY
                   ) -> torch.Tensor:
        """``weight_decay`` on the MLP kernels (``*.kernel``), 0 on the
        encoding tables and the biases."""
        mask = torch.zeros(self.total, dtype=torch.float32, device=device)
        for name, _, off, n in self.entries:
            if name.endswith(".kernel"):
                mask[off : off + n] = weight_decay
        return mask


@dataclass
class AdamState:
    mu: torch.Tensor     # (P,) first moment
    nu: torch.Tensor     # (P,) second moment
    count: torch.Tensor  # int64 scalar: updates applied so far


@dataclass
class TrainState:
    step: torch.Tensor           # int64 scalar on the device
    params: torch.Tensor         # (P,) flat f32, what the model's views show
    opt_state: AdamState
    generator: torch.Generator   # the step's random draws, on the device
    aux: Any = None              # engine state, the occupancy grid
    # EMA shadow of ``params`` when nerf.ema_decay > 0, else None. Rendering
    # and evaluation use the shadow; training always steps the live params.
    ema: Optional[torch.Tensor] = None

    def clone(self) -> "TrainState":
        gen = torch.Generator(device=self.generator.device)
        gen.set_state(self.generator.get_state())
        return TrainState(
            self.step.clone(), self.params.clone(),
            AdamState(self.opt_state.mu.clone(), self.opt_state.nu.clone(),
                      self.opt_state.count.clone()),
            gen, copy.copy(self.aux),
            None if self.ema is None else self.ema.clone(),
        )


def new_state(layout: ParamLayout, model: nn.Module, source: nn.Module, device,
              seed: int, ema_decay: float, aux=None) -> TrainState:
    """A fresh training state over ``source``'s weights: one flat buffer on
    ``device`` that ``model``'s parameters become views of, zero Adam
    moments, the step's generator seeded with ``seed + 1``. The buffer is
    built beside whatever ``model`` showed before and never written through
    its old views."""
    flat = layout.flatten(
        {n: p.detach() for n, p in source.named_parameters()}
    ).to(device, copy=True)
    layout.bind(model, flat)
    zeros = torch.zeros_like(flat)
    return TrainState(
        step=torch.zeros((), dtype=torch.int64, device=device),
        params=flat,
        opt_state=AdamState(zeros, zeros.clone(),
                            torch.zeros((), dtype=torch.int64, device=device)),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
        aux=aux,
        ema=init_ema_shadow(flat, ema_decay),
    )


@contextlib.contextmanager
def bound(model: nn.Module, layout: ParamLayout, flat: torch.Tensor):
    """Inside the block ``model`` shows the flat buffer ``flat`` (a state's
    live parameters or its EMA shadow); then what it showed before."""
    before = {n: p.data for n, p in model.named_parameters()}
    layout.bind(model, flat)
    try:
        yield
    finally:
        for n, p in model.named_parameters():
            p.data = before[n]


def eval_params(state: TrainState) -> torch.Tensor:
    """The flat parameters to render and evaluate with: the EMA shadow when
    the run keeps one, otherwise the live ones."""
    return state.params if state.ema is None else state.ema


def init_ema_shadow(params: torch.Tensor, ema_decay: float):
    """Fresh EMA shadow of ``params`` (None when ema_decay == 0): a copy,
    never an alias, since steps update both in place."""
    if not ema_decay or ema_decay <= 0.0:
        return None
    return params.detach().clone()


def build_shuffled_ray_buffer(images: torch.Tensor, poses: torch.Tensor,
                              intrinsics, seed: int = 0,
                              perm: Optional[torch.Tensor] = None):
    """The ``shuffled`` pixel sampler's ray buffer: one ray per pixel of every
    image, globally permuted once. ``images`` (N, H, W, 3) and ``poses``
    (N, 4, 4) are device tensors. Returns {"rays_o", "rays_d", "target"},
    each (N*H*W, 3) f32. The permutation comes from a generator seeded with
    ``seed`` or is given as ``perm``."""
    n_img, H, W = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    cols = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    rows = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    dirs_cam = pixel_dirs(cols.reshape(-1), rows.reshape(-1), intrinsics.fl_x,
                          intrinsics.fl_y, intrinsics.cx, intrinsics.cy,
                          dist=getattr(intrinsics, "distortion", None))
    rays_d = torch.einsum("nij,pj->npi", poses[:, :3, :3], dirs_cam)
    rays_o = poses[:, None, :3, 3].expand(n_img, H * W, 3)
    if perm is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        perm = torch.randperm(n_img * H * W, generator=gen, device=dev)
    perm = torch.as_tensor(perm, dtype=torch.int64, device=dev)
    return {
        "rays_o": rays_o.reshape(-1, 3)[perm].contiguous(),
        "rays_d": rays_d.reshape(-1, 3)[perm].contiguous(),
        "target": images.reshape(-1, images.shape[-1])[perm].contiguous(),
    }


def lr_schedule(cfg):
    """Exponential decay: lr0 * factor^(step / (lr_decay * 1000)). ``step``
    may be a device tensor; the result then is one too."""
    base = cfg.optimizer.lr
    decay_steps = cfg.scheduler.lr_decay * 1000
    factor = cfg.scheduler.lr_decay_factor

    def sched(step):
        if isinstance(step, torch.Tensor):
            return base * torch.pow(factor, step.to(torch.float32) / decay_steps)
        return base * factor ** (step / decay_steps)

    return sched


def adam_update(params: torch.Tensor, grads: torch.Tensor, opt: AdamState,
                sched, decay_mask: Optional[torch.Tensor],
                adam: AdamConfig = NGP_ADAM) -> None:
    """One optimizer step over the flat buffer, in place.

    The decay term ``decay_mask * p`` (none when the mask is None) is added
    to the gradient **before** Adam (coupled L2: it goes through both
    moments), the moments are bias corrected with the count after this
    update, eps is added outside the square root, and the learning rate is
    the schedule at the count before it is incremented."""
    g = grads if decay_mask is None else grads + decay_mask * params
    opt.mu.mul_(adam.b1).add_(g, alpha=1.0 - adam.b1)
    opt.nu.mul_(adam.b2).addcmul_(g, g, value=1.0 - adam.b2)
    lr = sched(opt.count)
    t = (opt.count + 1).to(torch.float32)
    mu_hat = opt.mu / (1.0 - torch.pow(adam.b1, t))
    nu_hat = opt.nu / (1.0 - torch.pow(adam.b2, t))
    params.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + adam.eps)))
    opt.count += 1


def build_objective(engine, near, far):
    """Loss and gradients of one ray batch, by the route the engine's
    configuration selects: ``objective(batch, aux, gen, u_coarse=None,
    u_fine=None, noise_coarse=None, noise_fine=None) -> ((loss, (loss_c,
    loss_f)), grads)``. ``batch`` =
    (rays_o, rays_d, viewdirs, target), ``grads`` maps the model's parameter
    names to tensors. The fused objective (one kernel call for the fine pass
    and its whole backward) where the step shape is eligible, else autograd
    through ``render_rays``. The model's parameters must be bound to the
    state the caller means (``ParamLayout.bind``)."""
    cfg = engine.cfg
    settings = cfg.nerf.train
    fused_objective = engine.fused_objective_fn(near, far, settings)
    if fused_objective is not None:
        return fused_objective
    cw = engine.resolved_coarse_loss_weight()
    cf_coarse, cf_fine = engine.cf_apply_fns()

    def autodiff_objective(batch, aux, gen, u_coarse=None, u_fine=None,
                           noise_coarse=None, noise_fine=None):
        rays_o, rays_d, viewdirs, target = batch
        sp = profiling.begin("obj.forward")
        leaves = dict(engine.model.named_parameters())
        with torch.enable_grad():
            coarse, fine = render_rays(
                cf_coarse, rays_o, rays_d, near, far, settings, generator=gen,
                apply_fine_cf=cf_fine, use_viewdirs=cfg.nerf.use_viewdirs,
                viewdirs=viewdirs,
                proposal_fn=engine.proposal_for(aux, near, far, settings, gen),
                apply_coarse=engine.apply_coarse, apply_fine=engine.apply_fine,
                u_coarse=u_coarse, u_fine=u_fine,
                noise_coarse=noise_coarse, noise_fine=noise_fine,
                # cw == 0 makes the coarse pass forward-only: its weights are
                # detached for the fine samples and loss_c stays a metric.
                coarse_no_grad=(cw == 0.0 and settings.num_fine > 0),
            )
            loss_c = torch.mean((coarse.rgb - target) ** 2)
            loss_f = loss_c
            if fine is None:
                loss = loss_c
            else:
                loss_f = torch.mean((fine.rgb - target) ** 2)
                loss = loss_f if cw == 0.0 else cw * loss_c + loss_f
            profiling.end(sp)
            sp = profiling.begin("obj.backward")
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(leaves.items(), gs)}
        profiling.end(sp)
        return (loss.detach(), (loss_c.detach(), loss_f.detach())), grads

    return autodiff_objective


def build_train_step(engine, intrinsics, near, far, use_ndc: bool = False):
    """The train step of ``engine`` closed over the static scene geometry:
    ``step(state, images, poses, ray_buf=None, *, offset=None, pixels=None,
    u_coarse=None, u_fine=None, noise_coarse=None, noise_fine=None) ->
    (state, metrics)``. ``images`` (N, H, W, 3) and ``poses`` (N, 4, 4) are
    device tensors; the ``shuffled`` sampler reads ``ray_buf`` instead.
    ``use_ndc`` warps the batch into NDC space after the view directions are
    taken from the unwarped rays. The state is updated in place; the metrics
    are device tensors. ``step_id``: the step's number, the request id of its
    span ``step`` (children ``step.batch``, ``step.draws``,
    ``step.objective``, ``step.update``; ``utils/profiling.py``)."""
    cfg = engine.cfg
    settings = cfg.nerf.train
    n_rays = cfg.nerf.num_random_rays
    H, W = intrinsics.height, intrinsics.width
    dist = getattr(intrinsics, "distortion", None)
    use_viewdirs = cfg.nerf.use_viewdirs
    layout: ParamLayout = engine.layout
    sched = lr_schedule(cfg)
    ema_decay = float(cfg.nerf.ema_decay)

    sampler = getattr(settings, "pixel_sampler", "random")
    if sampler not in ("random", "shuffled", "shuffled_epoch"):
        raise ValueError(f"unknown pixel_sampler {sampler!r}")
    if sampler == "shuffled_epoch":
        # In-step identical to "shuffled"; the Trainer re-permutes the buffer
        # between epochs.
        sampler = "shuffled"

    def finish_batch(rays_o, rays_d, target):
        viewdirs = None
        if use_viewdirs:
            viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        if use_ndc:
            rays_o, rays_d = ndc_rays(H, W, intrinsics.fl_x, 1.0, rays_o, rays_d)
        return rays_o, rays_d, viewdirs, target

    def randint(high, shape, gen):
        return torch.randint(0, high, shape, generator=gen, device=gen.device)

    def sample_batch(gen, images, poses, pixels):
        if pixels is None:
            img = randint(images.shape[0], (n_rays,), gen)
            row = randint(H, (n_rays,), gen)
            col = randint(W, (n_rays,), gen)
        else:
            img, row, col = (torch.as_tensor(p, dtype=torch.int64,
                                             device=images.device) for p in pixels)
        target = images[img, row, col]
        c2w = poses[img]
        dirs_cam = pixel_dirs(col.to(torch.float32), row.to(torch.float32),
                              intrinsics.fl_x, intrinsics.fl_y, intrinsics.cx,
                              intrinsics.cy, dist=dist)
        rays_d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], dirs_cam)
        return finish_batch(c2w[:, :3, 3], rays_d, target)

    def sample_batch_shuffled(gen, ray_buf, offset):
        # A RANDOM contiguous window of the pre-shuffled buffer per step, not
        # sequential epoch slices: under sequential consumption each ray
        # recurs with nearly the same batch companions every epoch, Adam's
        # second moments adapt to that fixed structure, and long runs of the
        # reference degraded. The offset stays on the device: the window is
        # read with an index vector, so nothing synchronises with the host.
        n_total = ray_buf["rays_o"].shape[0]
        if offset is None:
            offset = randint(max(n_total - n_rays + 1, 1), (), gen)
        dev = ray_buf["rays_o"].device
        idx = torch.as_tensor(offset, dtype=torch.int64, device=dev) + \
            torch.arange(n_rays, device=dev)
        return finish_batch(ray_buf["rays_o"][idx], ray_buf["rays_d"][idx],
                            ray_buf["target"][idx])

    objective = build_objective(engine, near, far)
    adam: AdamConfig = engine.adam
    decay_masks: Dict[Any, torch.Tensor] = {}
    mesh = getattr(engine, "mesh", None)
    if mesh is not None and n_rays % mesh.world:
        raise ValueError(f"num_random_rays {n_rays} does not split over "
                         f"{mesh.world} ranks")

    def step_draws(gen, u_coarse, u_fine, noise_coarse, noise_fine):
        """The step's global draws after the batch, from ``gen`` in the
        module's order (coarse jitter, coarse noise, fine jitter, fine
        noise; the jitter only with ``perturb``, the noise only with a noise
        std), or the global ones given; then this rank's rows (all of them
        without a mesh). The objective only consumes them, so one device and
        N ranks draw alike."""
        noisy = settings.radiance_field_noise_std > 0

        def draw(x, cols, wanted, fn):
            if x is None and wanted:
                x = fn((n_rays, cols), generator=gen, dtype=torch.float32,
                       device=gen.device)
            return shard_batch(x, mesh)

        Sc, Sf = settings.num_coarse, settings.num_fine
        u_coarse = draw(u_coarse, Sc, settings.perturb, torch.rand)
        noise_coarse = draw(noise_coarse, Sc, noisy, torch.randn)
        if Sf > 0:
            u_fine = draw(u_fine, Sf, settings.perturb, torch.rand)
            s_fine = Sc + Sf if settings.merge_hierarchical else Sf
            noise_fine = draw(noise_fine, s_fine, noisy, torch.randn)
        return u_coarse, u_fine, noise_coarse, noise_fine

    def train_step(state: TrainState, images, poses, ray_buf=None, *,
                   offset=None, pixels=None, u_coarse=None, u_fine=None,
                   noise_coarse=None, noise_fine=None, step_id: int = -1):
        span = profiling.begin("step", step_id)
        sp = profiling.begin("step.batch")
        gen = state.generator
        layout.bind(engine.model, state.params)
        with torch.no_grad():
            if sampler == "shuffled":
                if ray_buf is None:
                    raise ValueError(
                        "pixel_sampler 'shuffled' needs the ray_buf argument "
                        "(Trainer builds it via build_shuffled_ray_buffer)")
                batch = sample_batch_shuffled(gen, ray_buf, offset)
            else:
                batch = sample_batch(gen, images, poses, pixels)
            batch = tuple(shard_batch(t, mesh) for t in batch)
            profiling.end(sp)
            sp = profiling.begin("step.draws")
            u_coarse, u_fine, noise_coarse, noise_fine = step_draws(
                gen, u_coarse, u_fine, noise_coarse, noise_fine)
            profiling.end(sp)
        sp = profiling.begin("step.objective")
        (loss, (loss_c, loss_f)), grads = objective(
            batch, state.aux, gen, u_coarse=u_coarse, u_fine=u_fine,
            noise_coarse=noise_coarse, noise_fine=noise_fine)
        profiling.end(sp)
        sp = profiling.begin("step.update")
        with torch.no_grad():
            dev = state.params.device
            if adam.weight_decay and dev not in decay_masks:
                decay_masks[dev] = layout.decay_mask(dev, adam.weight_decay)
            g = layout.flatten(grads)
            if mesh is not None:
                g = all_reduce_mean(g, mesh)
                loss, loss_c, loss_f = all_reduce_mean(
                    torch.stack([loss, loss_c, loss_f]), mesh)
            adam_update(state.params, g, state.opt_state, sched,
                        decay_masks.get(dev), adam)
            if state.ema is not None:
                state.ema.mul_(ema_decay).add_(state.params,
                                               alpha=1.0 - ema_decay)
            state.step += 1
            metrics = {
                "loss": loss,
                "loss_coarse": loss_c,
                "loss_fine": loss_f,
                "psnr": -10.0 * torch.log10(torch.clamp(loss_f, min=1e-12)),
            }
        profiling.end(sp)
        profiling.end(span)
        return state, metrics

    return train_step


def build_train_many(engine, intrinsics, near, far, use_ndc: bool = False,
                     steps_per_call: int = 20):
    """``steps_per_call`` train steps per call, enqueued back to back with no
    host synchronisation in between: ``many(state, images, poses,
    ray_buf=None, first_step=-1) -> (state, metrics)``, the metrics of the
    last step plus ``"losses"``, the (steps_per_call,) device tensor of every
    step's loss. ``first_step``: the first step's number (its span's request
    id), the others following it."""
    step = build_train_step(engine, intrinsics, near, far, use_ndc)

    def many(state: TrainState, images, poses, ray_buf=None, first_step: int = -1):
        losses: List[torch.Tensor] = []
        metrics = {}
        for j in range(steps_per_call):
            state, metrics = step(state, images, poses, ray_buf,
                                  step_id=first_step + j if first_step >= 0 else -1)
            losses.append(metrics["loss"])
        return state, {**metrics, "losses": torch.stack(losses)}

    return many


# ------------------------------------------------------------ classic engine

class ClassicModel(nn.Module):
    """The classic engine's two networks under one module, so that one
    ``ParamLayout`` covers both: ``coarse`` and, when the config has one,
    ``fine`` (parameter names ``coarse.layer1.weight`` ...)."""

    def __init__(self, cfg_coarse, cfg_fine=None, generator=None):
        super().__init__()
        from ..models.flexible_nerf import FlexibleNeRF

        self.coarse = FlexibleNeRF(cfg_coarse, generator)
        self.fine = None if cfg_fine is None else FlexibleNeRF(cfg_fine, generator)


class ClassicNerf:
    """Classic-NeRF engine: coarse (+ fine) ``FlexibleNeRF`` with stratified
    and merged hierarchical sampling, built from a reference-schema Config.
    ``device=None`` means the GPU and raises when there is none; pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernel on the
    CPU.

    Each network's point pipeline goes through the fused kernel
    (``ops/classic_fused_cuda.py``) when its ``fused`` mode is "auto" or "on"
    and the config is one the kernel takes, else through the module. The
    optimizer is ``CLASSIC_ADAM`` (optax's defaults, no decay); the coarse
    pass trains through the coarse loss (weight 1 by default). ``mesh``
    (``parallel/mesh.py``): the ranks the train step splits its rays over."""

    adam = CLASSIC_ADAM

    def __init__(self, cfg, device=None, generator: Optional[torch.Generator] = None,
                 mesh=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        self.model = ClassicModel(cfg.model_coarse, cfg.model_fine,
                                  generator).to(self.device)
        self.model_coarse = self.model.coarse
        self.model_fine = self.model.fine
        self.layout = ParamLayout(self.model)

    # -- weights -------------------------------------------------------------
    def load_flax_params(self, tree: dict) -> None:
        """Load the reference's ``{"coarse": ..., "fine": ...}`` parameter
        trees (numpy arrays) into the model."""
        from ..io.convert import classic_params_from_flax

        with torch.no_grad():
            for name, value in classic_params_from_flax(
                    tree, device=self.device).items():
                self.model.get_parameter(name).copy_(value)

    def bound(self, flat: torch.Tensor):
        """Render with the flat parameter buffer ``flat`` inside the block,
        then go back to what the model showed before."""
        return bound(self.model, self.layout, flat)

    def init_state(self, seed: Optional[int] = None,
                   keep_weights: bool = False) -> TrainState:
        """A fresh training state: newly initialised weights from ``seed``
        (default: experiment.randomseed), or the model's present ones with
        ``keep_weights``; see :func:`new_state`."""
        seed = self.cfg.experiment.randomseed if seed is None else int(seed)
        source = self.model if keep_weights else ClassicModel(
            self.cfg.model_coarse, self.cfg.model_fine,
            generator=torch.Generator().manual_seed(seed))
        return new_state(self.layout, self.model, source, self.device, seed,
                         self.cfg.nerf.ema_decay)

    # -- the two passes ------------------------------------------------------
    def apply_coarse(self, pts, vd):
        return self.model_coarse(pts, vd)

    def apply_fine(self, pts, vd):
        model = self.model_fine if self.model_fine is not None else self.model_coarse
        return model(pts, vd)

    def proposal_for(self, aux, near, far, settings, generator=None):
        """No occupancy proposal: plain stratified coarse samples."""
        return None

    def fused_objective_fn(self, near, far, settings):
        """The classic engine has no one-call objective."""
        return None

    def resolved_coarse_loss_weight(self) -> float:
        """nerf.coarse_loss_weight with -1 resolved to the classic default,
        1.0: the separate coarse network trains only through the coarse
        term."""
        cw = float(self.cfg.nerf.coarse_loss_weight)
        return 1.0 if cw < 0.0 else cw

    @staticmethod
    def _fused_params(model) -> dict:
        """The module's parameters in the kernel's structure: (in, out)
        views of the weights and (out, 1) views of the biases, so gradients
        taken through them land on the module's leaves."""
        lins = model.linears
        return {"W": [l.weight.T for l in lins],
                "b": [l.bias[:, None] for l in lins]}

    def cf_apply_fns(self):
        """(coarse_cf, fine_cf) channels-first fused entries for
        ``render_rays``, or None for a network that takes the module route.
        A network's ``fused`` mode "off" (or YAML's false) keeps the module;
        "auto" / "on" (or true) take the kernel for CUDA tensors and its
        plain version for CPU tensors, unless the config is one the kernel
        does not take: then a warning is logged and the module is used. When
        only one of the two networks is supported, both stay unfused."""
        from ..ops.classic_fused_cuda import classic_fused_apply_cf, fused_supported

        def make(model):
            if model is None:
                return None
            mcfg = model.config
            mode = {True: "on", False: "off"}.get(mcfg.fused, mcfg.fused)
            if mode == "off":
                return None
            if not fused_supported(mcfg):
                reason = (
                    "the trunk skip connection fires (skip_connect_every="
                    f"{mcfg.skip_connect_every} within trunk_depth="
                    f"{mcfg.trunk_depth})"
                    if mcfg.use_viewdirs else "use_viewdirs is off")
                log.warning(
                    "fused: %s requested but the fused classic kernel does not "
                    "support this config (%s); falling back to the module path",
                    mode, reason)
                return None

            def apply_cf(pts, vd):
                xt = pts.detach().reshape(-1, 3).T.contiguous()
                vdt = vd.detach().reshape(-1, 3).T.contiguous()
                return classic_fused_apply_cf(self._fused_params(model), xt, vdt,
                                              mcfg)

            return apply_cf

        coarse = make(self.model_coarse)
        if self.model_fine is None:
            return coarse, coarse
        fine = make(self.model_fine)
        if (coarse is None) != (fine is None):
            # one network's entry must never meet the other's parameters
            return None, None
        return coarse, fine

    # -- training ------------------------------------------------------------
    def make_train_step(self, intrinsics, near, far, use_ndc: bool = False):
        """(state, images, poses, ray_buf=None) -> (state, metrics); see
        ``build_train_step``."""
        return build_train_step(self, intrinsics, near, far, use_ndc)

    def make_train_many(self, intrinsics, near, far, use_ndc: bool = False,
                        steps_per_call: int = 20):
        """``steps_per_call`` steps per call with no host synchronisation in
        between; see ``build_train_many``."""
        return build_train_many(self, intrinsics, near, far, use_ndc,
                                steps_per_call)

    # -- evaluation ----------------------------------------------------------
    def make_render_fn(self, intrinsics, near, far, use_ndc: bool = False,
                       settings=None, chunk_rays: Optional[int] = None):
        """Full-image renderer: (c2w, aux=None) -> maps dict, with whatever
        parameters the model is bound to. ``settings`` overrides the sample
        budget (default: cfg.nerf.validation); ``chunk_rays`` defaults to
        ``settings.chunksize`` over the samples per ray."""
        cfg = self.cfg
        settings = settings or cfg.nerf.validation
        H, W = intrinsics.height, intrinsics.width
        has_fine = self.model_fine is not None and settings.num_fine > 0
        cf_coarse, cf_fine = self.cf_apply_fns()

        def render_view(c2w, aux=None):
            c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
            rays_o, rays_d = get_rays(
                H, W, intrinsics.fl_x, c2w, cx=intrinsics.cx, cy=intrinsics.cy,
                focal_y=intrinsics.fl_y,
                dist=getattr(intrinsics, "distortion", None))
            viewdirs = None
            if cfg.nerf.use_viewdirs:
                viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
            if use_ndc:
                rays_o, rays_d = ndc_rays(H, W, intrinsics.fl_x, 1.0, rays_o, rays_d)
            return render_image(
                cf_coarse, rays_o, rays_d, near, far, settings,
                apply_fine_cf=cf_fine if has_fine else None,
                use_viewdirs=cfg.nerf.use_viewdirs, chunk_rays=chunk_rays,
                viewdirs=viewdirs,
                apply_coarse=self.apply_coarse,
                apply_fine=self.apply_fine if has_fine else None)

        return render_view
