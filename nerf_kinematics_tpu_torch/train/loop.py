"""Training state and the train step of the fast engine.

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
  3. the fine depth jitter, (n_rays, num_fine) uniforms.

Every one of them can be passed in instead (``offset=``, ``pixels=``,
``u_coarse=``, ``u_fine=``), which is how tests feed this package and the
reference the same numbers.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from ..cameras.rays import pixel_dirs
from ..rendering.renderer import render_rays

# Adam as the fast engine uses it (NGP practice): b2 0.99, eps 1e-15 outside
# the square root, L2 decay on the MLP kernels only.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.99, 1e-15
WEIGHT_DECAY = 1e-6


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

    def decay_mask(self, device=None) -> torch.Tensor:
        """``WEIGHT_DECAY`` on the MLP kernels, 0 on the encoding tables and
        the biases."""
        mask = torch.zeros(self.total, dtype=torch.float32, device=device)
        for name, _, off, n in self.entries:
            if name.endswith(".kernel"):
                mask[off : off + n] = WEIGHT_DECAY
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
                sched, decay_mask: torch.Tensor) -> None:
    """One optimizer step over the flat buffer, in place.

    The decay term ``decay_mask * p`` is added to the gradient **before**
    Adam (coupled L2: it goes through both moments), the moments are bias
    corrected with the count after this update, eps is added outside the
    square root, and the learning rate is the schedule at the count before
    it is incremented."""
    g = grads + decay_mask * params
    opt.mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
    opt.nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
    lr = sched(opt.count)
    t = (opt.count + 1).to(torch.float32)
    mu_hat = opt.mu / (1.0 - torch.pow(ADAM_B1, t))
    nu_hat = opt.nu / (1.0 - torch.pow(ADAM_B2, t))
    params.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS)))
    opt.count += 1


def build_objective(engine, near, far):
    """Loss and gradients of one ray batch, by the route the engine's
    configuration selects: ``objective(batch, aux, gen, u_coarse=None,
    u_fine=None) -> ((loss, (loss_c, loss_f)), grads)``. ``batch`` =
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

    def autodiff_objective(batch, aux, gen, u_coarse=None, u_fine=None):
        rays_o, rays_d, viewdirs, target = batch
        leaves = dict(engine.model.named_parameters())
        with torch.enable_grad():
            coarse, fine = render_rays(
                cf_coarse, rays_o, rays_d, near, far, settings, generator=gen,
                apply_fine_cf=cf_fine, use_viewdirs=cfg.nerf.use_viewdirs,
                viewdirs=viewdirs,
                proposal_fn=engine.proposal_for(aux, near, far, settings, gen),
                apply_coarse=engine.apply_coarse, apply_fine=engine.apply_fine,
                u_coarse=u_coarse, u_fine=u_fine,
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
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        grads = {k: (torch.zeros_like(p) if g is None else g)
                 for (k, p), g in zip(leaves.items(), gs)}
        return (loss.detach(), (loss_c.detach(), loss_f.detach())), grads

    return autodiff_objective


def build_train_step(engine, intrinsics, near, far, use_ndc: bool = False):
    """The train step of ``engine`` closed over the static scene geometry:
    ``step(state, images, poses, ray_buf=None, *, offset=None, pixels=None,
    u_coarse=None, u_fine=None) -> (state, metrics)``. ``images``
    (N, H, W, 3) and ``poses`` (N, 4, 4) are device tensors; the ``shuffled``
    sampler reads ``ray_buf`` instead. The state is updated in place; the
    metrics are device tensors."""
    if use_ndc:
        raise NotImplementedError("NDC rays are not ported yet (ROADMAP A.4)")
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
    decay_masks: Dict[Any, torch.Tensor] = {}

    def train_step(state: TrainState, images, poses, ray_buf=None, *,
                   offset=None, pixels=None, u_coarse=None, u_fine=None):
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
        (loss, (loss_c, loss_f)), grads = objective(
            batch, state.aux, gen, u_coarse=u_coarse, u_fine=u_fine)
        with torch.no_grad():
            dev = state.params.device
            if dev not in decay_masks:
                decay_masks[dev] = layout.decay_mask(dev)
            adam_update(state.params, layout.flatten(grads), state.opt_state,
                        sched, decay_masks[dev])
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
        return state, metrics

    return train_step


def build_train_many(engine, intrinsics, near, far, use_ndc: bool = False,
                     steps_per_call: int = 20):
    """``steps_per_call`` train steps per call, enqueued back to back with no
    host synchronisation in between: ``many(state, images, poses,
    ray_buf=None) -> (state, metrics)``, the metrics of the last step plus
    ``"losses"``, the (steps_per_call,) device tensor of every step's loss."""
    step = build_train_step(engine, intrinsics, near, far, use_ndc)

    def many(state: TrainState, images, poses, ray_buf=None):
        losses: List[torch.Tensor] = []
        metrics = {}
        for _ in range(steps_per_call):
            state, metrics = step(state, images, poses, ray_buf)
            losses.append(metrics["loss"])
        return state, {**metrics, "losses": torch.stack(losses)}

    return many
