"""Photometric SE(3) pose refinement against a trained NGP field.

The SfM poses (``poses/sfm.py``) are good to about 1 px of reprojection,
but a trained field sharpens measurably when each camera is nudged to
maximise photometric agreement (BARF / instant-ngp pose-refinement
practice).

The training path's kernels give no gradient to the point positions (they
are data there), so refinement runs a differentiable replica of the model
in plain PyTorch autograd: ``cp_encode_stacked(point_grads=True)`` (the
CP encoder's function with its tents differentiable in the points,
``ops/cp_grid.py``) and the MLP chain of ``models/ngp.py`` applied to the
same, frozen parameters. Gradients flow loss -> rgb -> points -> rays ->
SE(3) delta. Sample depths come from the engine's occupancy proposal
(``NGPEngine.proposal_for``: on the card the hull lookup's kernel) and are
detached: the derivative through sample PLACEMENT is noise, the derivative
through sample POSITION is the signal.

``refine_pose`` optimises one camera (6 parameters), for aligning a
held-out pose photometrically. ``refine_poses`` refines every train pose
against its own pixels with the model frozen.

Counterpart of ``nerf_kinematics_tpu/poses/refine.py``. The proposal is
deterministic (``perturb`` off, as in the JAX package), so the only draws
are the pixel indices (``px``) and, in ``refine_poses``, the image of each
step (``idx``). JAX's and torch's random streams differ, so they come from
a ``torch.Generator`` seeded with ``seed`` on the engine's device, or are
passed in, one row per iteration. Adam has optax's defaults.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..cameras.rays import pixel_dirs
from ..ops.cp_grid import cp_encode_stacked
from ..ops.sampling import linspace
from ..ops.sh import sh_encode
from ..ops.volume_render import raw2outputs
from ..rendering.renderer import RenderSettings
from ..train.loop import CLASSIC_ADAM, AdamState, adam_update

def _hat(w: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(w[0])
    return torch.stack([
        torch.stack([zero, -w[2], w[1]]),
        torch.stack([w[2], zero, -w[0]]),
        torch.stack([-w[1], w[0], zero]),
    ])


def se3_exp(delta: torch.Tensor) -> torch.Tensor:
    """(6,) [omega | v] -> (4, 4) SE(3) exponential (Rodrigues + exact V).

    Differentiable AT omega = 0 (the optimiser's starting point): the angle
    is sqrt(|omega|^2 + eps) -- d|omega|/d omega at zero is 0/0 -- and the
    sinc-like coefficients switch to their Taylor forms for small angles
    (``torch.where`` evaluates and differentiates both branches, so each
    must be finite everywhere)."""
    w, v = delta[:3], delta[3:]
    th2 = torch.sum(w * w)
    th = torch.sqrt(th2 + 1e-16)
    small = th < 1e-4
    K = _hat(w)
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th2 + 1e-16))
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (1.0 - torch.sin(th) / th) / (th2 + 1e-16))
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    KK = K @ K
    R = eye + A * K + B * KK
    V = eye + B * K + C * KK
    top = torch.cat([R, (V @ v)[:, None]], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=delta.dtype, device=delta.device)
    return torch.cat([top, bottom], dim=0)


def apply_delta(c2w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Left-apply a world-frame SE(3) perturbation to a camera-to-world."""
    return se3_exp(delta) @ c2w


def frozen_params(engine, params: torch.Tensor) -> dict:
    """The engine's model parameters by name, detached: views of the flat
    buffer ``params`` (a state's parameters). No copy is made."""
    return {n: v.detach() for n, v in engine.layout.views(params).items()}


def _mlp(params: dict, names, h):
    for i, n in enumerate(names):
        h = h @ params[f"{n}.kernel"] + params[f"{n}.bias"]
        if i < len(names) - 1:
            h = torch.relu(h)
    return h


def ngp_apply_diff(params: dict, ngp_cfg, xyz_unit: torch.Tensor,
                   viewdirs: torch.Tensor):
    """Differentiable-by-position replica of ``NGPModel.forward`` for the
    CP encoder: (..., 3) unit-cube points -> (rgb logits, sigma), in f32.
    ``params`` maps the model's parameter names to tensors
    (:func:`frozen_params`). The chain of ``models/ngp.py`` (same layer
    names, the f32 sigma path: clamp to [-15, 15], exp)."""
    enc = cp_encode_stacked(params["cp_lines"], xyz_unit, ngp_cfg.cp, point_grads=True)
    d_names = [f"density_{i}" for i in range(ngp_cfg.density_layers - 1)]
    d_names.append("density_out")
    feat = _mlp(params, d_names, enc)
    sigma = torch.exp(torch.clamp(feat[..., 0].to(torch.float32), -15.0, 15.0))
    sh = sh_encode(viewdirs, ngp_cfg.sh_degree)
    c_names = [f"color_{i}" for i in range(ngp_cfg.color_layers - 1)]
    c_names.append("color_out")
    rgb = _mlp(params, c_names, torch.cat([feat, sh], dim=-1))
    return rgb.to(torch.float32), sigma


def _render_loss(engine, frozen, proposal, c2w, target, px, W, intrinsics, near, far,
                 n_samples, white_background):
    """Photometric MSE of the rays through pixels ``px`` of a camera at
    ``c2w`` against ``target`` (n_rays, 3)."""
    dev = c2w.device
    row = torch.div(px, W, rounding_mode="floor").to(torch.float32)
    col = (px % W).to(torch.float32)
    dirs_cam = pixel_dirs(col, row, intrinsics.fl_x, intrinsics.fl_y, intrinsics.cx,
                          intrinsics.cy, dist=getattr(intrinsics, "distortion", None))
    rays_d = dirs_cam @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    n_rays = px.shape[0]
    with torch.no_grad():
        if proposal is not None:
            z = proposal(rays_o.detach(), rays_d.detach())
        else:
            t = linspace(0.0, 1.0, n_samples, device=dev)
            z = (near + (far - near) * t).expand(n_rays, n_samples)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    vd = viewdirs[:, None, :].expand(pts.shape)
    rgb_raw, sigma = ngp_apply_diff(frozen, engine.ngp_config, engine._to_unit(pts), vd)
    out = raw2outputs(rgb_raw, sigma, z, rays_d, white_background=white_background)
    return torch.mean((out.rgb - target) ** 2)


def _proposal(engine, aux, near, far, n_samples):
    """The engine's occupancy proposal with ``perturb`` off: depths placed
    deterministically, with no draws."""
    return engine.proposal_for(aux, near, far,
                               RenderSettings(num_coarse=n_samples, perturb=False))


def make_photometric_loss(engine, params, aux, image, intrinsics, near, far,
                          n_samples: int = 64, n_rays: int = 4096,
                          white_background: bool = True,
                          generator: Optional[torch.Generator] = None):
    """``(delta (6,), base c2w (4, 4), px=None)`` -> photometric MSE on a
    pixel batch, differentiable w.r.t. ``delta``. The model is FROZEN (the
    flat buffer ``params``, detached); sample depths come from the engine's
    deterministic occupancy proposal, detached. ``px`` (n_rays,) pixel
    indices into the flattened image, else drawn from ``generator``."""
    dev = engine.device
    H, W = intrinsics.height, intrinsics.width
    frozen = frozen_params(engine, params)
    pixels = torch.as_tensor(image, dtype=torch.float32, device=dev).reshape(H * W, -1)[:, :3]
    proposal = _proposal(engine, aux, near, far, n_samples)

    def loss_fn(delta, c2w0, px=None):
        if px is None:
            px = torch.randint(0, H * W, (n_rays,), generator=generator, device=dev)
        px = torch.as_tensor(px, device=dev)
        c2w = apply_delta(c2w0, delta)
        return _render_loss(engine, frozen, proposal, c2w, pixels[px], px, W, intrinsics,
                            near, far, n_samples, white_background)

    return loss_fn


def _adam(p: torch.Tensor, lr: float):
    """optax.adam(lr) with its defaults on ``p``: ``step(g)`` updates it in
    place (``train/loop.py``'s Adam, as the classic engine takes it)."""
    opt = AdamState(torch.zeros_like(p), torch.zeros_like(p),
                    torch.zeros((), dtype=torch.long, device=p.device))

    @torch.no_grad()
    def step(g: torch.Tensor) -> None:
        adam_update(p, g, opt, lambda count: lr, None, CLASSIC_ADAM)

    return step


def _draw(draws, k):
    return None if draws is None else draws[k]


def refine_pose(engine, params, aux, image, c2w0, intrinsics, near, far,
                n_iters: int = 60, n_rays: int = 4096, n_samples: int = 64,
                lr: float = 3e-4, seed: int = 0,
                white_background: bool = True, delta0=None, px=None):
    """Optimise one camera's SE(3) delta photometrically on the engine's
    device. Returns (refined c2w (4, 4), delta (6,), per-iteration losses).
    ``px`` (n_iters, n_rays) replaces the draws of the generator seeded
    with ``seed``."""
    dev = engine.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    loss_fn = make_photometric_loss(
        engine, params, aux, image, intrinsics, near, far,
        n_samples=n_samples, n_rays=n_rays,
        white_background=white_background, generator=generator,
    )
    c2w0 = torch.as_tensor(c2w0, dtype=torch.float32, device=dev)
    delta = (torch.zeros(6, device=dev) if delta0 is None
             else torch.as_tensor(delta0, dtype=torch.float32, device=dev).clone())
    delta.requires_grad_(True)
    adam = _adam(delta, lr)
    losses = []
    for k in range(n_iters):
        loss = loss_fn(delta, c2w0, px=_draw(px, k))
        (g,) = torch.autograd.grad(loss, delta)
        adam(g)
        losses.append(loss.detach())
    delta = delta.detach()
    with torch.no_grad():
        refined = apply_delta(c2w0, delta)
    return refined, delta, [float(x) for x in torch.stack(losses).cpu()] if losses else []


def refine_poses(engine, params, aux, images, c2ws, intrinsics, near, far,
                 n_iters: int = 200, n_rays: int = 2048,
                 n_samples: int = 64, lr: float = 3e-4, seed: int = 0,
                 white_background: bool = True, idx=None, px=None):
    """Refine every train pose against a frozen model: one (N, 6) delta
    tensor; each iteration draws one image and a pixel batch from it, and a
    dense Adam step updates the deltas (only that image's has a gradient).
    ``idx`` (n_iters,) and ``px`` (n_iters, n_rays) replace the generator's
    draws. The images, poses and frozen parameters go to the
    device once. Returns (refined c2ws (N, 4, 4), deltas (N, 6))."""
    dev = engine.device
    generator = torch.Generator(device=dev).manual_seed(seed)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    c2ws = torch.as_tensor(c2ws, dtype=torch.float32, device=dev)
    n = c2ws.shape[0]
    H, W = intrinsics.height, intrinsics.width
    pixels = images[..., :3].reshape(n * H * W, 3)
    frozen = frozen_params(engine, params)
    proposal = _proposal(engine, aux, near, far, n_samples)

    deltas = torch.zeros(n, 6, device=dev, requires_grad=True)
    adam = _adam(deltas, lr)
    for k in range(n_iters):
        i = _draw(idx, k)
        if i is None:
            i = torch.randint(0, n, (), generator=generator, device=dev)
        p = _draw(px, k)
        if p is None:
            p = torch.randint(0, H * W, (n_rays,), generator=generator, device=dev)
        p = torch.as_tensor(p, device=dev)
        i = torch.as_tensor(i, device=dev).reshape(1)
        c2w = apply_delta(c2ws.index_select(0, i)[0], deltas.index_select(0, i)[0])
        loss = _render_loss(engine, frozen, proposal, c2w, pixels[i * (H * W) + p], p, W,
                            intrinsics, near, far, n_samples, white_background)
        (g,) = torch.autograd.grad(loss, deltas)
        adam(g)
    deltas = deltas.detach()
    with torch.no_grad():
        refined = torch.stack([apply_delta(c2ws[i], deltas[i]) for i in range(n)])
    return refined, deltas
