"""Plain float32 reference of the fast NeRF engine: the CP-grid encoder, the
density and color MLPs, the visual-hull occupancy proposal and its refresh,
inverse-CDF sampling, compositing, the training loss, its gradient by
autograd, Adam, and the serving renderer's shared-coarse frame.

It follows the equations of the engine as the repository describes them
(``ARCHITECTURE.md``; the modules of ``nerf_kinematics_tpu_torch`` at commit
83f8678 name them: ``ops/cp_grid.py``, ``models/ngp.py``, ``ops/sh.py``,
``ops/occupancy.py``, ``ops/sampling.py``, ``ops/volume_render.py``,
``ops/contraction.py``, ``train/loop.py``, ``train/ngp_engine.py``,
``rendering/fast_render.py``) and imports nothing of either package. Every
product is float32 (TF32 is switched off by the caller on a GPU); where the
program rounds operands to bf16, this reference does not, unless ``rnd``
asks it to round them another way (the lower-precision control).

Departures, each deliberate: the occupancy projections are not rounded to
bf16 (the program's lookup reads them so rounded); NaN and inf inputs are
not handled (the benchmark's inputs are finite).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Rnd = Callable[[torch.Tensor], torch.Tensor]


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at +-448) in the forward pass; the
    gradient passes straight through."""
    r = t.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(torch.float32)
    return t + (r - t).detach()


PRECISIONS = {"f32": exact, "fp8": fp8}

# ---------------------------------------------------------------- sizes


def model_spec(sizes: dict) -> dict:
    """The model's shapes from a configuration file's ``sizes`` block."""
    cp = dict(sizes["cp"])
    L = cp["n_levels"]
    b = math.exp((math.log(cp["max_resolution"]) - math.log(cp["base_resolution"]))
                 / (L - 1)) if L > 1 else 1.0
    cp["resolutions"] = [int(round(cp["base_resolution"] * b**l)) for l in range(L)]
    enc = L * cp["n_components"]
    dw, dl, do = sizes["density_width"], sizes["density_layers"], sizes["density_out"]
    cw, cl, sh = sizes["color_width"], sizes["color_layers"], sizes["sh_degree"]
    d_in = [enc] + [dw] * (dl - 1)
    d_out = [dw] * (dl - 1) + [do]
    c_in = [do + sh * sh] + [cw] * (cl - 1)
    c_out = [cw] * (cl - 1) + [3]
    return {
        "cp": cp, "sh_degree": sh,
        "density_names": [f"density_{i}" for i in range(dl - 1)] + ["density_out"],
        "color_names": [f"color_{i}" for i in range(cl - 1)] + ["color_out"],
        "density_dims": list(zip(d_in, d_out)), "color_dims": list(zip(c_in, c_out)),
    }


# ---------------------------------------------------------------- the field


def cp_encode(lines: torch.Tensor, x: torch.Tensor, spec: dict, rnd: Rnd = exact):
    """(N, 3) unit-cube points -> (N, L*C): per level the product over the
    three axes of the tent-interpolated line rows; a level whose resolution
    reaches the table wraps its cells periodically into it."""
    cp = spec["cp"]
    T = cp["table_size"]
    x = torch.clamp(x.detach(), 0.0, 1.0)
    feats = []
    for l, R in enumerate(cp["resolutions"]):
        F = T if R >= T else 0
        f = None
        for a in range(3):
            p = torch.clamp(x[:, a] * float(R), 0.0, R - 1e-4)
            pm = torch.fmod(p, float(F)) if F else p
            t0 = torch.floor(pm)
            w1 = pm - t0
            w0 = 1.0 - w1
            r0 = t0.to(torch.int64)
            r1 = r0 + 1
            if F:
                r1 = torch.where(r1 >= F, r1 - F, r1)
            tab = rnd(lines[l, a])
            u = rnd(w0)[:, None] * tab[r0] + rnd(w1)[:, None] * tab[r1]
            f = u if f is None else f * u
        feats.append(f)
    return torch.cat(feats, dim=-1)


def mlp(h, params: dict, names, rnd: Rnd = exact):
    for i, name in enumerate(names):
        h = rnd(h) @ rnd(params[name + ".kernel"]) + params[name + ".bias"]
        if i < len(names) - 1:
            h = torch.relu(h)
    return h


def sh_encode(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real spherical harmonics of unit directions, degree 4 (16 values)."""
    if degree != 4:
        raise ValueError("the reference takes sh_degree 4")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z, 0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy), 2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz), 1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


def density(params, x, spec, rnd: Rnd = exact):
    """(N, 3) unit points -> (sigma (N,), density features (N, out))."""
    feat = mlp(cp_encode(params["cp_lines"], x, spec, rnd), params,
               spec["density_names"], rnd)
    return torch.exp(torch.clamp(feat[:, 0], -15.0, 15.0)), feat


def field(params, x, vd, spec, rnd: Rnd = exact):
    """(N, 3) unit points and unit directions -> (rgb logits (N, 3), sigma)."""
    sigma, feat = density(params, x, spec, rnd)
    h = torch.cat([feat, sh_encode(vd, spec["sh_degree"])], dim=-1)
    return mlp(h, params, spec["color_names"], rnd), sigma


def chunked(fn, n: int, chunk: int):
    outs = [fn(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    return [torch.cat(parts) for parts in zip(*outs)]


# ---------------------------------------------------------------- scene maps


class SceneMap:
    """World <-> the model's unit cube: linear over [-bound, bound]^3, or the
    L-infinity contraction with linear half-width ``inner``."""

    def __init__(self, bound: float, contracted: bool, inner: float):
        self.bound, self.contracted, self.inner = bound, contracted, inner

    def to_unit(self, p):
        if not self.contracted:
            return p / (2.0 * self.bound) + 0.5
        x = p / self.inner
        n = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-9)
        scale = torch.where(n <= 1.0, torch.ones_like(n), (2.0 - 1.0 / n) / n)
        return x * scale * 0.25 + 0.5

    def from_unit(self, u):
        if not self.contracted:
            return (u * 2.0 - 1.0) * self.bound
        c = (u - 0.5) * 4.0
        m = torch.clamp(c.abs().amax(dim=-1, keepdim=True), 1e-9, 2.0 - 1e-6)
        scale = torch.where(m <= 1.0, torch.ones_like(m), 1.0 / (m * (2.0 - m)))
        return c * scale * self.inner


def scene_map(scene_aabb: float, ngp: dict, bound: Optional[float] = None) -> SceneMap:
    """The model's map of a scene of ``aabb_scale`` ``scene_aabb``; with
    ``bound`` the same contraction over another linear box (an occupancy
    grid's own bound)."""
    scene_bound = max(scene_aabb / 2.0, 1.0)
    if bound is None:
        bound = scene_bound
    mode = ngp.get("contraction", "auto")
    mode = {True: "on", False: "off"}.get(mode, mode)
    contracted = mode == "on" or (mode == "auto" and scene_bound > 2.0)
    inner = float(ngp.get("contract_inner", 0.0)) or max(1.0, scene_bound / 4.0)
    return SceneMap(bound, contracted, inner)


# ---------------------------------------------------------------- sampling


def blend_linspace(a: float, b: float, n: int, device):
    step = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    return torch.cat([a * (1.0 - step) + b * step,
                      torch.full((1,), float(b), device=device)])


def sample_pdf(bins, weights, n: int, positions):
    """Inverse CDF of the piecewise-constant density ``weights`` over
    ``bins`` (..., M+1) at ``positions`` (..., n) in [0, 1]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf, dim=-1)], -1)
    M1 = cdf.shape[-1]
    inds = torch.clamp(torch.searchsorted(cdf.contiguous(), positions.contiguous(),
                                          right=True), 1, M1 - 1)
    below = inds - 1
    bins = bins.expand(*cdf.shape[:-1], M1)
    c0, c1 = torch.gather(cdf, -1, below), torch.gather(cdf, -1, inds)
    b0, b1 = torch.gather(bins, -1, below), torch.gather(bins, -1, inds)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (positions - c0) / denom * (b1 - b0)


def stratified_positions(u, n: int):
    """Jittered ``(i + u_i) / n``: sorted positions in [0, 1)."""
    return torch.arange(n, dtype=torch.float32, device=u.device) / n + u / n


def even_positions(rows: int, n: int, device):
    return blend_linspace(0.0, 1.0, n, device).expand(rows, n)


def hull_occupancy(grid: torch.Tensor, u01: torch.Tensor) -> torch.Tensor:
    """Visual-hull proxy of the grid at unit points (N, 3): the least of
    its three pair max-projections at the point's cell."""
    R = grid.shape[0]
    pxy, pxz, pyz = grid.amax(dim=2), grid.amax(dim=1), grid.amax(dim=0)
    idx = torch.floor(torch.clamp(u01 * float(R), 0.0, float(R - 1))).to(torch.int64)
    ix, iy, iz = idx[:, 0], idx[:, 1], idx[:, 2]
    return torch.minimum(pxy[ix, iy], torch.minimum(pxz[ix, iz], pyz[iy, iz]))


def proposal(grid, gmap: SceneMap, rays_o, rays_d, near, far, n: int, bins_n: int,
             floor: float, positions):
    """Occupancy-placed depths (rays, n): uniform bins over [near, far],
    each weighted by the hull occupancy at its centre (over the ray's
    largest, plus ``floor``), then the inverse CDF at ``positions``."""
    R = rays_o.shape[0]
    bins = blend_linspace(float(near), float(far), bins_n + 1, rays_o.device).expand(
        R, bins_n + 1)
    mids = 0.5 * (bins[:, 1:] + bins[:, :-1])
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mids[..., None]
    occ = hull_occupancy(grid, gmap.to_unit(pts).reshape(-1, 3)).reshape(R, bins_n)
    w = occ / (occ.amax(dim=-1, keepdim=True) + 1e-9) + floor
    return sample_pdf(bins, w, n, positions)


def refresh_full(grid, params, spec, smap: SceneMap, gmap: SceneMap, u,
                 rnd: Rnd = exact, decay: float = 0.95, chunk: int = 65536):
    """The full occupancy sweep: density at one jittered point per cell
    (``u`` (R^3, 3) in [0, 1)), new grid = max(decay * old, density). The
    cells are placed by the grid's map ``gmap``, the field read through the
    model's ``smap``."""
    R = grid.shape[0]
    lin = (torch.arange(R, dtype=torch.float32, device=grid.device) + 0.5) / R
    xs, ys, zs = torch.meshgrid(lin, lin, lin, indexing="ij")
    u01 = torch.stack([xs, ys, zs], -1).reshape(-1, 3)
    pts = gmap.from_unit(torch.clamp(u01 + (u - 0.5) / R, 0.0, 1.0))
    with torch.no_grad():
        (sig,) = chunked(lambda s, e: (density(params, smap.to_unit(pts[s:e]), spec,
                                               rnd)[0],), pts.shape[0], chunk)
    return torch.maximum(grid * decay, sig.reshape(R, R, R))


# ---------------------------------------------------------------- compositing


def composite(sigma, rgb, z, rays_d, white: bool):
    """sigma (R, S), rgb (R, S, 3) in [0, 1] -> (rgb map (R, 3), acc (R,),
    weights (R, S)); the last interval is 1e10 |d|."""
    d = z[..., 1:] - z[..., :-1]
    d = torch.cat([d, torch.full_like(d[..., :1], 1e10)], dim=-1)
    d = d * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * d)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    w = alpha * trans
    out = (w[..., None] * rgb).sum(dim=-2)
    acc = w.sum(dim=-1)
    if white:
        out = out + (1.0 - acc)[..., None]
    return out, acc, w


# ---------------------------------------------------------------- training


def train_loss(params, spec, smap, gmap, grid, batch, u_coarse, u_fine, t: dict,
               rnd: Rnd = exact):
    """MSE of one ray batch (rays_o, rays_d, viewdirs, target). With fine
    samples the coarse pass is density only and places them without a
    gradient (coarse loss weight 0); without, the coarse pass is the loss."""
    o, d, vd, target = batch
    R, Sc, Sf = o.shape[0], t["num_coarse"], t["num_fine"]
    z = proposal(grid, gmap, o, d, t["near"], t["far"], Sc, t["occ_bins"],
                 t["occ_floor"], stratified_positions(u_coarse, Sc))
    pts = (o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    if Sf == 0:
        logits, sigma = field(params, smap.to_unit(pts), vd[:, None, :].expand(
            R, Sc, 3).reshape(-1, 3), spec, rnd)
        rgb, _, _ = composite(sigma.reshape(R, Sc), torch.sigmoid(logits).reshape(
            R, Sc, 3), z, d, t["white"])
        return torch.mean((rgb - target) ** 2)
    with torch.no_grad():
        sigma_c, _ = density(params, smap.to_unit(pts), spec, rnd)
        half = torch.full((R, Sc, 3), 0.5, device=o.device)
        _, _, w = composite(sigma_c.reshape(R, Sc), half, z, d, t["white"])
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        zf = sample_pdf(mids, w[:, 1:-1], Sf, stratified_positions(u_fine, Sf))
    ptsf = (o[:, None, :] + d[:, None, :] * zf[..., None]).reshape(-1, 3)
    logits, sigma = field(params, smap.to_unit(ptsf), vd[:, None, :].expand(
        R, Sf, 3).reshape(-1, 3), spec, rnd)
    rgb, _, _ = composite(sigma.reshape(R, Sf), torch.sigmoid(logits).reshape(R, Sf, 3),
                          zf, d, t["white"])
    return torch.mean((rgb - target) ** 2)


def adam_step(params, grads, m, v, count: int, t: dict):
    """Adam over every leaf in place: coupled L2 decay on the kernels, bias
    correction with the count after the update, eps outside the root, the
    learning rate lr0 * factor^(count / (decay_k * 1000)) at the count
    before it."""
    a = t["adam"]
    lr = t["lr"] * t["lr_decay_factor"] ** (count / (t["lr_decay"] * 1000.0))
    for k in params:
        g = grads[k]
        if k.endswith(".kernel"):
            g = g + a["weight_decay"] * params[k]
        m[k].mul_(a["b1"]).add_(g, alpha=1.0 - a["b1"])
        v[k].mul_(a["b2"]).addcmul_(g, g, value=1.0 - a["b2"])
        mh = m[k] / (1.0 - a["b1"] ** (count + 1))
        vh = v[k] / (1.0 - a["b2"] ** (count + 1))
        params[k].sub_(lr * (mh / (torch.sqrt(vh) + a["eps"])))


def train_steps(params, spec, smap, gmap, grid, batches, draws, t: dict, rnd: Rnd = exact):
    """Follow len(batches) steps from ``params`` (changed in place). Returns
    (losses, first gradient as Adam takes it (decay included), parameters
    after the steps)."""
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], None
    for i, (batch, (uc, uf)) in enumerate(zip(batches, draws)):
        leaves = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
        loss = train_loss(leaves, spec, smap, gmap, grid, batch, uc, uf, t, rnd)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        if first is None:
            first = {k: g + (t["adam"]["weight_decay"] * params[k]
                             if k.endswith(".kernel") else 0.0)
                     for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            adam_step(params, grads, m, v, i, t)
    return losses, first, params


# ---------------------------------------------------------------- serving


def view_rays(c2w, intr, device):
    """Rays of a full view (H, W, 3) for intrinsics [fl_x, fl_y, cx, cy, W, H]."""
    fl_x, fl_y, cx, cy, W, H = intr
    W, H = int(W), int(H)
    c2w = torch.as_tensor(c2w, dtype=torch.float32, device=device)
    i = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    j = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    x, y = (i - cx) / fl_x, (j - cy) / fl_y
    dirs = torch.stack([x, -y, -torch.ones_like(x)], dim=-1)
    d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(d.shape), d


def _window_range(img):
    x = img.permute(2, 0, 1)[None]
    mx = torch.nn.functional.max_pool2d(x, 3, stride=1, padding=1)
    mn = -torch.nn.functional.max_pool2d(-x, 3, stride=1, padding=1)
    return (mx - mn)[0].amax(dim=0)


@torch.no_grad()
def render_frame(params, spec, smap, gmap, grid, c2w, intr, r: dict, rnd: Rnd = exact,
                 chunk: int = 1 << 20):
    """One frame of the serving renderer (H, W, 3): the coarse pass once a
    stride x stride block from its first pixel, the proposal at even
    positions; the block's weights blurred one bin and floored; fine depths
    at even positions of that PDF; the fine pass on the fg_fraction of
    blocks with the largest 3x3 range of the coarse image, the other blocks
    keeping their coarse colour."""
    dev = grid.device
    o, d = view_rays(c2w, intr, dev)
    vd = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    H, W = o.shape[:2]
    s = r["stride"]
    Hq, Wq = H // s, W // s
    Nq = Hq * Wq
    blk = lambda x: x.reshape(Hq, s, Wq, s, 3).permute(0, 2, 1, 3, 4).reshape(Nq, s * s, 3)
    ob, db, vb = blk(o), blk(d), blk(vd)
    oq, dq, vq = ob[:, 0], db[:, 0], vb[:, 0]
    Sc, Sf = r["num_coarse"], r["num_fine"]

    def shade(rays_o, rays_d, dirs, z):
        n, S = z.shape

        def one(a, b):
            p = (rays_o[a:b, None, :] + rays_d[a:b, None, :] * z[a:b, :, None]).reshape(-1, 3)
            v = dirs[a:b, None, :].expand(b - a, S, 3).reshape(-1, 3)
            logits, sigma = field(params, smap.to_unit(p), v, spec, rnd)
            return composite(sigma.reshape(b - a, S), torch.sigmoid(logits).reshape(
                b - a, S, 3), z[a:b], rays_d[a:b], r["white"])

        return chunked(one, n, max(1, chunk // S))

    zq = proposal(grid, gmap, oq, dq, r["near"], r["far"], Sc, r["occ_bins"],
                  r["occ_floor"], even_positions(Nq, Sc, dev))
    rgb_q, _, w = shade(oq, dq, vq, zq)
    wl = torch.cat([w[:, :1], w[:, :-1]], dim=-1)
    wr = torch.cat([w[:, 1:], w[:, -1:]], dim=-1)
    w = 0.5 * w + 0.25 * (wl + wr)
    w = w + r["pdf_floor"] * torch.amax(w, dim=-1, keepdim=True)
    mids = 0.5 * (zq[:, 1:] + zq[:, :-1])
    zf = sample_pdf(mids, w[:, 1:-1], Sf, even_positions(Nq, Sf, dev))
    K = max(1, int(round(r["fg_fraction"] * Nq)))
    idx = torch.topk(_window_range(rgb_q.reshape(Hq, Wq, 3)).reshape(Nq), K).indices
    n_pk = K * s * s
    zk = zf[idx][:, None, :].expand(K, s * s, Sf).reshape(n_pk, Sf)
    rgb_f, _, _ = shade(ob[idx].reshape(n_pk, 3), db[idx].reshape(n_pk, 3),
                        vb[idx].reshape(n_pk, 3), zk)
    out = rgb_q[:, None].expand(Nq, s * s, 3).clone()
    out[idx] = rgb_f.reshape(K, s * s, 3)
    return out.reshape(Hq, Wq, s, s, 3).permute(0, 2, 1, 3, 4).reshape(H, W, 3)
