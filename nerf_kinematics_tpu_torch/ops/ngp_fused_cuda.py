"""Fused NGP point pipeline: the CUDA kernels' wrappers and their plain
PyTorch versions, forward and gradients.

Replaces, from ``nerf_kinematics_tpu/ops/ngp_fused_pallas.py``:

  * ``ngp_fused_sigma_cf``          -> :func:`ngp_fused_sigma_cf`
  * ``ngp_fused_apply_cf`` forward  -> :func:`ngp_fused_apply_cf`
  * ``ngp_fused_apply_cf`` VJP      -> :func:`ngp_fused_apply_cf_bwd`, the
    backward of the ``autograd.Function`` behind :func:`ngp_fused_apply_cf`
  * ``ngp_fused_train_cf``          -> :func:`ngp_fused_train_cf`
  * ``ngp_fused_apply``             -> :func:`ngp_fused_apply`

Kernel sources: ``csrc/ngp_fused.cu`` (forward), ``csrc/ngp_fused_bwd.cu``
(gradients), ``csrc/ngp_fused.cuh`` (shared). Channels-first IO: ``(3, N)``
unit-cube points and ``(3, N)`` unit view directions -> ``(4, N)``, rows 0-2
rgb logits and row 3 sigma (already exp-activated). ``params`` is the
raw-array dict the reference's kernels take: ``{"lines": (L,3,T,C),
"dW": [(in,out)..], "db": [(out,1)..], "cW": [..], "cb": [..]}``.

Gradient contract (the reference's): exact gradients for the line tables and
every MLP weight and bias, none for points and directions, on both devices.
``ngp_fused_sigma_cf`` has no gradient at all. The lines gradient comes back
in parameter layout: the kernels index the parameter table, so the wrap tap of
a periodic folded level adds into row 0 and a row F < T gets nothing from its
own level (what the reference's ``fold_dlines`` does to its dup-row operand).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cp_grid import CPGridConfig, _round_bf16, cp_encode_stacked
from .cp_grid_cuda import cp_encode_cuda_bwd_ref
from .sh import sh_encode

REF_CHUNK = 1 << 19  # points per chunk of the plain versions
BWD_CHUNK = 1 << 19  # points per launch of the gradient kernels (scratch size)


def _mlp_ref(h, weights, biases, use_bf16: bool):
    """Dense chain on (N, in): bf16-rounded operands (when asked), f32
    accumulation, f32 bias, ReLU between layers and none after the last."""
    n = len(weights)
    for i in range(n):
        w = weights[i].to(torch.float32)
        if use_bf16:
            h = h.to(torch.bfloat16).to(torch.float32)
            w = w.to(torch.bfloat16).to(torch.float32)
        z = h @ w + biases[i].reshape(1, -1)
        h = torch.relu(z) if i < n - 1 else z
    return h


def _sigma_of(feat):
    return torch.exp(torch.clamp(feat[:, 0], -15.0, 15.0))


def _chunked_cf(fn, n: int, device):
    outs = [fn(s, min(s + REF_CHUNK, n)) for s in range(0, n, REF_CHUNK)]
    if not outs:
        return torch.zeros((4, 0), dtype=torch.float32, device=device)
    return torch.cat(outs, dim=1)


def ngp_fused_sigma_cf_ref(params: dict, xt: torch.Tensor,
                           cfg: CPGridConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`ngp_fused_sigma_cf`."""

    def one(s, e):
        enc = cp_encode_stacked(params["lines"], xt[:, s:e].T, cfg)
        feat = _mlp_ref(enc, params["dW"], params["db"], cfg.use_bf16)
        out = torch.zeros((4, e - s), dtype=torch.float32, device=xt.device)
        out[3] = _sigma_of(feat)
        return out

    return _chunked_cf(one, xt.shape[1], xt.device)


def ngp_fused_apply_cf_ref(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                           cfg: CPGridConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`ngp_fused_apply_cf`."""

    def one(s, e):
        enc = cp_encode_stacked(params["lines"], xt[:, s:e].T, cfg)
        feat = _mlp_ref(enc, params["dW"], params["db"], cfg.use_bf16)
        h = torch.cat([feat, sh_encode(vdt[:, s:e].T, 4)], dim=-1)
        rgb = _mlp_ref(h, params["cW"], params["cb"], cfg.use_bf16)
        return torch.cat([rgb.T, _sigma_of(feat)[None]], dim=0)

    return _chunked_cf(one, xt.shape[1], xt.device)


def _fused_args(params: dict, xt, vdt, out, cfg: CPGridConfig, color: bool):
    """Check everything the kernel assumes and fill its argument struct.
    Every pointer in it belongs to a tensor the caller holds."""
    dev = xt.device
    n = xt.shape[1]
    cuda_lib.check_tensor(xt, "xt", (3, None))
    lines = params["lines"]
    cuda_lib.check_tensor(
        lines, "lines",
        (cfg.n_levels, 3, cfg.table_size, cfg.n_components), dev,
    )
    if cfg.n_components % 4:
        raise ValueError("the fused kernel needs n_components % 4 == 0")
    args = cuda_lib.FusedArgs()
    args.xt = xt.data_ptr()
    args.lines = lines.data_ptr()
    args.out = out.data_ptr()
    args.n = n
    args.cp = cuda_lib.cp_levels(cfg)
    if color:
        cuda_lib.check_tensor(vdt, "vdt", (3, n), dev)
        args.vdt = vdt.data_ptr()

    def fill(prefix, Ws, bs, first_in, ptr_w, ptr_b, ins, outs):
        if not 1 <= len(Ws) <= cuda_lib.MAX_LAYERS or len(Ws) != len(bs):
            raise ValueError(f"{prefix}: 1..{cuda_lib.MAX_LAYERS} layers expected")
        width = first_in
        for i, (w, b) in enumerate(zip(Ws, bs)):
            cuda_lib.check_tensor(w, f"{prefix}W[{i}]", (width, None), dev)
            o = w.shape[1]
            if o > cuda_lib.MAX_WIDTH:
                raise ValueError(
                    f"{prefix}W[{i}]: width {o} above the kernel's "
                    f"{cuda_lib.MAX_WIDTH}"
                )
            b = b.reshape(-1)
            cuda_lib.check_tensor(b, f"{prefix}b[{i}]", (o,), dev)
            ptr_w[i], ptr_b[i] = w.data_ptr(), b.data_ptr()
            ins[i], outs[i] = width, o
            width = o
        return width

    args.nd = len(params["dW"])
    dout = fill("d", params["dW"], params["db"], cfg.out_dim,
                args.dW, args.db, args.d_in, args.d_out)
    if color:
        args.nc = len(params["cW"])
        if dout + 16 > cuda_lib.MAX_WIDTH:
            raise ValueError("density_out + 16 above the kernel's width")
        last = fill("c", params["cW"], params["cb"], dout + 16,
                    args.cW, args.cb, args.c_in, args.c_out)
        if last != 3:
            raise ValueError(f"the color MLP must end in 3 channels, got {last}")
    return args


def _launch(params, xt, vdt, cfg: CPGridConfig, color: bool, name: str):
    n = xt.shape[1]
    out = torch.empty((4, n), dtype=torch.float32, device=xt.device)
    if n == 0:
        return out
    args = _fused_args(params, xt, vdt, out, cfg, color)
    lib = cuda_lib.load_library()
    need = lib.nkt_fused_smem_bytes(ctypes.byref(args), int(color))
    if need > cuda_lib.SMEM_LIMIT:
        raise ValueError(
            f"{name}: the layers need {need} B of shared memory, above the "
            f"{cuda_lib.SMEM_LIMIT} B one block may use"
        )
    code = lib.nkt_fused_forward(
        ctypes.byref(args), int(color), cuda_lib.sm_count(xt.device),
        cuda_lib.current_stream(xt.device),
    )
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.raise_on_error(code, name)
    return out


def ngp_fused_sigma_cf(params: dict, xt: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """Density-only fused forward: (3, N) points -> (4, N) with rows 0-2 zero
    and row 3 = sigma. A CUDA tensor goes through the kernel; a CPU tensor
    through the plain version. No gradient: callers pass detached
    parameters."""
    with torch.no_grad():
        if not xt.is_cuda:
            return ngp_fused_sigma_cf_ref(params, xt, cfg)
        return _launch(params, xt, None, cfg, False, "ngp_fused_sigma_cf")


def _fused_forward(params, xt, vdt, cfg):
    if not xt.is_cuda:
        return ngp_fused_apply_cf_ref(params, xt, vdt, cfg)
    return _launch(params, xt, vdt, cfg, True, "ngp_fused_apply_cf")


def _leaves(params: dict):
    return [params["lines"], *params["dW"], *params["db"], *params["cW"],
            *params["cb"]]


def _pack(leaves, nd: int, nc: int) -> dict:
    it = iter(leaves[1:])
    take = lambda k: [next(it) for _ in range(k)]
    return {"lines": leaves[0], "dW": take(nd), "db": take(nd),
            "cW": take(nc), "cb": take(nc)}


class _FusedApply(torch.autograd.Function):
    """:func:`ngp_fused_apply_cf` under autograd: the backward is the
    gradient kernel (or its plain version for CPU tensors); points and
    directions get no gradient."""

    @staticmethod
    def forward(ctx, xt, vdt, cfg, nd, nc, *leaves):
        ctx.cfg, ctx.nd, ctx.nc = cfg, nd, nc
        ctx.save_for_backward(xt, vdt, *leaves)
        return _fused_forward(_pack(leaves, nd, nc), xt, vdt, cfg)

    @staticmethod
    def backward(ctx, g):
        xt, vdt, *leaves = ctx.saved_tensors
        d = ngp_fused_apply_cf_bwd(
            _pack(leaves, ctx.nd, ctx.nc), xt, vdt, g.contiguous(), ctx.cfg)
        return (None, None, None, None, None, *_leaves(d))


def ngp_fused_apply_cf(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """Fused point pipeline, channels-first IO: (3, N) points and (3, N) unit
    view directions -> (4, N), rows 0-2 rgb logits, row 3 sigma. A CUDA
    tensor goes through the kernel; a CPU tensor through the plain version.
    Differentiable in ``params`` only (see the module docstring)."""
    leaves = _leaves(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _FusedApply.apply(xt.detach(), vdt.detach(), cfg,
                                 len(params["dW"]), len(params["cW"]), *leaves)
    with torch.no_grad():
        return _fused_forward(params, xt, vdt, cfg)


def ngp_fused_apply(params: dict, x: torch.Tensor, vd: torch.Tensor,
                    cfg: CPGridConfig):
    """Channels-last wrapper over :func:`ngp_fused_apply_cf`: ``x`` / ``vd``
    (..., 3) -> (rgb logits (..., 3), sigma (...,))."""
    orig = x.shape[:-1]
    xt = x.reshape(-1, 3).T.contiguous()
    vdt = vd.reshape(-1, 3).T.contiguous()
    out = ngp_fused_apply_cf(params, xt, vdt, cfg)
    rgb = out[0:3, :].T.reshape(*orig, 3)
    sigma = out[3, :].reshape(orig)
    return rgb, sigma


# ------------------------------------------------ gradients: plain versions

def _mlp_fwd_save(h, weights, biases, use_bf16: bool):
    """:func:`_mlp_ref` that also returns each layer's (rounded input,
    pre-activation)."""
    pres = []
    n = len(weights)
    for i in range(n):
        w = weights[i].to(torch.float32)
        if use_bf16:
            h, w = _round_bf16(h), _round_bf16(w)
        z = h @ w + biases[i].reshape(1, -1)
        pres.append((h, z))
        h = torch.relu(z) if i < n - 1 else z
    return h, pres


def _mlp_bwd_ref(g, pres, weights, use_bf16: bool):
    """Backward of the dense chain, g (N, out) -> (d_input (N, in), [dW],
    [db (out, 1)]). The masked cotangent is rounded to bf16 once and feeds
    both ``dW = inp^T g`` and ``d_inp = g W^T``; ``db`` sums the f32 one."""
    n = len(weights)
    dWs, dbs = [None] * n, [None] * n
    for i in reversed(range(n)):
        inp, z = pres[i]
        if i < n - 1:
            g = g * (z > 0.0)
        w = weights[i].to(torch.float32)
        gw = g
        if use_bf16:
            gw, w = _round_bf16(g), _round_bf16(w)
        dWs[i] = inp.T @ gw
        dbs[i] = g.sum(dim=0)[:, None]
        g = gw @ w.T
    return g, dWs, dbs


def _forward_saved(params, xt, vdt, cfg: CPGridConfig):
    enc = cp_encode_stacked(params["lines"], xt.T, cfg)
    feat, d_pres = _mlp_fwd_save(enc, params["dW"], params["db"], cfg.use_bf16)
    h = torch.cat([feat, sh_encode(vdt.T, 4)], dim=-1)
    rgb_l, c_pres = _mlp_fwd_save(h, params["cW"], params["cb"], cfg.use_bf16)
    return feat, rgb_l, d_pres, c_pres


def _backward_saved(params, xt, cfg, feat, d_pres, c_pres, g_rgb, g_sigma):
    """(N, 3) / (N,) cotangents of the rgb logits and of sigma -> the
    parameter gradients, through both MLPs and the encoder."""
    bf = cfg.use_bf16
    dh, dcW, dcb = _mlp_bwd_ref(g_rgb, c_pres, params["cW"], bf)
    d_feat = dh[:, : feat.shape[1]].clone()
    # sigma = exp(clip(z0)): its cotangent enters feature 0 where unclipped.
    z0 = feat[:, 0]
    live = (z0 > -15.0) & (z0 < 15.0)
    d_feat[:, 0] += torch.where(live, g_sigma * _sigma_of(feat),
                                torch.zeros_like(z0))
    d_enc, ddW, ddb = _mlp_bwd_ref(d_feat, d_pres, params["dW"], bf)
    dlines = cp_encode_cuda_bwd_ref(params["lines"], xt.T, d_enc, cfg)
    return {"lines": dlines, "dW": ddW, "db": ddb, "cW": dcW, "cb": dcb}


def _sum_grads(parts):
    out = parts[0]
    for d in parts[1:]:
        out = {k: (out[k] + d[k] if k == "lines"
                   else [a + b for a, b in zip(out[k], d[k])]) for k in out}
    return out


def _zero_grads(params):
    z = torch.zeros_like
    return {k: (z(v) if k == "lines" else [z(t) for t in v])
            for k, v in params.items()}


@torch.no_grad()
def ngp_fused_apply_cf_bwd_ref(params: dict, xt: torch.Tensor,
                               vdt: torch.Tensor, g: torch.Tensor,
                               cfg: CPGridConfig) -> dict:
    """Plain PyTorch version of :func:`ngp_fused_apply_cf_bwd`: recompute the
    forward, then take the (4, N) cotangent to every parameter gradient."""
    parts = []
    for s in range(0, xt.shape[1], REF_CHUNK):
        sl = slice(s, s + REF_CHUNK)
        feat, _, d_pres, c_pres = _forward_saved(params, xt[:, sl], vdt[:, sl], cfg)
        parts.append(_backward_saved(
            params, xt[:, sl], cfg, feat, d_pres, c_pres,
            g[0:3, sl].T, g[3, sl]))
    return _sum_grads(parts) if parts else _zero_grads(params)


@torch.no_grad()
def ngp_fused_train_cf_ref(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                           dists: torch.Tensor, tgt_cf: torch.Tensor,
                           cfg: CPGridConfig, S: int, white_bg: bool,
                           inv_denom: float):
    """Plain PyTorch version of :func:`ngp_fused_train_cf`, step by step."""
    n = xt.shape[1]
    R = n // S
    feat, rgb_l, d_pres, c_pres = _forward_saved(params, xt, vdt, cfg)
    sigma = _sigma_of(feat).reshape(R, S)
    sig = torch.sigmoid(rgb_l).reshape(R, S, 3)
    d = dists.reshape(R, S)

    # ---- per-ray compositing and squared error --------------------------
    alpha = 1.0 - torch.exp(-sigma * d)
    trans = torch.ones(R, dtype=torch.float32, device=xt.device)
    rgb_map = torch.zeros((R, 3), dtype=torch.float32, device=xt.device)
    acc = torch.zeros_like(trans)
    Ts, ws = [], []
    for s in range(S):
        w_s = alpha[:, s] * trans
        rgb_map = rgb_map + w_s[:, None] * sig[:, s]
        acc = acc + w_s
        Ts.append(trans)
        ws.append(w_s)
        trans = trans * (1.0 - alpha[:, s] + 1e-10)
    if white_bg:
        rgb_map = rgb_map + (1.0 - acc)[:, None]
    diff = rgb_map - tgt_cf.T
    err = torch.sum(diff * diff, dim=-1)[None]
    maps = torch.cat([rgb_map.T, acc[None]], dim=0)
    gmap = (2.0 * inv_denom) * diff  # dL/d(rgb_map)

    # ---- compositing backward: the division-free reverse recurrence ------
    #   d alpha_s = (dw_s - dT) * T_s;  dT <- dw_s alpha_s + dT (1 - alpha_s + eps)
    gsum = gmap.sum(dim=-1)
    dT = torch.zeros_like(trans)
    g_sigma = torch.empty_like(sigma)
    g_sig = torch.empty_like(sig)
    for s in reversed(range(S)):
        dw = torch.sum(gmap * sig[:, s], dim=-1)
        if white_bg:
            dw = dw - gsum
        g_sig[:, s] = gmap * ws[s][:, None]
        a_s = alpha[:, s]
        da = (dw - dT) * Ts[s]
        dT = dw * a_s + dT * (1.0 - a_s + 1e-10)
        g_sigma[:, s] = da * (1.0 - a_s) * d[:, s]
    g_rgb = g_sig * sig * (1.0 - sig)  # sigmoid backward

    d_params = _backward_saved(params, xt, cfg, feat, d_pres, c_pres,
                               g_rgb.reshape(n, 3), g_sigma.reshape(n))
    return err, maps, d_params


# ---------------------------------------------------- gradients: the kernels

def _grad_layout(params: dict):
    """(name, index, shape) of the MLP leaves in the order of the kernels'
    flat gradient: per density layer W then b, then the color layers
    (csrc/ngp_fused.cuh::make_rows)."""
    order = []
    for w_key, b_key in (("dW", "db"), ("cW", "cb")):
        for i, (w, b) in enumerate(zip(params[w_key], params[b_key])):
            order.append((w_key, i, tuple(w.shape)))
            order.append((b_key, i, tuple(b.shape)))
    return order


def _launch_grad(params, xt, vdt, cfg: CPGridConfig, g=None, train=None):
    """One launch sequence of the gradient kernels over all of ``xt``.
    ``g``: (4, n) cotangent (the VJP); ``train``: (dists, tgt, S, white_bg,
    inv_denom) for the fused train objective. Returns (d_params, err, maps)."""
    dev = xt.device
    n = xt.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    out4 = torch.empty((4, n), **f32)
    b = cuda_lib.BwdArgs()
    b.f = _fused_args(params, xt, vdt, out4, cfg, True)
    lib = cuda_lib.load_library()
    sizes = (ctypes.c_longlong * 4)()
    lib.nkt_fused_bwd_sizes(ctypes.byref(b.f), sizes)
    act_rows, gs_rows, total, smem = (int(v) for v in sizes)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(
            f"the layers need {smem} B of shared memory, above the "
            f"{cuda_lib.SMEM_LIMIT} B one block may use")
    n_sm = cuda_lib.sm_count(dev)
    n_part = 2 * n_sm
    act = torch.empty((act_rows, n), **f32)
    gs = torch.empty((gs_rows, n), **f32)
    partial = torch.empty((n_part, total), **f32)
    flat = torch.empty((total,), **f32)
    dlines = torch.zeros_like(params["lines"])
    b.act, b.gs = act.data_ptr(), gs.data_ptr()
    b.partial, b.flat = partial.data_ptr(), flat.data_ptr()
    b.dlines, b.n_part = dlines.data_ptr(), n_part
    err = maps = None
    if train is None:
        cuda_lib.check_tensor(g, "g", (4, n), dev)
        b.g = g.data_ptr()
        name, fn = "ngp_fused_apply_cf_bwd", lib.nkt_fused_backward
    else:
        dists, tgt, S, white_bg, inv_denom = train
        R = n // S
        cuda_lib.check_tensor(dists, "dists", (1, n), dev)
        cuda_lib.check_tensor(tgt, "tgt_cf", (3, R), dev)
        err = torch.empty((1, R), **f32)
        maps = torch.empty((4, R), **f32)
        gbuf = torch.empty((4, n), **f32)
        b.dists, b.tgt = dists.data_ptr(), tgt.data_ptr()
        b.err, b.maps, b.gbuf = err.data_ptr(), maps.data_ptr(), gbuf.data_ptr()
        b.S, b.white_bg, b.inv_denom = S, int(white_bg), float(inv_denom)
        name, fn = "ngp_fused_train_cf", lib.nkt_fused_train
    # The kernels run after this returns. Their scratch tensors may be freed
    # then: the caching allocator hands a block out again only to work that
    # is queued behind them on the same stream.
    code = fn(ctypes.byref(b), n_sm, cuda_lib.current_stream(dev))
    cuda_lib.LAUNCHES[name] += 1
    cuda_lib.raise_on_error(code, name)
    d = {"lines": dlines, "dW": [], "db": [], "cW": [], "cb": []}
    off = 0
    for key, _, shape in _grad_layout(params):
        size = shape[0] * shape[1]
        d[key].append(flat[off : off + size].reshape(shape))
        off += size
    return d, err, maps


@torch.no_grad()
def ngp_fused_apply_cf_bwd(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                           g: torch.Tensor, cfg: CPGridConfig) -> dict:
    """The VJP of :func:`ngp_fused_apply_cf`: the (4, N) cotangent ``g`` ->
    the gradient of every leaf of ``params`` (same structure). A CUDA tensor
    goes through the kernels (in launches of at most ``BWD_CHUNK`` points,
    which bounds their scratch), a CPU tensor through the plain version."""
    if not xt.is_cuda:
        return ngp_fused_apply_cf_bwd_ref(params, xt, vdt, g, cfg)
    n = xt.shape[1]
    if n <= BWD_CHUNK:
        return _launch_grad(params, xt, vdt, cfg, g=g)[0] if n else \
            _zero_grads(params)
    parts = []
    for s in range(0, n, BWD_CHUNK):
        sl = slice(s, s + BWD_CHUNK)
        parts.append(_launch_grad(
            params, xt[:, sl].contiguous(), vdt[:, sl].contiguous(), cfg,
            g=g[:, sl].contiguous())[0])
    return _sum_grads(parts)


@torch.no_grad()
def ngp_fused_train_cf(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                       dists: torch.Tensor, tgt_cf: torch.Tensor,
                       cfg: CPGridConfig, S: int, white_bg: bool,
                       inv_denom: float):
    """Fused fine train pass: forward, per-ray compositing, squared error
    and the whole backward.

    Args:
      params: as :func:`ngp_fused_apply_cf` (gradients are returned whether
        or not the leaves require them).
      xt / vdt: (3, N) unit-cube points / unit view directions, N = R * S,
        **ray-major** (sample s of ray r at r * S + s). The reference orders
        its lanes block-sample-major for its own hardware; the contract is
        otherwise the same.
      dists: (1, N) compositing intervals (already scaled by the ray
        direction's norm, the 1e10 sentinel at s = S - 1), same order.
      tgt_cf: (3, R) target pixels.
      S: samples per ray; white_bg: composite onto white; inv_denom:
        dL/d(rgb_map) = 2 * inv_denom * (rgb_map - tgt), 1/(3 R) for a mean.

    Returns ``(err (1, R), maps (4, R) rgb map and acc, d_params)`` with
    ``d_params`` mirroring ``params``, the lines gradient in parameter
    layout. A CUDA tensor goes through the kernels; a CPU tensor through
    the plain version."""
    n = xt.shape[1]
    if S < 1 or n % S:
        raise ValueError(f"N={n} must be a multiple of S={S}")
    R = n // S
    if tuple(tgt_cf.shape) != (3, R):
        raise ValueError(f"tgt_cf {tuple(tgt_cf.shape)} != (3, {R})")
    if not xt.is_cuda:
        return ngp_fused_train_cf_ref(params, xt, vdt, dists, tgt_cf, cfg, S,
                                      white_bg, inv_denom)
    rays = max(BWD_CHUNK // S, 1)
    if R <= rays:
        d, err, maps = _launch_grad(
            params, xt, vdt, cfg, train=(dists, tgt_cf, S, white_bg, inv_denom))
        return err, maps, d
    parts, errs, mapss = [], [], []
    for r0 in range(0, R, rays):
        ps = slice(r0 * S, (r0 + rays) * S)
        d, err, maps = _launch_grad(
            params, xt[:, ps].contiguous(), vdt[:, ps].contiguous(), cfg,
            train=(dists[:, ps].contiguous(),
                   tgt_cf[:, r0 : r0 + rays].contiguous(), S, white_bg,
                   inv_denom))
        parts.append(d)
        errs.append(err)
        mapss.append(maps)
    return torch.cat(errs, dim=1), torch.cat(mapss, dim=1), _sum_grads(parts)
