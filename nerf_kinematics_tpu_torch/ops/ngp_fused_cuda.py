"""Fused NGP point pipeline: the CUDA kernels' wrappers and their plain
PyTorch versions, forward and gradients.

Replaces, from ``nerf_kinematics_tpu/ops/ngp_fused_pallas.py``:

  * ``ngp_fused_sigma_cf``          -> :func:`ngp_fused_sigma_cf`
  * ``ngp_fused_apply_cf`` forward  -> :func:`ngp_fused_apply_cf`
  * ``ngp_fused_apply_cf`` VJP      -> :func:`ngp_fused_apply_cf_bwd`, the
    backward of the ``autograd.Function`` behind :func:`ngp_fused_apply_cf`
  * ``ngp_fused_train_cf``          -> :func:`ngp_fused_train_cf`
  * ``ngp_fused_train_full_cf``     -> :func:`ngp_fused_train_full_cf`
  * ``ngp_fused_apply``             -> :func:`ngp_fused_apply`

Kernel sources: ``csrc/ngp_fused.cu`` (forward), ``csrc/ngp_fused_bwd.cu``
(gradients), ``csrc/ngp_fused_full.cu`` (the whole train step),
``csrc/ngp_fused.cuh`` (shared, and the f32 mode's body), ``csrc/nkt_mma.cuh``
(bf16 mode: the tensor-core body). In bf16 mode the wrappers hand the kernels
a bf16 copy of the line tables and the weights packed for the tensor cores
(:func:`mma_pack`); f32 mode takes neither and runs the FMA body. Channels-first IO: ``(3, N)``
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
import dataclasses

import torch

from ..utils import profiling
from . import cuda_lib
from .cp_grid import CPGridConfig, _round_bf16, cp_encode_stacked
from .cp_grid_cuda import cp_encode_cuda_bwd_ref, dlines_scratch
from .occupancy_cuda import occupancy_at_hull_cuda_ref
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
        enc = cp_encode_stacked(params["lines"], xt[:, s:e].T, cfg, contract="dup")
        feat = _mlp_ref(enc, params["dW"], params["db"], cfg.use_bf16)
        out = torch.zeros((4, e - s), dtype=torch.float32, device=xt.device)
        out[3] = _sigma_of(feat)
        return out

    return _chunked_cf(one, xt.shape[1], xt.device)


def ngp_fused_apply_cf_ref(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                           cfg: CPGridConfig) -> torch.Tensor:
    """Plain PyTorch version of :func:`ngp_fused_apply_cf`."""

    def one(s, e):
        enc = cp_encode_stacked(params["lines"], xt[:, s:e].T, cfg, contract="dup")
        feat = _mlp_ref(enc, params["dW"], params["db"], cfg.use_bf16)
        h = torch.cat([feat, sh_encode(vdt[:, s:e].T, 4)], dim=-1)
        rgb = _mlp_ref(h, params["cW"], params["cb"], cfg.use_bf16)
        return torch.cat([rgb.T, _sigma_of(feat)[None]], dim=0)

    return _chunked_cf(one, xt.shape[1], xt.device)


# ------------------------------------------- bf16 mode: the tensor-core operands

def _ceil(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class MmaPackLayout:
    """Where :func:`mma_pack` puts each layer (bf16 elements). Layers are the
    density layers then the color layers. A layer's block holds W^T (a row
    per output column, ``ceil(out, 8)`` rows, the inputs zero-padded to a
    multiple of 16); the forward products read it as B = W, the gradient's
    products by W^T read it transposed (``ldmatrix .trans``). Each row is
    ``ld`` elements with ``ld = 8 (mod 16)``: 4 (mod 8) 32-bit words, so the
    eight rows one fragment load touches fall in distinct shared-memory
    banks, and every row starts 16-byte aligned. ``dens``: where the color
    blocks start."""

    f_off: tuple
    f_ld: tuple
    dens: int
    total: int


def mma_layout(shapes, nd: int) -> MmaPackLayout:
    """The packing of layers of ``shapes`` ((in, out) each, ``nd`` density
    layers first)."""
    f_off, f_ld = [], []
    off, dens = 0, None
    for i, (k, j) in enumerate(shapes):
        if i == nd:
            dens = off
        ld = _ceil(k, 16) + 8
        f_off.append(off)
        f_ld.append(ld)
        off += _ceil(j, 8) * ld
    return MmaPackLayout(tuple(f_off), tuple(f_ld), off if dens is None else dens, off)


def _block(buf, off: int, rows: int, ld: int):
    return buf[off : off + rows * ld].view(rows, ld)


def mma_pack(Ws, nd: int):
    """Pack the layers' weights ``Ws`` ((in, out) each, f32, density then
    color) into one bf16 buffer laid out as :func:`mma_layout` says:
    rounded to nearest even, zero-padded. Returns ``(buffer, layout)``."""
    lay = mma_layout([tuple(w.shape) for w in Ws], nd)
    buf = torch.zeros(lay.total, dtype=torch.bfloat16, device=Ws[0].device)
    for i, w in enumerate(Ws):
        k, j = w.shape
        _block(buf, lay.f_off[i], _ceil(j, 8), lay.f_ld[i])[:j, :k].copy_(w.T)
    return buf, lay


def mma_dims_ok(shapes, nd: int, n_comp: int, color: bool) -> bool:
    """What the tensor-core kernels take (``csrc/nkt_mma.cuh::mma_dims_ok``):
    ``n_comp`` a multiple of 16; every width at most 64 and a multiple of 16
    where it feeds another product; with color, the density output plus the
    16 SH4 values at most 64 and a last layer of at most 8."""
    if n_comp % 16 or nd < 1:
        return False
    dens, col = shapes[:nd], shapes[nd:]
    for i, (_, j) in enumerate(dens):
        if j > cuda_lib.MAX_WIDTH or ((i < nd - 1 or color) and j % 16):
            return False
    if not color:
        return True
    dout = dens[-1][1]
    if not col or dout + 16 > cuda_lib.MAX_WIDTH or col[0][0] != dout + 16:
        return False
    for i, (_, j) in enumerate(col):
        last = i == len(col) - 1
        if j > cuda_lib.MAX_WIDTH or (not last and j % 16) or (last and j > 8):
            return False
    return True


def mma_operands(params: dict, cfg: CPGridConfig, color: bool):
    """What the kernels' bf16 mode reads besides the f32 parameters: the bf16
    copy of the line tables (exact: the kernels round every table entry to
    bf16 before use) and the packed weights. ``None`` in f32 mode, whose FMA
    body reads the f32 parameters alone. Raises where the widths are not
    what the tensor-core kernels take."""
    if not cfg.use_bf16:
        return None
    Ws = list(params["dW"]) + (list(params["cW"]) if color else [])
    nd = len(params["dW"])
    shapes = [tuple(w.shape) for w in Ws]
    if not mma_dims_ok(shapes, nd, cfg.n_components, color):
        raise ValueError(
            f"bf16 mode: the tensor-core kernels take n_components a multiple "
            f"of 16 and layer widths of at most {cuda_lib.MAX_WIDTH}, multiples "
            f"of 16 where they feed another layer; got n_components="
            f"{cfg.n_components}, layers {shapes}")
    wpk, lay = mma_pack([w.detach() for w in Ws], nd)
    return params["lines"].detach().to(torch.bfloat16), wpk, lay


# Row 3's bf16 kernel (csrc/ngp_apply.cu): warps a block at most, and the
# per-warp sizes of its re-sum list and of one tap pair (NktTapS); 16
# points a warp. The wrapper gives each streaming multiprocessor
# APPLY_SLOTS_PER_SM slots of encodings (a warp's 16 points each; the
# kernel takes a grid of at most enc_slots / warps blocks).
APPLY_WARPS, APPLY_SLOTS_PER_SM = 16, 32
_LIST_BYTES, _TAP_BYTES, _TILE = 128, 12, 16


@dataclasses.dataclass(frozen=True)
class ApplyLayout:
    """Shared memory of row 3's bf16 kernel (``csrc/ngp_apply.cu::
    make_apply_layout``; ``chip_smoke.py`` holds the two to each other): the
    packed weights and the f32 biases, then a region a warp of 16 points:
    ``E`` (one level of the bf16 encoding, ``lde`` 32-bit words a row; the
    whole encoding goes to the warp's slot of device memory), ``H`` (a
    hidden buffer, ``ldh`` words a row; the taps of every level overlay it,
    ``h_bytes`` the larger of the two) and the re-sum list."""

    warps: int
    lde: int
    ldh: int
    h_bytes: int
    tile_bytes: int
    total: int

    def as_tuple(self):
        """What ``nkt_apply_layout`` writes, in its order."""
        return (self.warps, self.lde, self.ldh, self.h_bytes, self.tile_bytes,
                self.total)


def apply_layout(shapes, nd: int, n_levels: int, n_comp: int) -> ApplyLayout:
    """Row 3's layout for layers of ``shapes`` ((in, out) each, ``nd``
    density layers first) on an encoding of ``n_levels`` x ``n_comp``.
    ``total`` above ``cuda_lib.SMEM_LIMIT``: the widths do not fit."""
    tile_off = mma_layout(shapes, nd).total * 2 + len(shapes) * cuda_lib.MAX_WIDTH * 4
    w = _ceil(max([16] + [j for _, j in shapes] + [shapes[nd - 1][1] + 16]), 16)
    lde, ldh = _ceil(max(n_comp, w), 16) // 2 + 4, w // 2 + 4
    h_bytes = _ceil(max(_TILE * ldh * 4, n_levels * 3 * _TILE * _TAP_BYTES), 16)
    tile_bytes = _TILE * lde * 4 + h_bytes + _LIST_BYTES
    warps = min(max((cuda_lib.SMEM_LIMIT - tile_off) // tile_bytes, 1), APPLY_WARPS)
    return ApplyLayout(warps, lde, ldh, h_bytes, tile_bytes, tile_off + warps * tile_bytes)


def apply_layout_of(params: dict, cfg: CPGridConfig) -> ApplyLayout:
    """:func:`apply_layout` of a parameter dict and its encoder."""
    shapes = [tuple(w.shape) for w in list(params["dW"]) + list(params["cW"])]
    return apply_layout(shapes, len(params["dW"]), cfg.n_levels, cfg.n_components)


def _fused_args(params: dict, xt, vdt, out, cfg: CPGridConfig, color: bool):
    """Check everything the kernel assumes and fill its argument struct.
    Returns ``(args, keep)``: every pointer in ``args`` belongs to a tensor
    the caller holds or to ``keep`` (the launch's non-finite scratch, bf16
    mode's operands), which the caller holds until the launch is queued."""
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
    sc = profiling.begin("launch.scratch")
    scratch = cuda_lib.nonfinite_scratch(args.cp, dev)
    profiling.end(sc)
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
    sp = profiling.begin("launch.operands")
    ops = mma_operands(params, cfg, color)
    profiling.end(sp)
    keep = (scratch,)
    if ops is not None:
        lines16, wpk, lay = ops
        keep = (scratch, *ops)
        args.lines16, args.wpk = lines16.data_ptr(), wpk.data_ptr()
        for i in range(len(lay.f_off)):
            args.pk_off[i], args.pk_ld[i] = lay.f_off[i], lay.f_ld[i]
        args.pk_dens, args.pk_fwd = lay.dens, lay.total
        if color:
            # row 3's slots: one a warp the card holds at once, 16 points'
            # encodings, read back by layer 0's re-sums
            slots = APPLY_SLOTS_PER_SM * cuda_lib.sm_count(dev)
            sc = profiling.begin("launch.scratch")
            enc = torch.empty(slots * 16 * cfg.out_dim, dtype=torch.bfloat16, device=dev)
            profiling.end(sc)
            args.enc, args.enc_slots = enc.data_ptr(), slots
            keep = (*keep, enc)
    return args, keep


def _launch(params, xt, vdt, cfg: CPGridConfig, color: bool, name: str):
    n = xt.shape[1]
    if n == 0:
        return torch.empty((4, 0), dtype=torch.float32, device=xt.device)
    span = profiling.begin(cuda_lib.LAUNCH_SPAN[name])
    sp = profiling.begin("launch.scratch")
    out = torch.empty((4, n), dtype=torch.float32, device=xt.device)
    profiling.end(sp)
    args, keep = _fused_args(params, xt, vdt, out, cfg, color)
    lib = cuda_lib.load_library()
    sp = profiling.begin("launch.plan")
    need = lib.nkt_fused_smem_bytes(ctypes.byref(args), int(color))
    profiling.end(sp)
    if need > cuda_lib.SMEM_LIMIT:
        raise ValueError(
            f"{name}: the layers need {need} B of shared memory, above the "
            f"{cuda_lib.SMEM_LIMIT} B one block may use"
        )
    sp = profiling.begin("launch.call")
    code = lib.nkt_fused_forward(
        ctypes.byref(args), int(color), cuda_lib.sm_count(xt.device),
        cuda_lib.current_stream(xt.device),
    )
    profiling.end(sp)
    cuda_lib.launched(span, name, "bf16" if cfg.use_bf16 else "f32", n)
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
            # the reference's g * (z > 0) is a select after XLA's
            # simplification: a masked NaN or inf cotangent gives 0
            g = torch.where(z > 0.0, g, torch.zeros_like(g))
        w = weights[i].to(torch.float32)
        gw = g
        if use_bf16:
            gw, w = _round_bf16(g), _round_bf16(w)
        dWs[i] = inp.T @ gw
        dbs[i] = g.sum(dim=0)[:, None]
        g = gw @ w.T
    return g, dWs, dbs


def _forward_saved(params, xt, vdt, cfg: CPGridConfig):
    enc = cp_encode_stacked(params["lines"], xt.T, cfg, contract="dup")
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
    dlines = cp_encode_cuda_bwd_ref(params["lines"], xt.T, d_enc, cfg, contract="dup")
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


# ------------------------------- the whole train step: the plain version

def _cdf_rows_ref(w: torch.Tensor) -> torch.Tensor:
    """(R, M) unnormalised weights -> (R, M + 1) CDF as the reference's
    ``_cdf_rows``: +1e-5, the total summed bin by bin, then each bin's
    ``w / tot`` added to the running value. Not a cumulative sum over a
    normalised pdf: the last bits differ, and the inverse CDF amplifies them."""
    w = w + 1e-5
    tot = w[:, 0]
    for k in range(1, w.shape[1]):
        tot = tot + w[:, k]
    cols = [torch.zeros_like(tot)]
    for k in range(w.shape[1]):
        cols.append(cols[-1] + w[:, k] / tot)
    return torch.stack(cols, dim=1)


def _inv_cdf_rows_ref(cdf: torch.Tensor, edges: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """The reference's ``_inv_cdf_rows``: ``cdf`` (R, M1), ``edges`` (R, M1)
    or (M1,), ``u`` (R, n) -> (R, n) depths. The bin is ``#(cdf <= u)``
    clipped to [1, M1 - 1]; a bin mass under 1e-5 divides by 1."""
    M1 = cdf.shape[1]
    edges = edges.expand(cdf.shape)
    cnt = (cdf[:, None, :] <= u[:, :, None]).sum(dim=-1)
    hi = torch.clamp(cnt, 1, M1 - 1)
    lo = hi - 1
    c_lo, c_hi = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    e_lo, e_hi = torch.gather(edges, 1, lo), torch.gather(edges, 1, hi)
    den = c_hi - c_lo
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    return e_lo + ((u - c_lo) / den) * (e_hi - e_lo)


def _interval_rows(z: torch.Tensor, d_norm: torch.Tensor) -> torch.Tensor:
    """(R, S) sorted depths -> (R, S) compositing intervals times the ray
    direction's norm, the 1e10 sentinel last."""
    last = torch.full_like(z[:, :1], 1e10)
    return torch.cat([z[:, 1:] - z[:, :-1], last], dim=1) * d_norm[:, None]


@torch.no_grad()
def ngp_fused_train_full_cf_ref(params: dict, o_cf, d_cf, vd_cf, tgt_cf,
                                u_coarse, u_fine, proj2, cfg: CPGridConfig,
                                S: int, Sc: int, num_bins: int, white_bg: bool,
                                inv_denom: float, near: float, far: float,
                                bound: float, occ_floor: float):
    """Plain PyTorch version of :func:`ngp_fused_train_full_cf`, written
    from the reference's ``_train_full_kernel`` stage by stage (not from
    ``occupancy_sample`` / ``sample_pdf``, whose last bits differ)."""
    R = o_cf.shape[1]
    # Constants are computed in double and rounded once to f32, as the
    # reference's kernel takes them (Python floats).
    step = (far - near) / num_bins
    ib2 = 1.0 / (2.0 * bound)
    dev = o_cf.device
    f32 = dict(dtype=torch.float32, device=dev)

    def to_unit(pts):
        return torch.clamp(pts * ib2 + 0.5, 0.0, 1.0)

    # ---- stage A: hull-proposal weights on the uniform bins --------------
    centres = torch.tensor([near + (b + 0.5) * step for b in range(num_bins)], **f32)
    pb = o_cf[:, None, :] + centres[None, :, None] * d_cf[:, None, :]  # (3, NB, R)
    # row 1's lookup: a pair that reads a NaN coordinate is 0, as the
    # reference's one-hot row of a NaN matches no cell
    occ = occupancy_at_hull_cuda_ref(proj2, to_unit(pb).reshape(3, -1))
    occ = occ.reshape(num_bins, R).T
    occ_max = occ.amax(dim=1, keepdim=True)
    w = occ / (occ_max + 1e-9) + occ_floor  # (R, NB)

    # ---- stage B: inverse CDF -> coarse depths ----------------------------
    edges = torch.tensor([near + b * step for b in range(num_bins + 1)], **f32)
    z_c = _inv_cdf_rows_ref(_cdf_rows_ref(w), edges, u_coarse.T)  # (R, Sc)

    # ---- stage C: density-only coarse pass and its compositing weights ----
    o3, d3 = o_cf[:, :, None], d_cf[:, :, None]
    xt_c = to_unit(o3 + z_c[None] * d3).reshape(3, R * Sc)
    sigma = ngp_fused_sigma_cf_ref(params, xt_c, cfg)[3].reshape(R, Sc)
    d_norm = torch.sqrt((d_cf[0] * d_cf[0] + d_cf[1] * d_cf[1]) + d_cf[2] * d_cf[2])
    dists_c = _interval_rows(z_c, d_norm)
    trans = torch.ones(R, **f32)
    acc = torch.zeros(R, **f32)
    cw = []
    for s in range(Sc):
        a = 1.0 - torch.exp(-sigma[:, s] * dists_c[:, s])
        w_s = a * trans
        acc = acc + w_s
        cw.append(w_s)
        trans = trans * (1.0 - a + 1e-10)
    # The density-only pass has zero rgb logits: a grey composite.
    v = 0.5 * acc + ((1.0 - acc) if white_bg else 0.0)
    dv = v[None] - tgt_cf
    err_c = ((dv[0] * dv[0] + dv[1] * dv[1]) + dv[2] * dv[2])[None]

    # ---- stage D: inverse CDF -> fine depths ------------------------------
    # bins: the coarse midpoints; weights: the interior coarse weights
    mids = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
    z_f = _inv_cdf_rows_ref(_cdf_rows_ref(torch.stack(cw[1:-1], dim=1)), mids,
                            u_fine.T)  # (R, S)

    # ---- stage E: the fine stage of ngp_fused_train_cf (ray-major) --------
    xt_f = to_unit(o3 + z_f[None] * d3).reshape(3, R * S)
    dists = _interval_rows(z_f, d_norm).reshape(1, R * S)
    vdt = vd_cf[:, :, None].expand(3, R, S).reshape(3, R * S)
    err, maps, d_params = ngp_fused_train_cf_ref(
        params, xt_f, vdt, dists, tgt_cf, cfg, S, white_bg, inv_denom)
    return err, maps, err_c, d_params


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


@dataclasses.dataclass(frozen=True)
class GradScratch:
    """Device scratch of one call of the gradient kernels over ``n`` points
    (``csrc/ngp_fused_bwd.cu::nkt_fused_bwd_sizes`` says the same). f32 mode:
    ``act`` (act_rows, ld) saved layer inputs, ``z0`` (ld,), ``gs``
    (gs_rows, ld) masked cotangents, all f32, ``ld`` = n. bf16 mode keeps
    every layer's input and cotangent on chip (the tile kernel): no act, gs
    or z0 (0 rows, ld 0). Both: the flat MLP gradient of ``total`` floats."""

    act_rows: int
    gs_rows: int
    total: int
    ld: int
    act_dtype: torch.dtype


def grad_scratch(params: dict, cfg: CPGridConfig, n: int) -> GradScratch:
    shapes = [tuple(w.shape) for w in (*params["dW"], *params["cW"])]
    total = sum(k * j + j for k, j in shapes)
    if cfg.use_bf16:
        return GradScratch(0, 0, total, 0, torch.bfloat16)
    act_rows = sum(k for k, _ in shapes)
    gs_rows = sum(j for _, j in shapes)
    return GradScratch(act_rows, gs_rows, total, n, torch.float32)


# ------------------------------------ bf16 mode: the tile kernel's block plan

BWD_WARPS = 8          # NKB_WARPS of csrc/ngp_fused_bwd.cu: one block an SM
BWD_MAX_POINTS = 128   # NKB_MAX_MT m-tiles of 16 points
BWD_WIDE_POINTS = 64   # NKB_WIDE_MT: the same where layer 0's dW takes > 16 m-tiles
BWD_GLD = 72           # NKB_GLD: bf16 elements a row of the cotangent tile
BWD_F32 = 10           # NKB_F32: f32 values a point (outputs, cotangents, z0, T)


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The block plan of bf16 mode's gradient kernel
    (``csrc/ngp_fused_bwd.cu::make_plan``; the wrapper compares it with the
    library's ``nkt_fused_bwd_plan`` at every call). A block holds the
    forward blocks of the packed weights, the f32 biases and the f32 sums of
    every layer's dW but layer 0's (fragments of 16 x 8) and of every db,
    then a tile of ``points`` points: each layer's bf16 input but layer 0's
    (rows ``x_ld`` elements, layer 1's last; two level tiles of the encoder
    overlay the others), the bf16 cotangent (``BWD_GLD`` a row; the
    forward's taps overlay it) and ``BWD_F32`` f32 values a point. The train
    objective's tile holds ``rays`` whole rays of S samples; a ray longer
    than a tile (``long_rays``) takes the VJP's tiles of P points, after the
    tile kernel's forward alone and the rays' kernel
    (``csrc/ngp_fused_bwd.cu::run_backward_tile``)."""

    points: int          # P, a multiple of 16
    rays: int            # train: whole rays a tile; the VJP and long rays: 0
    tile_points: int     # points of a full tile
    smem: int            # bytes of shared memory
    weight_bytes: int    # the forward blocks and the biases
    acc_bytes: int       # the f32 sums
    point_bytes: int     # the tile's bytes a point
    input_bytes: int     # of them the layers' inputs (and the level tiles)
    acc0_regs: int       # registers a thread of layer 0's dW (its mt0 x 4)
    x_ld: tuple          # per layer (0 for layer 0): elements a row of its input
    level_ld: int        # elements a row of a level tile
    long_rays: bool      # train: a ray of S samples is longer than a tile

    def as_tuple(self):
        """What ``nkt_fused_bwd_plan`` writes, in its order."""
        return (self.points, self.rays, self.tile_points, self.smem,
                self.weight_bytes, self.acc_bytes, self.point_bytes,
                self.input_bytes, self.acc0_regs)


def bwd_plan(shapes, nd: int, n_comp: int, n_levels: int, S: int = 0) -> BwdPlan:
    """The plan for layers ``shapes`` ((in, out) each, ``nd`` density layers
    first), the encoder's ``n_levels`` x ``n_comp`` and ``S`` samples a ray
    (0: the VJP). Raises ValueError where the layers do not fit one block;
    a ray longer than a tile takes the long-ray path (``long_rays``)."""
    plan = _plan_or_why(shapes, nd, n_comp, n_levels, S)
    if isinstance(plan, str):
        raise ValueError(f"bf16 gradient kernel: {plan}")
    return plan


def _plan_or_why(shapes, nd: int, n_comp: int, n_levels: int, S: int):
    """``bwd_plan``'s plan, or why there is none."""
    nl = len(shapes)
    K0 = n_levels * n_comp
    if (nd < 1 or nl - nd < 1 or shapes[0][0] != K0 or shapes[0][1] % 8
            or shapes[-1][1] != 3 or any(k % 16 for k, _ in shapes[1:])
            or not mma_dims_ok(shapes, nd, n_comp, True)):
        return f"layers {shapes} not taken"
    mt0 = -(-K0 // 16)  # m-tiles of layer 0's dW a warp holds in registers
    if mt0 > 32:
        return f"an encoding of {K0} is above 512"
    weight = 2 * mma_layout(shapes, nd).total + nl * cuda_lib.MAX_WIDTH * 4
    acc = sum(k // 16 * _ceil(j, 8) // 8 * 128 for k, j in shapes[1:])
    acc = 4 * (acc + nl * cuda_lib.MAX_WIDTH)
    x_ld = (0,) + tuple(k + 8 for k, _ in shapes[1:])
    level_ld = n_comp + 8
    x = max(sum(2 * ld for ld in x_ld[2:]), 4 * level_ld) + 2 * x_ld[1]
    point = x + 2 * BWD_GLD + 4 * BWD_F32
    most = BWD_WIDE_POINTS if mt0 > 16 else BWD_MAX_POINTS
    P = min(most, (cuda_lib.SMEM_LIMIT - weight - acc) // point // 16 * 16)
    if P < 16:
        return (f"the layers {shapes} leave no room for 16 points in "
                f"{cuda_lib.SMEM_LIMIT} B of shared memory")
    rays = P // S if S > 0 else 0
    tile = rays * S if rays else P
    return BwdPlan(P, rays, tile, weight + acc + P * point, weight, acc, point, x,
                   4 * mt0, x_ld, level_ld, S > P)


def bwd_plan_of(params: dict, cfg: CPGridConfig, S: int = 0) -> BwdPlan:
    shapes = [tuple(w.shape) for w in (*params["dW"], *params["cW"])]
    return bwd_plan(shapes, len(params["dW"]), cfg.n_components, cfg.n_levels, S)


def grad_bytes(params: dict, cfg: CPGridConfig, n: int, S: int = 0,
               n_sm: int = 132) -> dict:
    """Bytes a call of the gradient kernels moves through device memory in
    bf16 mode, by the tile kernel's own count, by part: its inputs (points,
    directions, and the VJP's cotangent or the train objective's intervals
    and targets), its outputs (err and maps), the weights and biases each
    block stages, the encoding's slots (written and read back once a tile:
    L2-resident, bounded by the grid), denc (written once in f32, read once
    by row 5's kernel), the partial rows (written, then read by the sum) and
    the flat gradient. Row 5's own reads of the line tables and its chunk
    sums are in row 5's count, not here. A ray longer than a tile runs the
    tile kernel twice (points, directions, weights and slots twice) and
    moves the (4, n) rgb logits and sigma and the rays' (4, n) cotangent
    through device memory, each written once and read once
    (``ray_kernel``)."""
    plan = bwd_plan_of(params, cfg, S)
    LC = cfg.out_dim
    tiles = -(-n // plan.tile_points)
    grid = min(tiles, n_sm)
    total = grad_scratch(params, cfg, n).total
    rays = n // S if S else 0
    twice = 2 if plan.long_rays else 1
    return {
        "inputs": twice * n * 24 + (n * 4 + rays * 12 if S else n * 16),
        "line_tables": cfg.n_levels * 3 * cfg.table_size * cfg.n_components * 2,
        "outputs": rays * 16 + rays * 4,
        "weights": twice * grid * plan.weight_bytes,
        "encoding_slots": twice * 2 * n * LC * 2,
        "denc": 2 * n * LC * 4,
        "partials": 2 * grid * total * 4 + total * 4,
        "ray_kernel": 2 * 2 * n * 16 if plan.long_rays else 0,
    }


def _launch_grad(params, xt, vdt, cfg: CPGridConfig, g=None, train=None,
                 full=None, span: int = -1):
    """One launch sequence of the gradient kernels over all of ``xt``.
    ``g``: (4, n) cotangent (the VJP); ``train``: (dists, tgt, S, white_bg,
    inv_denom) for the fused train objective; ``full``: a filled
    ``cuda_lib.FullArgs`` whose call first writes ``xt``, ``vdt`` and
    ``dists`` (the whole train step), with ``span`` the span its wrapper
    opened. Returns (d_params, err, maps)."""
    if full is None:
        span = profiling.begin(cuda_lib.LAUNCH_SPAN[
            "ngp_fused_apply_cf_bwd" if train is None else "ngp_fused_train_cf"])
    dev = xt.device
    n = xt.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    sp = profiling.begin("launch.scratch")
    out4 = torch.empty((4, n), **f32)
    profiling.end(sp)
    S = train[2] if train is not None else 0
    if cfg.use_bf16:  # raises where the layers do not fit a block
        sp = profiling.begin("launch.plan")
        plan = bwd_plan_of(params, cfg, S)
        profiling.end(sp)
    b = cuda_lib.BwdArgs()
    b.f, keep = _fused_args(params, xt, vdt, out4, cfg, True)
    if cfg.use_bf16:
        # the tile kernel's slots: a block's tile of encodings (P / 16 slots
        # of 16 points) for each block of a grid of at most one block an SM
        slots = cuda_lib.sm_count(dev) * (plan.points // 16)
        sp = profiling.begin("launch.scratch")
        enc = torch.empty(slots * 16 * cfg.out_dim, dtype=torch.bfloat16, device=dev)
        profiling.end(sp)
        b.f.enc, b.f.enc_slots = enc.data_ptr(), slots
        keep = (*keep, enc)
    lib = cuda_lib.load_library()
    sp = profiling.begin("launch.plan")
    sizes = (ctypes.c_longlong * 6)()
    lib.nkt_fused_bwd_sizes(ctypes.byref(b.f), sizes)
    act_rows, gs_rows, total, smem, ld, act_bytes = (int(v) for v in sizes)
    scratch = grad_scratch(params, cfg, n)
    if (act_rows, gs_rows, total, ld, act_bytes) != (
            scratch.act_rows, scratch.gs_rows, scratch.total, scratch.ld,
            scratch.act_dtype.itemsize):
        raise RuntimeError(
            f"scratch layout: the library says {tuple(sizes)}, the host {scratch}")
    if cfg.use_bf16:
        got = (ctypes.c_longlong * 9)()
        if lib.nkt_fused_bwd_plan(ctypes.byref(b.f), S, got) or \
                tuple(int(v) for v in got) != plan.as_tuple():
            raise RuntimeError(
                f"block plan: the library says {tuple(got)}, the host {plan.as_tuple()}")
    profiling.end(sp)
    if smem > cuda_lib.SMEM_LIMIT:
        raise ValueError(
            f"the layers need {smem} B of shared memory, above the "
            f"{cuda_lib.SMEM_LIMIT} B one block may use")
    n_sm = cuda_lib.sm_count(dev)
    n_part = 2 * n_sm
    sp = profiling.begin("launch.scratch")
    act = torch.empty((act_rows, ld), dtype=scratch.act_dtype, device=dev)
    z0 = torch.empty((ld,), **f32)
    gs = torch.empty((gs_rows, ld), **f32)
    partial = torch.empty((n_part, total), **f32)
    flat = torch.empty((total,), **f32)
    # the line tables' gradient: the encoding's cotangent, then row 5's
    # kernel over it in a fixed order (csrc/cp_encode.cu)
    dlines = torch.empty_like(params["lines"])
    denc = torch.empty((n, cfg.out_dim), **f32)
    lpart, l_chunks = dlines_scratch(n, cfg, dev)
    profiling.end(sp)
    b.act, b.z0, b.gs, b.ld = act.data_ptr(), z0.data_ptr(), gs.data_ptr(), ld
    b.partial, b.flat = partial.data_ptr(), flat.data_ptr()
    b.dlines, b.n_part = dlines.data_ptr(), n_part
    b.denc, b.lpart, b.l_chunks = denc.data_ptr(), lpart.data_ptr(), l_chunks
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
        sp = profiling.begin("launch.scratch")
        err = torch.empty((1, R), **f32)
        maps = torch.empty((4, R), **f32)
        # the rays' kernel's cotangent: f32 mode's, and bf16 mode's long rays
        gbuf = torch.empty((0 if cfg.use_bf16 and not plan.long_rays else 4, n), **f32)
        profiling.end(sp)
        b.dists, b.tgt = dists.data_ptr(), tgt.data_ptr()
        b.err, b.maps, b.gbuf = err.data_ptr(), maps.data_ptr(), gbuf.data_ptr()
        b.S, b.white_bg, b.inv_denom = S, int(white_bg), float(inv_denom)
        name, fn = "ngp_fused_train_cf", lib.nkt_fused_train
    # The kernels run after this returns. Their scratch tensors may be freed
    # then: the caching allocator hands a block out again only to work that
    # is queued behind them on the same stream.
    sp = profiling.begin("launch.call")
    if full is not None:
        full.b = b
        name = "ngp_fused_train_full_cf"
        code = lib.nkt_fused_train_full(ctypes.byref(full), n_sm,
                                        cuda_lib.current_stream(dev))
    else:
        code = fn(ctypes.byref(b), n_sm, cuda_lib.current_stream(dev))
    profiling.end(sp)
    cuda_lib.launched(span, name, "bf16" if cfg.use_bf16 else "f32",
                      n + (full.R * full.Sc if full is not None else 0), in_fused=n)
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


def _launch_full(params, o_cf, d_cf, vd_cf, tgt_cf, u_coarse, u_fine, proj2,
                 cfg: CPGridConfig, S, Sc, num_bins, white_bg, inv_denom, near,
                 far, bound, occ_floor):
    """One call of ``nkt_fused_train_full`` over all the rays given."""
    span = profiling.begin("launch.ngp_fused_train_full_cf")
    dev = o_cf.device
    R = o_cf.shape[1]
    for t, name, shape in ((o_cf, "o_cf", (3, R)), (d_cf, "d_cf", (3, R)),
                           (vd_cf, "vd_cf", (3, R)), (u_coarse, "u_coarse", (Sc, R)),
                           (u_fine, "u_fine", (S, R))):
        cuda_lib.check_tensor(t, name, shape, dev)
    Rg = proj2.shape[-1]
    cuda_lib.check_tensor(proj2, "proj2", (3, Rg, Rg), dev)
    if num_bins > cuda_lib.MAX_BINS or max(S, Sc) > cuda_lib.MAX_SAMPLES:
        raise ValueError(
            f"the whole-step kernel takes at most {cuda_lib.MAX_BINS} bins and "
            f"{cuda_lib.MAX_SAMPLES} samples per pass")
    f32 = dict(dtype=torch.float32, device=dev)
    n = R * S
    # the fine stage's operands, written by the call itself
    sp = profiling.begin("launch.scratch")
    xt, vdt, dists = (torch.empty((3, n), **f32), torch.empty((3, n), **f32),
                      torch.empty((1, n), **f32))
    z_c = torch.empty((R, Sc), **f32)
    xt_c = torch.empty((3, R * Sc), **f32)
    sigma_c = torch.empty((4, R * Sc), **f32)
    err_c = torch.empty((1, R), **f32)
    profiling.end(sp)
    a = cuda_lib.FullArgs()
    a.o, a.d, a.vd = o_cf.data_ptr(), d_cf.data_ptr(), vd_cf.data_ptr()
    a.uc, a.uf, a.proj2 = u_coarse.data_ptr(), u_fine.data_ptr(), proj2.data_ptr()
    a.zc, a.xtc, a.sigc, a.errc = (z_c.data_ptr(), xt_c.data_ptr(),
                                   sigma_c.data_ptr(), err_c.data_ptr())
    a.R, a.Sc, a.NB, a.Rg = R, Sc, num_bins, Rg
    a.near, a.step = float(near), (float(far) - float(near)) / num_bins
    a.inv_bound2, a.occ_floor = 1.0 / (2.0 * float(bound)), float(occ_floor)
    d, err, maps = _launch_grad(params, xt, vdt, cfg,
                                train=(dists, tgt_cf, S, white_bg, inv_denom),
                                full=a, span=span)
    return err, maps, err_c, d


@torch.no_grad()
def ngp_fused_train_full_cf(params: dict, o_cf: torch.Tensor, d_cf: torch.Tensor,
                            vd_cf: torch.Tensor, tgt_cf: torch.Tensor,
                            u_coarse: torch.Tensor, u_fine: torch.Tensor,
                            proj2: torch.Tensor, cfg: CPGridConfig, S: int,
                            Sc: int, num_bins: int, white_bg: bool,
                            inv_denom: float, near: float, far: float,
                            bound: float, occ_floor: float):
    """The whole train step of the fast engine in one call: the hull
    proposal on ``num_bins`` uniform bins, inverse-CDF coarse depths, the
    density-only coarse pass, the coarse compositing weights and error,
    inverse-CDF fine depths, then the fine stage of
    :func:`ngp_fused_train_cf` (forward, compositing, squared error, the
    whole backward).

    Args:
      params: as :func:`ngp_fused_apply_cf`.
      o_cf / d_cf / vd_cf / tgt_cf: (3, R) ray origins, directions, unit view
        directions and target pixels.
      u_coarse / u_fine: (Sc, R) / (S, R) sorted inverse-CDF positions per
        ray (``sample_pdf``'s stratified or evenly spaced positions).
      proj2: (3, Rg, Rg) occupancy pair-projections
        (``ops/occupancy.py::pair_projections``).
      near / far / bound: the scene's static depth range and box
        ([-bound, bound]^3, linear map to the unit cube); occ_floor: the
        proposal's floor; inv_denom as :func:`ngp_fused_train_cf`.

    Returns ``(err (1, R), maps (4, R), err_c (1, R), d_params)``: ``err_c``
    is the squared error of the coarse pass's grey composite. A CUDA tensor
    goes through the kernels (csrc/ngp_fused_full.cu); a CPU tensor through
    the plain version."""
    R = o_cf.shape[1]
    if Sc < 3:
        raise ValueError(f"Sc={Sc}: the fine pass needs at least 3 coarse samples")
    for t, name, shape in ((tgt_cf, "tgt_cf", (3, R)), (u_coarse, "u_coarse", (Sc, R)),
                           (u_fine, "u_fine", (S, R))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
    args = (cfg, S, Sc, num_bins, white_bg, inv_denom, near, far, bound, occ_floor)
    if not o_cf.is_cuda:
        return ngp_fused_train_full_cf_ref(params, o_cf, d_cf, vd_cf, tgt_cf,
                                           u_coarse, u_fine, proj2, *args)
    rays = max(BWD_CHUNK // max(S, Sc), 1)
    if R <= rays:
        return _launch_full(params, o_cf, d_cf, vd_cf, tgt_cf, u_coarse, u_fine,
                            proj2, *args)
    outs = []
    for r0 in range(0, R, rays):
        sl = slice(r0, r0 + rays)
        outs.append(_launch_full(
            params, *(t[:, sl].contiguous() for t in (
                o_cf, d_cf, vd_cf, tgt_cf, u_coarse, u_fine)), proj2, *args))
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=1),
            torch.cat([o[2] for o in outs], dim=1),
            _sum_grads([o[3] for o in outs]))
