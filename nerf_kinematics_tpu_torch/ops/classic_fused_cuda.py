"""Fused classic-NeRF point pipeline: the CUDA kernels' wrappers and their
plain PyTorch versions, forward and gradient.

Replaces, from ``nerf_kinematics_tpu/ops/classic_fused_pallas.py``:

  * ``classic_fused_apply_cf`` forward -> :func:`classic_fused_apply_cf`
  * ``classic_fused_apply_cf`` VJP     -> :func:`classic_fused_apply_cf_bwd`,
    the backward of the ``autograd.Function`` behind
    :func:`classic_fused_apply_cf`

Kernel source: ``csrc/classic_fused.cu``. In f32 mode (the shipped
configs) the products run in 3xTF32 on the tensor cores (each f32 operand
split into two TF32 halves, three ``mma.sync`` products, near-f32 results):
the forward of a call without gradient (rendering, evaluation), and the
gradient's cotangent and weight products (all layers' in one launch). The
forward whose gradient is taken, and the gradient's own forward again, keep
the FMA body, whose sums run in the plain version's order, so that the ReLU
masks are the plain version's. bf16 mode keeps the FMA kernels, its weight
gradients through the launcher of ``csrc/ngp_fused_bwd.cu``. Channels-first
IO: ``(3, N)``
points and ``(3, N)`` unit view directions -> ``(4, N)``, rows 0-2 rgb
logits and row 3 the **raw** sigma (no activation: the compositing adds the
density noise before its ReLU). ``params`` is the reference's structure,
``{"W": [(in, out)] * (trunk + 4), "b": [(out, 1)] * (trunk + 4)}`` in the
order layer1, layers_xyz.*, fc_alpha, fc_feat, layers_dir.0, fc_rgb.

Cast points (``compute_dtype: bfloat16``), the kernel's and not the module's:
a layer with 16 or more outputs rounds its weights and its input to bf16 and
sums in f32; the sigma and rgb heads stay f32, forward and backward; biases
are f32; ``db`` sums the unrounded cotangent.

Gradient contract (the reference's): exact gradients for every weight and
bias, none for points and directions, on both devices.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import profiling
from . import cuda_lib
from .positional_encoding import encoding_rows, frequencies

REF_CHUNK = 1 << 18  # points per chunk of the plain versions
BWD_CHUNK = 1 << 18  # points per launch of the gradient kernels (scratch size)
MAX_WIDTH = 128      # widest layer output the kernels take
TILE = 64            # points per tile (NKC_P)
FRAG = 256           # floats of one packed 16 x 8 TF32 A tile, hi and lo
TC_LDP = 72          # NKC_LDP: words per buffer row of the tensor-core tile


def fused_supported(cfg) -> bool:
    """True when the fused kernel implements this config exactly: view
    directions on, and no trunk layer whose skip concat fires."""
    skip_fires = any(
        i % cfg.skip_connect_every == 0 and i > 0
        for i in range(cfg.trunk_depth - 1)
    )
    return cfg.use_viewdirs and not skip_fires


def _bf16(cfg) -> bool:
    return cfg.compute_dtype == "bfloat16"


def _rounds(cfg, out: int) -> bool:
    """Layers with 16 or more outputs take bf16 operands in bf16 mode."""
    return _bf16(cfg) and out >= 16


def _r(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _dot_in(W, h, rnd):
    """(in, out) x (in, B) -> (out, B)."""
    W = W.to(torch.float32)
    if rnd:
        W, h = _r(W), _r(h)
    return W.T @ h


def _dot_out(W, g, rnd):
    """(in, out) x (out, B) -> (in, B), the backward product."""
    W = W.to(torch.float32)
    if rnd:
        W, g = _r(W), _r(g)
    return W @ g


def _dot_acc(inp, g, rnd):
    """(in, B) x (out, B) -> (in, out), summed over the points."""
    if rnd:
        inp, g = _r(inp), _r(g)
    return inp @ g.T


def _col(b):
    return b.reshape(-1, 1).to(torch.float32)


def _forward_cf(params, xt, vdt, cfg, save: bool = False):
    Ws, bs = params["W"], params["b"]
    t = cfg.trunk_depth
    h = encoding_rows(xt, cfg.num_encoding_fn_xyz, cfg.include_input_xyz,
                      cfg.log_sampling_xyz)
    pre = []
    for i in range(t):
        z = _dot_in(Ws[i], h, _rounds(cfg, Ws[i].shape[1])) + _col(bs[i])
        pre.append((h, z))
        h = torch.relu(z)
    Wa, Wf, Wd, Wr = Ws[t : t + 4]
    ba, bf, bd, br = (_col(b) for b in bs[t : t + 4])
    sigma = _dot_in(Wa, h, _rounds(cfg, 1)) + ba
    zf = _dot_in(Wf, h, _rounds(cfg, Wf.shape[1])) + bf
    feat = torch.relu(zf)
    enc_d = encoding_rows(vdt, cfg.num_encoding_fn_dir, cfg.include_input_dir,
                          cfg.log_sampling_dir)
    y_in = torch.cat([feat, enc_d], dim=0)
    zd = _dot_in(Wd, y_in, _rounds(cfg, Wd.shape[1])) + bd
    y = torch.relu(zd)
    rgb = _dot_in(Wr, y, _rounds(cfg, 3)) + br
    out = torch.cat([rgb, sigma], dim=0)
    if not save:
        return out, None
    return out, dict(pre=pre, h=h, zf=zf, y_in=y_in, zd=zd, y=y)


def _chunks(n: int):
    return [slice(s, min(s + REF_CHUNK, n)) for s in range(0, n, REF_CHUNK)]


def _relu_grad(g, z):
    """The ReLU's backward as the reference computes it: its ``g * (z > 0)``
    is a select after XLA's simplification, so a masked NaN or inf cotangent
    gives 0, and a NaN pre-activation masks."""
    return torch.where(z > 0.0, g, torch.zeros_like(g))


@torch.no_grad()
def classic_fused_apply_cf_ref(params: dict, xt: torch.Tensor,
                               vdt: torch.Tensor, cfg) -> torch.Tensor:
    """Plain PyTorch version of :func:`classic_fused_apply_cf`."""
    n = xt.shape[1]
    outs = [_forward_cf(params, xt[:, sl], vdt[:, sl], cfg)[0] for sl in _chunks(n)]
    if not outs:
        return torch.zeros((4, 0), dtype=torch.float32, device=xt.device)
    return torch.cat(outs, dim=1)


def _backward_one(params, xt, vdt, g, cfg):
    """The reference's backward (``_bwd_kernel``) on one chunk."""
    Ws = params["W"]
    t = cfg.trunk_depth
    nw = t + 4
    _, res = _forward_cf(params, xt, vdt, cfg, save=True)
    dW, db = [None] * nw, [None] * nw
    g_rgb, g_sig = g[0:3], g[3:4]
    rnd = lambda L: _rounds(cfg, Ws[L].shape[1])
    # rgb head
    dW[t + 3] = _dot_acc(res["y"], g_rgb, rnd(t + 3))
    db[t + 3] = g_rgb.sum(dim=1, keepdim=True)
    gy = _relu_grad(_dot_out(Ws[t + 3], g_rgb, rnd(t + 3)), res["zd"])
    # direction branch
    dW[t + 2] = _dot_acc(res["y_in"], gy, rnd(t + 2))
    db[t + 2] = gy.sum(dim=1, keepdim=True)
    g_cat = _dot_out(Ws[t + 2], gy, rnd(t + 2))
    g_feat = _relu_grad(g_cat[: res["zf"].shape[0]], res["zf"])
    # feature head
    dW[t + 1] = _dot_acc(res["h"], g_feat, rnd(t + 1))
    db[t + 1] = g_feat.sum(dim=1, keepdim=True)
    gh = _dot_out(Ws[t + 1], g_feat, rnd(t + 1))
    # sigma head
    dW[t] = _dot_acc(res["h"], g_sig, rnd(t))
    db[t] = g_sig.sum(dim=1, keepdim=True)
    gh = gh + _dot_out(Ws[t], g_sig, rnd(t))
    # trunk
    for i in reversed(range(t)):
        inp, z = res["pre"][i]
        gh = _relu_grad(gh, z)
        dW[i] = _dot_acc(inp, gh, rnd(i))
        db[i] = gh.sum(dim=1, keepdim=True)
        if i:
            gh = _dot_out(Ws[i], gh, rnd(i))
    return {"W": dW, "b": db}


def _sum_grads(parts):
    out = parts[0]
    for d in parts[1:]:
        out = {k: [a + b for a, b in zip(out[k], d[k])] for k in out}
    return out


def _zero_grads(params):
    return {"W": [torch.zeros_like(w, dtype=torch.float32) for w in params["W"]],
            "b": [torch.zeros((w.shape[1], 1), dtype=torch.float32, device=w.device)
                  for w in params["W"]]}


@torch.no_grad()
def classic_fused_apply_cf_bwd_ref(params: dict, xt: torch.Tensor,
                                   vdt: torch.Tensor, g: torch.Tensor,
                                   cfg) -> dict:
    """Plain PyTorch version of :func:`classic_fused_apply_cf_bwd`: recompute
    the forward, then take the (4, N) cotangent to every parameter gradient
    (``{"W": [(in, out)], "b": [(out, 1)]}``)."""
    parts = [_backward_one(params, xt[:, sl], vdt[:, sl], g[:, sl], cfg)
             for sl in _chunks(xt.shape[1])]
    return _sum_grads(parts) if parts else _zero_grads(params)


# ---------------------------------------------------------------- kernels

def _ld(cols: int) -> int:
    """Row stride of a packed weight block: the kernel's per-thread output
    tile is 4 columns for up to 64 outputs and 8 for up to 128."""
    if cols > MAX_WIDTH:
        raise ValueError(f"a layer of {cols} outputs, above the kernel's {MAX_WIDTH}")
    return 64 if cols <= 64 else 128


class _Layout:
    """Dimensions and offsets of one config's kernel buffers, computed on the
    host and passed to the kernels in ``ClassicArgs``."""

    def __init__(self, params: dict, cfg):
        t, H = cfg.trunk_depth, cfg.hidden_size
        h2 = H // 2
        dx, dd = cfg.dim_xyz, cfg.dim_dir
        self.t, self.nw = t, t + 4
        LA, LF, LD, LR = t, t + 1, t + 2, t + 3
        want = ([(dx, H)] + [(H, H)] * (t - 1)
                + [(H, 1), (H, H), (H + dd, h2), (h2, 3)])
        got = [tuple(w.shape) for w in params["W"]]
        if got != want or len(params["b"]) != len(want):
            raise ValueError(f"weights {got} do not match the config's {want}")
        if self.nw > cuda_lib.CLASSIC_MAX_LAYERS:
            raise ValueError(f"at most {cuda_lib.CLASSIC_MAX_LAYERS - 4} trunk layers")
        if max(cfg.num_encoding_fn_xyz, cfg.num_encoding_fn_dir) > cuda_lib.CLASSIC_MAX_FREQS:
            raise ValueError(f"at most {cuda_lib.CLASSIC_MAX_FREQS} frequencies")
        self.ins = [w[0] for w in want]
        self.outs = [w[1] for w in want]
        # the weight-gradient kernel holds in * ceil(out / 4) <= 4096 groups
        for i, o in zip(self.ins, self.outs):
            if i * -(-o // 4) > 4096:
                raise ValueError(f"a ({i}, {o}) layer is too large for the "
                                 "weight-gradient kernel")
        self.rnd = [_rounds(cfg, o) for o in self.outs]
        self.wf_ld = [_ld(o) for o in self.outs]
        # backward products: d_inp rows kept (none for layer1 and fc_alpha)
        self.wb_cols = [0] + [H] * (t - 1) + [0, H, H, h2]
        self.wb_ld = [_ld(c) if c else 0 for c in self.wb_cols]
        self.wf_off, self.wb_off, self.b_off = [], [], []
        fo = bo = co = 0
        for L in range(self.nw):
            self.wf_off.append(fo)
            self.wb_off.append(bo)
            self.b_off.append(co)
            fo += self.ins[L] * self.wf_ld[L]
            bo += self.outs[L] * self.wb_ld[L]
            co += -(-self.outs[L] // 4) * 4
        self.wf_size, self.wb_size, self.b_size = fo, bo, co
        # f32 mode: the 3xTF32 A fragments, forward W^T (out x in) and
        # backward W (wb_cols x out), whole 16 x 8 tiles
        self.tf_off, self.tb_off = [], []
        fo = bo = 0
        for L in range(self.nw):
            self.tf_off.append(fo)
            self.tb_off.append(bo)
            fo += -(-self.outs[L] // 16) * -(-self.ins[L] // 8) * FRAG
            if self.wb_cols[L]:
                bo += -(-self.wb_cols[L] // 16) * -(-self.outs[L] // 8) * FRAG
        self.tf_size, self.tb_size = fo, bo
        self.buf_rows = max(dx, H + dd, 3)
        self.tc_rows = -(-self.buf_rows // 8) * 8  # whole k-tiles
        # saved inputs of every layer, in rows of `act`
        act = [0] * self.nw
        row = dx
        for i in range(1, t):
            act[i] = row
            row += H
        act[LA] = act[LF] = row
        row += H
        act[LD] = row
        row += H + dd
        act[LR] = row
        row += h2
        self.act_row, self.act_rows = act, row
        # masked output cotangents, in rows of `gs` (the heads read g)
        gsr = [-1] * self.nw
        for i in range(t):
            gsr[i] = i * H
        gsr[LF], gsr[LD] = t * H, (t + 1) * H
        self.gs_row, self.gs_rows = gsr, (t + 1) * H + h2
        # the flat gradient: per layer dW (in, out) then db
        self.dw_off, self.db_off = [], []
        off = 0
        for i, o in zip(self.ins, self.outs):
            self.dw_off.append(off)
            self.db_off.append(off + i * o)
            off += i * o + o
        self.grad_total = off


def _args(params, xt, vdt, out, cfg, lay: _Layout, scratch: dict):
    """Check everything the kernels assume and fill their argument struct
    (the tensor-core kernels when ``scratch`` holds their packed weights).
    Every pointer in it belongs to a tensor the caller holds."""
    dev = xt.device
    n = xt.shape[1]
    cuda_lib.check_tensor(xt, "xt", (3, None), dev)
    cuda_lib.check_tensor(vdt, "vdt", (3, n), dev)
    a = cuda_lib.ClassicArgs()
    a.xt, a.vdt, a.out = xt.data_ptr(), vdt.data_ptr(), out.data_ptr()
    for L, (w, b) in enumerate(zip(params["W"], params["b"])):
        if not w.is_cuda or w.device != dev or w.dtype != torch.float32:
            raise ValueError(f"W[{L}]: expected an f32 tensor on {dev}")
        if not b.is_cuda or b.device != dev or b.dtype != torch.float32:
            raise ValueError(f"b[{L}]: expected an f32 tensor on {dev}")
        if b.numel() != lay.outs[L]:
            raise ValueError(f"b[{L}]: {b.numel()} entries, expected {lay.outs[L]}")
        a.W[L], a.w_sk[L], a.w_sj[L] = w.data_ptr(), w.stride(0), w.stride(1)
        bv = b.reshape(-1)
        a.b[L], a.b_s[L] = bv.data_ptr(), bv.stride(0)
    a.wf, a.wb = scratch["wf"].data_ptr(), scratch["wb"].data_ptr()
    a.bias = scratch["bias"].data_ptr()
    a.tc = int("tf" in scratch)
    if a.tc:
        a.tf, a.tb = scratch["tf"].data_ptr(), scratch["tb"].data_ptr()
        a.nonfinite = scratch["nonfinite"].data_ptr()
    a.n, a.nw, a.trunk, a.hidden = n, lay.nw, lay.t, cfg.hidden_size
    a.buf_rows = lay.buf_rows
    for name in ("rnd", "wf_off", "wf_ld", "wb_off", "wb_ld", "wb_cols",
                 "b_off", "tf_off", "tb_off", "act_row", "gs_row", "dw_off",
                 "db_off"):
        dst = getattr(a, name)
        for L, v in enumerate(getattr(lay, name)):
            dst[L] = int(v)
    for L, (i, o) in enumerate(zip(lay.ins, lay.outs)):
        a.in_dim[L], a.out_dim[L] = i, o
    fx = frequencies(cfg.num_encoding_fn_xyz, cfg.log_sampling_xyz)
    fd = frequencies(cfg.num_encoding_fn_dir, cfg.log_sampling_dir)
    a.n_freq_x, a.n_freq_d = len(fx), len(fd)
    a.inc_x, a.inc_d = int(cfg.include_input_xyz), int(cfg.include_input_dir)
    for k, f in enumerate(fx):
        a.freq_x[k] = f
    for k, f in enumerate(fd):
        a.freq_d[k] = f
    a.grad_total = lay.grad_total
    return a


def _scratch(lay: _Layout, dev, cfg, tc: bool = True):
    """The packed weights; with ``tc`` in f32 mode also the 3xTF32
    fragments, which make the kernels take the tensor-core bodies, and the
    launch's words of "a non-finite input" (one a pack block)."""
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"wf": torch.empty(lay.wf_size, **f32),
           "wb": torch.empty(lay.wb_size, **f32),
           "bias": torch.empty(lay.b_size, **f32)}
    if tc and not _bf16(cfg):
        out["tf"] = torch.empty(lay.tf_size, **f32)
        out["tb"] = torch.empty(lay.tb_size, **f32)
        out["nonfinite"] = torch.empty(
            cuda_lib.CLASSIC_MAX_LAYERS * cuda_lib.CLASSIC_PACK_Y, dtype=torch.int32,
            device=dev)
    return out


def tile_smem_bytes(lay: _Layout, cfg) -> int:
    """Shared memory of a tile kernel (two activation buffers): rows of
    ``TC_LDP`` words on the tensor cores (f32 mode), of ``TILE`` words on the
    FMA body (bf16 mode)."""
    if _bf16(cfg):
        return 2 * lay.buf_rows * TILE * 4
    return 2 * lay.tc_rows * TC_LDP * 4


def _smem_check(lay: _Layout, cfg) -> None:
    need = tile_smem_bytes(lay, cfg)
    if need > cuda_lib.SMEM_LIMIT:
        raise ValueError(f"the tile needs {need} B of shared memory, above the "
                         f"{cuda_lib.SMEM_LIMIT} B one block may use")


def _launch_forward(params, xt, vdt, cfg, tc: bool = True):
    dev = xt.device
    n = xt.shape[1]
    if n == 0:
        return torch.empty((4, 0), dtype=torch.float32, device=dev)
    span = profiling.begin("launch.classic_fused_apply_cf")
    sp = profiling.begin("launch.plan")
    lay = _Layout(params, cfg)
    _smem_check(lay, cfg)
    profiling.end(sp)
    sp = profiling.begin("launch.scratch")
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    scratch = _scratch(lay, dev, cfg, tc)
    profiling.end(sp)
    a = _args(params, xt, vdt, out, cfg, lay, scratch)
    lib = cuda_lib.load_library()
    sp = profiling.begin("launch.call")
    code = lib.nkt_classic_forward(ctypes.byref(a), cuda_lib.current_stream(dev))
    profiling.end(sp)
    body = "bf16" if _bf16(cfg) else "3xtf32" if "tf" in scratch else "fma"
    cuda_lib.launched(span, "classic_fused_apply_cf", body, n)
    cuda_lib.raise_on_error(code, "classic_fused_apply_cf")
    return out


def _launch_grad(params, xt, vdt, g, cfg):
    """One launch sequence of the gradient kernels over all of ``xt``."""
    span = profiling.begin("launch.classic_fused_apply_cf_bwd")
    dev = xt.device
    n = xt.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    sp = profiling.begin("launch.plan")
    lay = _Layout(params, cfg)
    _smem_check(lay, cfg)
    profiling.end(sp)
    cuda_lib.check_tensor(g, "g", (4, n), dev)
    sp = profiling.begin("launch.scratch")
    scratch = _scratch(lay, dev, cfg)
    out4 = torch.empty((4, n), **f32)
    profiling.end(sp)
    a = _args(params, xt, vdt, out4, cfg, lay, scratch)
    n_part = 2 * cuda_lib.sm_count(dev)
    sp = profiling.begin("launch.scratch")
    act = torch.empty((lay.act_rows, n), **f32)
    gs = torch.empty((lay.gs_rows, n), **f32)
    partial = torch.empty((n_part, lay.grad_total), **f32)
    flat = torch.empty((lay.grad_total,), **f32)
    profiling.end(sp)
    a.g, a.act, a.gs = g.data_ptr(), act.data_ptr(), gs.data_ptr()
    a.partial, a.flat, a.n_part = partial.data_ptr(), flat.data_ptr(), n_part
    lib = cuda_lib.load_library()
    # The kernels run after this returns. Their scratch tensors may be freed
    # then: the caching allocator hands a block out again only to work that
    # is queued behind them on the same stream.
    sp = profiling.begin("launch.call")
    code = lib.nkt_classic_backward(ctypes.byref(a), cuda_lib.current_stream(dev))
    profiling.end(sp)
    cuda_lib.launched(span, "classic_fused_apply_cf_bwd",
                      "bf16" if _bf16(cfg) else "3xtf32", n)
    cuda_lib.raise_on_error(code, "classic_fused_apply_cf_bwd")
    d = {"W": [], "b": []}
    for L, (i, o) in enumerate(zip(lay.ins, lay.outs)):
        d["W"].append(flat[lay.dw_off[L] : lay.dw_off[L] + i * o].reshape(i, o))
        d["b"].append(flat[lay.db_off[L] : lay.db_off[L] + o].reshape(o, 1))
    return d


@torch.no_grad()
def classic_fused_apply_cf_bwd(params: dict, xt: torch.Tensor,
                               vdt: torch.Tensor, g: torch.Tensor, cfg) -> dict:
    """The VJP of :func:`classic_fused_apply_cf`: the (4, N) cotangent ``g``
    -> ``{"W": [(in, out)], "b": [(out, 1)]}``. A CUDA tensor goes through
    the kernels (in launches of at most ``BWD_CHUNK`` points, which bounds
    their scratch), a CPU tensor through the plain version."""
    if not xt.is_cuda:
        return classic_fused_apply_cf_bwd_ref(params, xt, vdt, g, cfg)
    n = xt.shape[1]
    if n == 0:
        return _zero_grads(params)
    parts = []
    for s in range(0, n, BWD_CHUNK):
        sl = slice(s, s + BWD_CHUNK)
        whole = n <= BWD_CHUNK
        parts.append(_launch_grad(
            params, xt if whole else xt[:, sl].contiguous(),
            vdt if whole else vdt[:, sl].contiguous(),
            g if whole else g[:, sl].contiguous(), cfg))
    return _sum_grads(parts)


def _forward(params, xt, vdt, cfg, tc: bool = True):
    if not xt.is_cuda:
        return classic_fused_apply_cf_ref(params, xt, vdt, cfg)
    return _launch_forward(params, xt, vdt, cfg, tc)


class _ClassicApply(torch.autograd.Function):
    """:func:`classic_fused_apply_cf` under autograd: the backward is the
    gradient kernel (or its plain version for CPU tensors); points and
    directions get no gradient. In f32 mode the forward here is the FMA
    body, the one the gradient kernel runs again for its ReLU masks: the
    loss and its gradient then come from one forward. (The 3xTF32 forward
    sits a few f32 bits away from it, enough to move a sample across the
    density noise's ReLU now and then.)"""

    @staticmethod
    def forward(ctx, xt, vdt, cfg, nw, *leaves):
        ctx.cfg, ctx.nw = cfg, nw
        ctx.save_for_backward(xt, vdt, *leaves)
        return _forward({"W": list(leaves[:nw]), "b": list(leaves[nw:])},
                        xt, vdt, cfg, tc=False)

    @staticmethod
    def backward(ctx, g):
        xt, vdt, *leaves = ctx.saved_tensors
        nw = ctx.nw
        d = classic_fused_apply_cf_bwd(
            {"W": leaves[:nw], "b": leaves[nw:]}, xt, vdt, g.contiguous(), ctx.cfg)
        grads_b = [gb.reshape(b.shape) for gb, b in zip(d["b"], leaves[nw:])]
        return (None, None, None, None, *d["W"], *grads_b)


def classic_fused_apply_cf(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                           cfg) -> torch.Tensor:
    """Fused classic point pipeline, channels-first IO: (3, N) points and
    (3, N) unit view directions -> (4, N), rows 0-2 rgb logits, row 3 raw
    sigma. A CUDA tensor goes through the kernel (in f32 mode: 3xTF32 on
    the tensor cores, or the FMA body when a gradient will be taken); a CPU
    tensor through the plain version. Differentiable in ``params`` only
    (see the module docstring)."""
    leaves = [*params["W"], *params["b"]]
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _ClassicApply.apply(xt.detach(), vdt.detach(), cfg,
                                   len(params["W"]), *leaves)
    with torch.no_grad():
        return _forward(params, xt, vdt, cfg)
