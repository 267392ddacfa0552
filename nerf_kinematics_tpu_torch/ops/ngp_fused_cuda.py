"""Fused NGP point pipeline (forward): the CUDA kernels' wrappers and their
plain PyTorch versions.

Replaces, from ``nerf_kinematics_tpu/ops/ngp_fused_pallas.py``:

  * ``ngp_fused_sigma_cf``          -> :func:`ngp_fused_sigma_cf`
  * ``ngp_fused_apply_cf`` forward  -> :func:`ngp_fused_apply_cf`
  * ``ngp_fused_apply``             -> :func:`ngp_fused_apply`

Kernel source: ``csrc/ngp_fused.cu``. Channels-first IO: ``(3, N)`` unit-cube
points and ``(3, N)`` unit view directions -> ``(4, N)``, rows 0-2 rgb logits
and row 3 sigma (already exp-activated). ``params`` is the raw-array dict the
reference's kernels take: ``{"lines": (L,3,T,C), "dW": [(in,out)..],
"db": [(out,1)..], "cW": [..], "cb": [..]}``.

Forward only: the gradient kernels are ported with training.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .cp_grid import CPGridConfig, cp_encode_stacked
from .sh import sh_encode

REF_CHUNK = 1 << 19  # points per chunk of the plain versions


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
    through the plain version."""
    if not xt.is_cuda:
        return ngp_fused_sigma_cf_ref(params, xt, cfg)
    return _launch(params, xt, None, cfg, False, "ngp_fused_sigma_cf")


def ngp_fused_apply_cf(params: dict, xt: torch.Tensor, vdt: torch.Tensor,
                       cfg: CPGridConfig) -> torch.Tensor:
    """Fused point pipeline, channels-first IO: (3, N) points and (3, N) unit
    view directions -> (4, N), rows 0-2 rgb logits, row 3 sigma. A CUDA
    tensor goes through the kernel; a CPU tensor through the plain version."""
    if not xt.is_cuda:
        return ngp_fused_apply_cf_ref(params, xt, vdt, cfg)
    return _launch(params, xt, vdt, cfg, True, "ngp_fused_apply_cf")


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
