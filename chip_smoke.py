#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as a checker runs it
    python3 chip_smoke.py --quick    # small shapes: build, launch, compare

Builds the CUDA kernels from ``nerf_kinematics_tpu_torch/csrc`` (first use),
holds each kernel against its plain PyTorch version on the card at the shapes
the main paths give it, and drives both main paths of the ``machina_ngp``
model at full width through the entry points a user calls:

  * serving: 400x400 frames from the fixture's trained weights (fast
    renderer, the compacted recipe, the evaluation renderer, a full occupancy
    sweep, the density grid), held against the golden renders the JAX package
    produced from the same weights;
  * training: ``Trainer.fit`` for 768 steps of the flagship configuration
    from a seeded fresh state, on views the port renders from the trained
    weights, then validation on held-out views and a checkpoint round trip;
    one step of each of the three gradient routes from the same state and
    draws, which must agree.

It prints one JSON object per phase, then a ``{"kernels": [...]}`` line, the
card's name and power limit as ``nvidia-smi`` gives them, and as the last
line ``{"ok": true, "device": {...}}``. Any failed phase raises: the process
exits non-zero and prints no result line. It needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): the roofline a bound is taken from.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

PHASES = ("kernels", "grad_kernels", "serve", "golden", "train", "train_autodiff")

KERNEL_REPS = 5        # timed launches per kernel (median), after 2 warm-ups

FUSED_MEAN_TOL = 2e-4  # mean |kernel - plain| of rgb logits and of log sigma
FUSED_MAX_TOL = 0.25   # largest single difference of the same


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    after ``warmup`` launches, with the L2 cache overwritten in between."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, kind: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def mlp_flops(Ws) -> int:
    return sum(2 * w.shape[0] * w.shape[1] for w in Ws)


def param_bytes(params, color: bool) -> int:
    ts = [params["lines"], *params["dW"], *params["db"]]
    if color:
        ts += [*params["cW"], *params["cb"]]
    return sum(t.numel() * 4 for t in ts)


def random_points(n: int, gen, dev):
    """Unit-cube points (slightly beyond, so the clip is exercised) and unit
    directions, channels-first."""
    xt = torch.rand((3, n), generator=gen, device=dev) * 1.04 - 0.02
    vd = torch.randn((3, n), generator=gen, device=dev)
    vd = vd / torch.linalg.norm(vd, dim=0, keepdim=True)
    return xt.contiguous(), vd.contiguous()


def fused_errors(out, ref, color: bool):
    """(max_abs, mean_abs, max_rel_sigma): rgb logits compared absolutely,
    sigma through its logarithm (sigma = exp(z0), so an absolute error of z0
    is a relative error of sigma)."""
    ls_k, ls_p = torch.log(out[3]), torch.log(ref[3])
    d = (ls_k - ls_p).abs()
    rel = ((out[3] - ref[3]).abs() / (ref[3].abs() + 1e-30)).max().item()
    if color:
        d = torch.cat([(out[:3] - ref[:3]).abs().reshape(-1), d])
    else:
        if out[:3].abs().max().item() != 0.0:
            raise AssertionError("sigma kernel: rgb rows are not zero")
    return d.max().item(), d.mean().item(), rel


def phase_kernels(fx, dev, quick: bool, reps: int):
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
        cp_encode_cuda, cp_encode_cuda_ref)
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_ref, ngp_fused_sigma_cf,
        ngp_fused_sigma_cf_ref)
    from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections
    from nerf_kinematics_tpu_torch.ops.occupancy_cuda import (
        occupancy_at_hull_cuda, occupancy_at_hull_cuda_ref)
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain versions need full-f32 matmuls")
    gen = torch.Generator(device=dev).manual_seed(1234)
    cpu_gen = torch.Generator().manual_seed(1234)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    shrink = 16 if quick else 1
    n_hull = 200 * 200 * 64 // shrink       # a 200x200 block grid x 64 bins
    n_sigma = 160000 * 64 // shrink         # eval coarse pass of a 400^2 frame
    n_apply = 160000 * 128 // shrink        # fine pass of a 400^2 frame
    occ_R = fx.config.ngp.occ_resolution
    n_enc = occ_R**3 // shrink              # the occupancy sweep

    trained = NGPEngine(fx.config, 1.0, device=dev)
    trained.load_flax_params(fx.params)
    random_w = NGPEngine(fx.config, 1.0, device=dev, generator=cpu_gen)
    f32_cfg = fx.config.replace(ngp=_replace_cp(fx.config.ngp, use_bf16=False))
    f32_eng = NGPEngine(f32_cfg, 1.0, device=dev)
    f32_eng.load_flax_params(fx.params)
    cp: CPGridConfig = fx.config.ngp.cp
    LC = cp.out_dim
    rows = []

    # ---- row 1: hull occupancy lookup ---------------------------------
    grid = grid_from_numpy(fx.grid_density, fx.grid_bound, device=dev)
    proj_t = pair_projections(grid).contiguous()
    proj_r = torch.rand((3, occ_R, occ_R), generator=gen, device=dev) * 50.0
    xt, _ = random_points(n_hull, gen, dev)
    err = 0.0
    for proj in (proj_t, proj_r):
        k = occupancy_at_hull_cuda(proj, xt)
        p = occupancy_at_hull_cuda_ref(proj, xt)
        torch.cuda.synchronize()
        err = max(err, (k - p).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"occupancy_at_hull: max abs err {err} != 0")
    b, by = bound_ms(n_hull * 16 + proj_t.numel() * 4, n_hull * 12, "f32")
    rows.append({
        "name": "occupancy_at_hull", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/occupancy_hull.cu",
        "replaces": "nerf_kinematics_tpu/ops/occupancy_pallas.py:68",
        "n_points": n_hull, "max_abs_err": err, "max_rel_err": 0.0,
        "tolerance": "exact",
        "ms": time_ms(lambda: occupancy_at_hull_cuda(proj_t, xt), reps, 2, flush),
        "plain_ms": time_ms(lambda: occupancy_at_hull_cuda_ref(proj_t, xt), 3, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })

    # ---- row 4: stand-alone CP encoder ----------------------------------
    x_enc = random_points(n_enc, gen, dev)[0].T.contiguous()
    err = 0.0
    for eng in (trained, random_w, f32_eng):
        lines, c = eng.model.cp_lines.detach(), eng.ngp_config.cp
        k = cp_encode_cuda(lines, x_enc, c)
        p = cp_encode_cuda_ref(lines, x_enc, c)
        torch.cuda.synchronize()
        err = max(err, (k - p).abs().max().item())
    tol = 1e-6
    if not err <= tol:
        raise AssertionError(f"cp_encode: max abs err {err} > {tol}")
    lines = trained.model.cp_lines.detach()
    enc_flops = n_enc * LC * 11
    b, by = bound_ms(n_enc * (12 + 4 * LC) + lines.numel() * 4, enc_flops, "f32")
    rows.append({
        "name": "cp_encode", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/cp_encode.cu",
        "replaces": "nerf_kinematics_tpu/ops/cp_grid_pallas.py:211",
        "n_points": n_enc, "max_abs_err": err, "max_rel_err": None,
        "tolerance": f"abs {tol} (same roundings, same order of the two products)",
        "ms": time_ms(lambda: cp_encode_cuda(lines, x_enc, cp), reps, 2, flush),
        "plain_ms": time_ms(lambda: cp_encode_cuda_ref(lines, x_enc, cp), 3, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })

    # ---- rows 2 and 3: fused forwards ----------------------------------
    for name, n, color, line in (
        ("ngp_fused_sigma_cf", n_sigma, False, 231),
        ("ngp_fused_apply_cf", n_apply, True, 441),
    ):
        xt, vd = random_points(n, gen, dev)
        kern = (lambda p, c, xt=xt, vd=vd: ngp_fused_apply_cf(p, xt, vd, c)) \
            if color else (lambda p, c, xt=xt: ngp_fused_sigma_cf(p, xt, c))
        plain = (lambda p, c, xt=xt, vd=vd: ngp_fused_apply_cf_ref(p, xt, vd, c)) \
            if color else (lambda p, c, xt=xt: ngp_fused_sigma_cf_ref(p, xt, c))
        worst = {"max": 0.0, "mean": 0.0, "rel": 0.0}
        for eng in (trained, random_w):
            params, c = eng._fused_params(detach=True), eng.ngp_config.cp
            k, p = kern(params, c), plain(params, c)
            torch.cuda.synchronize()
            if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
                raise AssertionError(f"{name}: non-finite output")
            mx, mean, rel = fused_errors(k, p, color)
            worst = {"max": max(worst["max"], mx), "mean": max(worst["mean"], mean),
                     "rel": max(worst["rel"], rel)}
            del k, p
        # f32 mode: no bf16 rounding, so only the order of the sums differs.
        params, c = f32_eng._fused_params(detach=True), f32_eng.ngp_config.cp
        sl = slice(0, max(n // 8, 1))
        xs, vs = xt[:, sl].contiguous(), vd[:, sl].contiguous()
        k32 = ngp_fused_apply_cf(params, xs, vs, c) if color else \
            ngp_fused_sigma_cf(params, xs, c)
        p32 = ngp_fused_apply_cf_ref(params, xs, vs, c) if color else \
            ngp_fused_sigma_cf_ref(params, xs, c)
        f32_max, f32_mean, _ = fused_errors(k32, p32, color)
        del k32, p32
        if not (worst["mean"] <= FUSED_MEAN_TOL and worst["max"] <= FUSED_MAX_TOL):
            raise AssertionError(f"{name}: bf16 mode out of tolerance: {worst}")
        if not f32_max <= 2e-3:
            raise AssertionError(f"{name}: f32 mode max err {f32_max} > 2e-3")
        params = trained._fused_params(detach=True)
        Ws = params["dW"] + (params["cW"] if color else [])
        flops = n * (mlp_flops(Ws) + LC * 12)
        io = n * (12 + 16 + (12 if color else 0)) + param_bytes(params, color)
        b, by = bound_ms(io, flops, "bf16")
        rows.append({
            "name": name, "route": "cuda",
            "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused.cu",
            "replaces": f"nerf_kinematics_tpu/ops/ngp_fused_pallas.py:{line}",
            "n_points": n, "max_abs_err": worst["max"],
            "mean_abs_err": worst["mean"], "max_rel_err": worst["rel"],
            "f32_mode_max_abs_err": f32_max, "f32_mode_mean_abs_err": f32_mean,
            "tolerance": (
                f"rgb logits and log(sigma): mean abs {FUSED_MEAN_TOL}, max abs "
                f"{FUSED_MAX_TOL} (the sums run in another order than the plain "
                "version's matmul, which can flip the bf16 rounding of a hidden "
                "activation); f32 mode max abs 2e-3"),
            "ms": time_ms(lambda: kern(params, cp), reps, 2, flush),
            "plain_ms": time_ms(lambda: plain(params, cp), 2, 1, flush),
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
        del xt, vd
    emit({"phase": "kernels", "quick": quick, "kernels": rows})
    return rows


GRAD_TOL = {"bf16": 5e-3, "f32": 2e-4}  # per leaf, relative to its largest entry
TRAIN_OUT_TOL = 1e-4                    # err and maps of the train objective, abs


def _leaf_list(d):
    out = [("lines", d["lines"])]
    for k in ("dW", "db", "cW", "cb"):
        out += [(f"{k}[{i}]", t) for i, t in enumerate(d[k])]
    return out


def grad_errors(got: dict, want: dict):
    """Per leaf (max abs, mean abs) error relative to the leaf's largest
    entry in the plain version."""
    rep = {}
    for (name, a), (_, b) in zip(_leaf_list(got), _leaf_list(want)):
        if a.shape != b.shape:
            raise AssertionError(f"{name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name}: non-finite gradient")
        scale = b.abs().max().item()
        if scale == 0.0:
            raise AssertionError(f"{name}: the plain version's gradient is all zero")
        d = (a - b).abs()
        rep[name] = {"max_rel": d.max().item() / scale,
                     "mean_rel": d.mean().item() / scale, "scale": scale}
    return rep


def phase_grad_kernels(fx, dev, quick: bool, reps: int):
    """Rows 5-7: each gradient kernel against its plain version on the card
    at the flagship train step's shapes, trained weights, seeded random
    cotangents / targets, bf16 and f32 mode."""
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
        cp_encode_cuda_bwd, cp_encode_cuda_bwd_ref)
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf_bwd, ngp_fused_apply_cf_bwd_ref, ngp_fused_train_cf,
        ngp_fused_train_cf_ref)
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    S = fx.config.nerf.train.num_fine
    R = fx.config.nerf.num_random_rays // (16 if quick else 1)
    n = R * S
    engines = {}
    for mode in ("bf16", "f32"):
        cfg = fx.config.replace(
            ngp=_replace_cp(fx.config.ngp, use_bf16=(mode == "bf16")))
        engines[mode] = NGPEngine(cfg, 1.0, device=dev)
        engines[mode].load_flax_params(fx.params)
    cp = fx.config.ngp.cp
    LC = cp.out_dim
    xt, vd = random_points(n, gen, dev)
    # rays: sorted depths in [2, 6] give the intervals; the last is the
    # sentinel, scaled by a direction norm near 1.
    z = torch.sort(torch.rand((R, S), generator=gen, device=dev), dim=-1).values
    z = 2.0 + 4.0 * z
    norm = 0.9 + 0.2 * torch.rand((R, 1), generator=gen, device=dev)
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full((R, 1), 1e10, device=dev)], dim=-1) * norm
    dists = dists.reshape(1, n).contiguous()
    tgt = torch.rand((3, R), generator=gen, device=dev)
    g4 = torch.randn((4, n), generator=gen, device=dev)
    g4[3] *= 1e-3  # sigma reaches e^15: keep its share of the gradient moderate
    g_enc = torch.randn((n, LC), generator=gen, device=dev)
    x_enc = xt.T.contiguous()
    inv = 1.0 / (3.0 * R)
    rows = []

    def worst_of(reports):
        return max(v["max_rel"] for rep in reports for v in rep.values())

    def check(name, mode, rep):
        bad = {k: v for k, v in rep.items() if not v["max_rel"] <= GRAD_TOL[mode]}
        if bad:
            raise AssertionError(
                f"{name} ({mode}): gradient out of tolerance {GRAD_TOL[mode]}: {bad}")

    # ---- row 5: CP encoder VJP -----------------------------------------
    reports = {}
    for mode, eng in engines.items():
        lines, c = eng.model.cp_lines.detach(), eng.ngp_config.cp
        k = cp_encode_cuda_bwd(lines, x_enc, g_enc, c)
        p = cp_encode_cuda_bwd_ref(lines, x_enc, g_enc, c)
        torch.cuda.synchronize()
        reports[mode] = grad_errors({"lines": k, "dW": [], "db": [], "cW": [], "cb": []},
                                    {"lines": p, "dW": [], "db": [], "cW": [], "cb": []})
        check("cp_encode_bwd", mode, reports[mode])
        abs_err = (k - p).abs().max().item()
        del k, p
    lines = engines["bf16"].model.cp_lines.detach()
    b, by = bound_ms(n * (12 + 4 * LC) + 2 * lines.numel() * 4, n * LC * 20, "f32")
    rows.append({
        "name": "cp_encode_bwd", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/cp_encode.cu",
        "replaces": "nerf_kinematics_tpu/ops/cp_grid_pallas.py:240",
        "n_points": n, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "tolerance": f"per leaf, max abs over the leaf's largest entry: {GRAD_TOL} "
                     "(atomicAdd sums in another order than index_add_)",
        "ms": time_ms(lambda: cp_encode_cuda_bwd(lines, x_enc, g_enc, cp), reps, 2, flush),
        "plain_ms": time_ms(lambda: cp_encode_cuda_bwd_ref(lines, x_enc, g_enc, cp), 2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })

    # ---- rows 6 and 7: fused VJP and fused train objective -------------
    params = engines["bf16"]._fused_params(detach=True)
    Ws = params["dW"] + params["cW"]
    flops = n * (3 * mlp_flops(Ws) + LC * 12 + LC * 30)
    pbytes = param_bytes(params, True)

    reports = {}
    for mode, eng in engines.items():
        prm, c = eng._fused_params(detach=True), eng.ngp_config.cp
        k = ngp_fused_apply_cf_bwd(prm, xt, vd, g4, c)
        p = ngp_fused_apply_cf_bwd_ref(prm, xt, vd, g4, c)
        torch.cuda.synchronize()
        reports[mode] = grad_errors(k, p)
        check("ngp_fused_apply_cf_bwd", mode, reports[mode])
        abs_err = max((a - b_).abs().max().item()
                      for (_, a), (_, b_) in zip(_leaf_list(k), _leaf_list(p)))
        del k, p
    b, by = bound_ms(n * (24 + 16) + 2 * pbytes, flops, "bf16")
    rows.append({
        "name": "ngp_fused_apply_cf_bwd", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused_bwd.cu",
        "replaces": "nerf_kinematics_tpu/ops/ngp_fused_pallas.py:475",
        "n_points": n, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "tolerance": f"per leaf, max abs over the leaf's largest entry: {GRAD_TOL} "
                     "(other summation order; a flipped bf16 rounding of a cotangent)",
        "ms": time_ms(lambda: ngp_fused_apply_cf_bwd(params, xt, vd, g4, cp), reps, 2, flush),
        "plain_ms": time_ms(lambda: ngp_fused_apply_cf_bwd_ref(params, xt, vd, g4, cp), 2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })

    reports, out_err = {}, 0.0
    for mode, eng in engines.items():
        prm, c = eng._fused_params(detach=True), eng.ngp_config.cp
        for white in (True, False):
            ek, mk, k = ngp_fused_train_cf(prm, xt, vd, dists, tgt, c, S, white, inv)
            ep, mp, p = ngp_fused_train_cf_ref(prm, xt, vd, dists, tgt, c, S, white, inv)
            torch.cuda.synchronize()
            if ek.shape != (1, R) or mk.shape != (4, R):
                raise AssertionError("ngp_fused_train_cf: wrong err / maps shape")
            out_err = max(out_err, (ek - ep).abs().max().item(),
                          (mk - mp).abs().max().item())
            reports[f"{mode}{'_white' if white else ''}"] = rep = grad_errors(k, p)
            check("ngp_fused_train_cf", mode, rep)
            abs_err = max((a - b_).abs().max().item()
                          for (_, a), (_, b_) in zip(_leaf_list(k), _leaf_list(p)))
            del k, p
    if not out_err <= TRAIN_OUT_TOL:
        raise AssertionError(
            f"ngp_fused_train_cf: err / maps differ by {out_err} > {TRAIN_OUT_TOL}")
    b, by = bound_ms(n * 28 + R * (12 + 20) + 2 * pbytes, flops + n * 120, "bf16")
    rows.append({
        "name": "ngp_fused_train_cf", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused_bwd.cu",
        "replaces": "nerf_kinematics_tpu/ops/ngp_fused_pallas.py:752",
        "n_points": n, "n_rays": R, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "err_maps_max_abs_err": out_err,
        "tolerance": f"err, maps: abs {TRAIN_OUT_TOL}; gradients per leaf, max abs "
                     f"over the leaf's largest entry: {GRAD_TOL}",
        "ms": time_ms(lambda: ngp_fused_train_cf(params, xt, vd, dists, tgt, cp, S, True, inv),
                      reps, 2, flush),
        "plain_ms": time_ms(lambda: ngp_fused_train_cf_ref(params, xt, vd, dists, tgt, cp, S, True, inv),
                            2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })
    # ---- ragged sizes: the tails of a block, a warp and a tile, and the
    # wrappers' split into several launches -------------------------------
    from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda

    Rr, Sr = 37, 27
    nr = Rr * Sr  # 999 points: no multiple of 32
    eng = engines["bf16"]
    prm, c = eng._fused_params(detach=True), eng.ngp_config.cp
    xr, vr = xt[:, :nr].contiguous(), vd[:, :nr].contiguous()
    gr, ger = g4[:, :nr].contiguous(), g_enc[:nr].contiguous()
    dr = torch.rand((Rr, Sr), generator=gen, device=dev) * 0.2
    dr[:, -1] = 1e10
    dr = dr.reshape(1, nr).contiguous()
    tr_ = tgt[:, :Rr].contiguous()
    ragged = {}
    for label, chunk in (("one launch", ngp_fused_cuda.BWD_CHUNK), ("split", 400)):
        keep = ngp_fused_cuda.BWD_CHUNK
        ngp_fused_cuda.BWD_CHUNK = chunk
        k6 = ngp_fused_apply_cf_bwd(prm, xr, vr, gr, c)
        ek, mk, k7 = ngp_fused_train_cf(prm, xr, vr, dr, tr_, c, Sr, True, 1.0 / (3 * Rr))
        ngp_fused_cuda.BWD_CHUNK = keep
        p6 = ngp_fused_apply_cf_bwd_ref(prm, xr, vr, gr, c)
        ep, mp, p7 = ngp_fused_train_cf_ref(prm, xr, vr, dr, tr_, c, Sr, True, 1.0 / (3 * Rr))
        torch.cuda.synchronize()
        rep6, rep7 = grad_errors(k6, p6), grad_errors(k7, p7)
        check("ngp_fused_apply_cf_bwd, ragged, " + label, "bf16", rep6)
        check("ngp_fused_train_cf, ragged, " + label, "bf16", rep7)
        out_r = max((ek - ep).abs().max().item(), (mk - mp).abs().max().item())
        if not out_r <= TRAIN_OUT_TOL:
            raise AssertionError(f"ngp_fused_train_cf, ragged: err / maps differ by {out_r}")
        ragged[label] = {"rows_6_7_max_rel": max(worst_of([rep6]), worst_of([rep7])),
                         "err_maps_max_abs": out_r}
    k5 = cp_encode_cuda_bwd(prm["lines"], xr.T.contiguous(), ger, c)
    p5 = cp_encode_cuda_bwd_ref(prm["lines"], xr.T.contiguous(), ger, c)
    rep5 = grad_errors({"lines": k5, "dW": [], "db": [], "cW": [], "cb": []},
                       {"lines": p5, "dW": [], "db": [], "cW": [], "cb": []})
    check("cp_encode_bwd, ragged", "bf16", rep5)
    ragged["row_5_max_rel"] = worst_of([rep5])
    emit({"phase": "grad_kernels", "quick": quick, "kernels": rows,
          "ragged_999_points": ragged})
    return rows


def _replace_cp(ngp, **kw):
    import dataclasses

    return dataclasses.replace(ngp, cp=dataclasses.replace(ngp.cp, **kw))


def check_maps(out: dict, what: str) -> None:
    for k, v in out.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{what}: non-finite values in {k}")
    rgb, acc = out["rgb"], out["acc"]
    if rgb.min().item() < 0.0 or rgb.max().item() > 1.0 + 1e-6:
        raise AssertionError(f"{what}: rgb outside [0, 1]")
    if acc.min().item() < 0.0 or acc.max().item() > 1.0 + 1e-3:
        raise AssertionError(f"{what}: acc outside [0, 1 + 1e-3]")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_serve(fx, dev, quick: bool):
    from nerf_kinematics_tpu_torch.data.machina import (
        machina_intrinsics, orbit_poses)
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.rendering.fast_render import FastRenderSettings
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    size = 100 if quick else fx.intrinsics.width
    intr = machina_intrinsics(size) if quick else fx.intrinsics
    near, far = fx.config.dataset.near, fx.config.dataset.far
    val = fx.config.nerf.validation
    engine = NGPEngine(fx.config, scene_bound=1.0)  # device=None: the card
    engine.load_flax_params(fx.params)
    aux = grid_from_numpy(fx.grid_density, fx.grid_bound, device=engine.device)
    poses8 = torch.tensor(orbit_poses(8), device=dev)
    poses4 = torch.tensor(orbit_poses(4, elev_deg=20.0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    fast = engine.make_fast_render_batch(intr, near, far, False)
    recipe = FastRenderSettings(
        num_coarse=val.num_coarse, num_fine=64, fg_fraction=0.35,
        white_background=val.white_background,
    )
    fast_fg = engine.make_fast_render_batch(intr, near, far, False, settings=recipe)
    full = engine.make_render_fn(intr, near, far, False)

    fast(poses8[:1], aux)  # warm-up: allocator, kernels loaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    # ---- the main path -------------------------------------------------
    out8, ms8 = timed(lambda: fast(poses8, aux))
    counts_fast = dict(cuda_lib.LAUNCHES)
    out4, ms4 = timed(lambda: fast_fg(poses4, aux))
    counts_fg = dict(cuda_lib.LAUNCHES)
    outs_e, ms_e = timed(lambda: [full(p, aux) for p in poses8[:2]])
    counts_eval = dict(cuda_lib.LAUNCHES)
    swept, ms_sweep = timed(
        lambda: engine.update_occupancy(engine.init_aux(), full=True, generator=gen))
    dgrid, ms_dgrid = timed(lambda: engine.density_grid(resolution=128))
    counts = dict(cuda_lib.LAUNCHES)
    # ---------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    def minus(a, b):
        return {k: a[k] - b[k] for k in a}

    check_maps(out8, "fast render")
    check_maps(out4, "fast render, fg_fraction 0.35")
    for o in outs_e:
        check_maps(o, "eval render")
    # A trained scene on a white background is neither empty nor full. The
    # model fills free space with white fog (acc ~ 1 on every ray), so the
    # coverage is read from the color: the share of pixels darker than 0.95.
    fg = (out8["rgb"].amin(dim=-1) < 0.95).float().mean().item()
    if not 0.02 < fg < 0.98:
        raise AssertionError(f"fast render: foreground share {fg} not in (0.02, 0.98)")
    mean_acc = out8["acc"].mean().item()
    above = (swept.density > 1.0).float().mean().item()
    if not 0.0 < above < 1.0:
        raise AssertionError("swept grid: cells not on both sides of 1.0")
    if tuple(dgrid.shape) != (128, 128, 128) or not torch.isfinite(dgrid).all():
        raise AssertionError("density_grid: wrong shape or non-finite")
    serving = ("occupancy_at_hull", "ngp_fused_sigma_cf", "ngp_fused_apply_cf",
               "cp_encode")
    missing = [k for k in serving if counts[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")
    n8, n4 = len(poses8), len(poses4)
    per_frame = {
        "fast": {k: v / n8 for k, v in counts_fast.items()},
        "fast_fg035": {k: v / n4 for k, v in minus(counts_fg, counts_fast).items()},
        "eval": {k: v / 2 for k, v in minus(counts_eval, counts_fg).items()},
    }
    emit({
        "phase": "serve", "quick": quick, "size": [intr.height, intr.width],
        "fast_ms_per_frame": ms8 / n8, "fast_frames": n8,
        "fast_fg035_ms_per_frame": ms4 / n4, "fast_fg035_frames": n4,
        "eval_ms_per_frame": ms_e / 2, "eval_frames": 2,
        "occupancy_sweep_ms": ms_sweep, "density_grid_128_ms": ms_dgrid,
        "launches": counts, "launches_per_frame": per_frame,
        "foreground_share": fg, "mean_acc": mean_acc,
        "swept_cells_above_1": above, "peak_memory_gib": peak_gb,
    })
    return counts, engine, aux


def phase_golden(fx, engine, aux):
    from nerf_kinematics_tpu_torch.io.fixture import intrinsics_from_row
    from nerf_kinematics_tpu_torch.metrics.psnr import psnr

    g = fx.golden
    intr = intrinsics_from_row(g["intrinsics"])
    near, far = fx.config.dataset.near, fx.config.dataset.far
    fns = {
        "fast": engine.make_fast_render_fn(intr, near, far, False),
        "eval": engine.make_render_fn(intr, near, far, False),
    }
    report = {"phase": "golden", "size": [intr.height, intr.width]}
    for name, fn in fns.items():
        for k, i in enumerate(g[f"{name}_pose_idx"]):
            out = fn(fx.poses[int(i)], aux)
            ref = g[f"{name}_rgb"][k].astype(np.float32)
            got = out["rgb"].cpu().numpy()
            db = psnr(got, ref)
            mae = float(np.abs(got - ref).mean())
            acc_mae = float(np.abs(
                out["acc"].cpu().numpy() - g[f"{name}_acc"][k].astype(np.float32)
            ).mean())
            report[f"{name}_pose{int(i)}"] = {
                "psnr_db": db, "mean_abs_err": mae, "acc_mean_abs_err": acc_mae}
            if not (db >= 35.0 and mae <= 5e-3):
                raise AssertionError(
                    f"golden {name} pose {int(i)}: PSNR {db:.2f} dB, mean abs "
                    f"{mae:.2e} (need >= 35 dB and <= 5e-3)")
    emit(report)


TRAIN_STEPS = 768          # a full sweep at 256, incremental refreshes at 512, 768
# About half of the seeds of a fresh model fall at once into an all-white
# state on such targets, in the reference as in the port (PERF.md section 6,
# scripts/torch_train_seeds.py); 7 is one that trains.
TRAIN_SEED = 7
VAL_PSNR_FLOOR_DB = 25.5  # held-out PSNR after TRAIN_STEPS; see PERF.md section 6
ROUTE_TOL = {"f32": 2e-3, "bf16": 5e-3}  # gradients across routes, per leaf,
#                                          relative to the leaf's largest entry
UNFUSED_BF16_TOL = 0.25    # the unfused route rounds every layer's output to bf16


def _train_config(fx, logdir, quick: bool, **ngp_kw):
    import dataclasses

    shrink = 16 if quick else 1
    steps = 96 if quick else TRAIN_STEPS
    ngp = dataclasses.replace(
        fx.config.ngp, occ_update_every=steps // 3,
        occ_full_every=2048 if not quick else 128, **ngp_kw)
    exp = dataclasses.replace(
        fx.config.experiment, logdir=logdir, id="chip_smoke", print_every=0,
        validate_every=0, save_every=0, train_iters=steps, randomseed=TRAIN_SEED)
    nerf = dataclasses.replace(
        fx.config.nerf, num_random_rays=fx.config.nerf.num_random_rays // shrink)
    return fx.config.replace(ngp=ngp, experiment=exp, nerf=nerf), steps


def build_dataset(fx, engine, aux, dev, quick: bool):
    """Views of the fixture's trained model, rendered by the port's
    evaluation renderer: 80 for training on five orbits between 5 and 60
    degrees of elevation (the span of the reference scene's training
    cameras), 2 held out."""
    from nerf_kinematics_tpu_torch.data.machina import (
        machina_intrinsics, orbit_poses)
    from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays

    size = 100 if quick else fx.intrinsics.width
    intr = machina_intrinsics(size) if quick else fx.intrinsics
    near, far = fx.config.dataset.near, fx.config.dataset.far
    n_each = 8 if quick else 16
    poses = np.concatenate(
        [orbit_poses(n_each, elev_deg=float(e)) for e in np.linspace(5, 60, 5)]
        + [orbit_poses(5, elev_deg=20.0)[1:3]])
    render = engine.make_render_fn(intr, near, far, False)
    with torch.no_grad():
        images = torch.stack([
            render(torch.tensor(p, device=dev), aux)["rgb"] for p in poses])
    return dataset_from_arrays(images, poses, intr, near, far, n_val=2)


def phase_train(fx, dev, quick: bool, dataset, profile: bool):
    """Trainer.fit from a seeded fresh state at the flagship configuration,
    then validation, a checkpoint round trip and the launch counts."""
    import tempfile

    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as logdir:
        cfg, steps = _train_config(fx, logdir, quick)
        n_rays = cfg.nerf.num_random_rays
        trainer = Trainer(cfg, dataset)  # device=None: the card
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        # ---- the main path ---------------------------------------------
        t0 = time.perf_counter()
        res = trainer.fit(state=state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = dict(cuda_lib.LAUNCHES)
        # -----------------------------------------------------------------
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        val = trainer.validate(res.state)
        split = trainer.evaluate_split(res.state, "val")
        trainer.save_checkpoint(res.state, steps, res.last_metrics)
        fresh = trainer.engine.init_state(seed=99)
        back, at = trainer.ckpt.restore(fresh, layout=trainer.engine.layout)
        same = at == steps and all(torch.equal(a, b) for a, b in (
            (back.params, res.state.params),
            (back.opt_state.mu, res.state.opt_state.mu),
            (back.opt_state.nu, res.state.opt_state.nu),
            (back.opt_state.count, res.state.opt_state.count),
            (back.step, res.state.step),
            (back.aux.density, res.state.aux.density),
            (back.generator.get_state(), res.state.generator.get_state())))
        parts = time_step_parts(trainer, res.state)
        prof = profile_steps(trainer, res.state) if profile else None
        trainer.close()

    losses = np.asarray(res.losses)
    first, last = float(losses[:16].mean()), float(losses[-64:].mean())
    ms_per_step = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
    refreshes = [(i, kind, sec * 1e3) for i, kind, sec in res.occupancy_refreshes]
    report = {
        "phase": "train", "quick": quick, "steps": steps, "rays_per_step": n_rays,
        "views": [len(dataset.train_idx), len(dataset.val_idx)],
        "size": [dataset.H, dataset.W],
        "loss_first16": first, "loss_last64": last,
        "train_psnr_last64": float(-10 * np.log10(max(last, 1e-12))),
        "val_psnr_db": val["val_psnr"], "val_mean_psnr_db": split["mean_psnr"],
        "val_psnr_floor_db": VAL_PSNR_FLOOR_DB,
        "ms_per_step": ms_per_step, "rays_per_s": n_rays / ms_per_step * 1e3,
        "fit_seconds": fit_s, "chunks": [[k, s] for k, s in res.chunk_seconds],
        "occupancy_refreshes_ms": refreshes, "launches": counts,
        "checkpoint_round_trip": same, "peak_memory_gib": peak_gb, **parts,
    }
    if prof is not None:
        report["profile"] = prof
    emit(report)
    if not (np.isfinite(losses).all() and np.isfinite(val["val_psnr"])):
        raise AssertionError("train: non-finite loss or PSNR")
    # One row-7, one row-2 and one hull launch per step, none of rows 5 and 6.
    # fit ends with the mean over the held-out views: each chunk of such a
    # frame launches the hull, the density-only and the full forward once.
    evals = counts["ngp_fused_apply_cf"]
    want = {"ngp_fused_train_cf": steps, "ngp_fused_sigma_cf": steps + evals,
            "occupancy_at_hull": steps + evals, "ngp_fused_apply_cf_bwd": 0,
            "cp_encode_bwd": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"train: launches {got}, expected {want}")
    if counts["cp_encode"] <= 0:
        raise AssertionError("train: the occupancy refreshes launched no cp_encode")
    kinds = [kind for _, kind, _ in refreshes]
    if kinds != ["full", "incremental", "incremental"]:
        raise AssertionError(f"train: occupancy refreshes {kinds}")
    # a quick run is too short to ask for more than a falling loss
    if not last < (1.0 if quick else 0.25) * first:
        raise AssertionError(f"train: loss {first} -> {last}, not under a quarter")
    if not quick and not val["val_psnr"] >= VAL_PSNR_FLOOR_DB:
        raise AssertionError(
            f"train: held-out PSNR {val['val_psnr']:.2f} dB under the floor "
            f"{VAL_PSNR_FLOOR_DB} dB")
    if not same:
        raise AssertionError("train: the restored state differs from the saved one")
    return counts


def time_step_parts(trainer, state):
    """CUDA-event medians of two parts of the step that a profile by kernel
    name cannot tell from the other PyTorch ops: the coarse proposal (pair
    projections, hull kernel, inverse CDF) and the Adam update."""
    from nerf_kinematics_tpu_torch.train.loop import adam_update, lr_schedule

    eng, cfg, ds = trainer.engine, trainer.cfg, trainer.dataset
    n = cfg.nerf.num_random_rays
    rays_o, rays_d = trainer.ray_buf["rays_o"][:n], trainer.ray_buf["rays_d"][:n]
    prop = eng.proposal_for(state.aux, ds.near, ds.far, cfg.nerf.train,
                            state.generator)
    with torch.no_grad():
        proposal_ms = time_ms(lambda: prop(rays_o, rays_d), 20, 3)
        st = state.clone()
        grads = torch.randn_like(st.params) * 1e-3
        mask = eng.layout.decay_mask(st.params.device)
        sched = lr_schedule(cfg)
        adam_ms = time_ms(
            lambda: adam_update(st.params, grads, st.opt_state, sched, mask), 20, 3)
    return {"coarse_proposal_ms": proposal_ms, "adam_ms": adam_ms}


def profile_steps(trainer, state, n_steps: int = 10):
    """torch.profiler over ``n_steps`` train steps: device time by kernel
    group, the top operations and the device's idle share of the window."""
    from torch.profiler import ProfilerActivity, profile

    step = trainer._train_step
    args = (trainer.images, trainer.poses, trainer.ray_buf)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's own start-up, thrown away
        for _ in range(3):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"hull proposal (row 1)": ("nkt_hull",),
              "coarse density (row 2)": ("nkt_fused_sigma",),
              "fused train objective (row 7)": (
                  "nkt_fused_apply_save", "nkt_train_rays", "nkt_fused_point_bwd",
                  "nkt_wgrad", "nkt_reduce_partials")}
    by_group = {k: 0.0 for k in groups}
    by_group["PyTorch ops (sampling, compositing, gathers, Adam)"] = 0.0
    kernels = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if not dev_us or "cuda" not in str(getattr(e, "device_type", "cuda")).lower():
            continue
        kernels.append((e.key, dev_us / 1e3, e.count))
        for g, keys in groups.items():
            if any(k in e.key for k in keys):
                by_group[g] += dev_us / 1e3
                break
        else:
            by_group["PyTorch ops (sampling, compositing, gathers, Adam)"] += dev_us / 1e3
    busy_ms = sum(by_group.values())
    kernels.sort(key=lambda t: -t[1])
    return {
        "steps": n_steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms else None,
        "ms_per_step_by_group": {k: v / n_steps for k, v in by_group.items()},
        "top": [{"name": k[:80], "ms_per_step": ms / n_steps, "calls": c}
                for k, ms, c in kernels[:12]],
    }


def phase_train_autodiff(fx, dev, quick: bool, dataset):
    """One step of each of the three routes from the same initial state and
    the same draws; then 16 steps of each autograd route for a time."""
    import dataclasses
    import tempfile

    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.loop import (
        build_objective, build_shuffled_ray_buffer)
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    routes = {"fused_train": {}, "fused_train_off": {"fused_train": "off"},
              "fused_off": {"fused": "off"}}
    near, far = dataset.near, dataset.far
    imgs, poses = dataset.split("train")
    images = torch.as_tensor(imgs, device=dev)
    poses = torch.as_tensor(poses, device=dev)
    buf = build_shuffled_ray_buffer(images, poses, dataset.intrinsics, seed=3)
    gen = torch.Generator(device=dev).manual_seed(11)
    report = {"phase": "train_autodiff", "quick": quick}
    cuda_lib.reset_launch_counts()
    with tempfile.TemporaryDirectory() as logdir:
        for mode in ("f32", "bf16"):
            kw = {} if mode == "bf16" else {"compute_dtype": "float32"}
            out = {}
            u_c = u_f = batch = None
            for name, route in routes.items():
                cfg, _ = _train_config(fx, logdir, quick, **route, **kw)
                if mode == "f32":
                    cfg = cfg.replace(ngp=_replace_cp(cfg.ngp, use_bf16=False))
                eng = NGPEngine(cfg, 1.0)
                state = eng.init_state(seed=5)
                state.aux = grid_from_numpy(fx.grid_density, fx.grid_bound, device=dev)
                n_rays = cfg.nerf.num_random_rays
                if batch is None:
                    sl = slice(1000, 1000 + n_rays)
                    d = buf["rays_d"][sl]
                    batch = (buf["rays_o"][sl], d,
                             d / torch.linalg.norm(d, dim=-1, keepdim=True),
                             buf["target"][sl])
                    t = cfg.nerf.train
                    u_c = torch.rand((n_rays, t.num_coarse), generator=gen, device=dev)
                    u_f = torch.rand((n_rays, t.num_fine), generator=gen, device=dev)
                (loss, (loss_c, _)), grads = build_objective(eng, near, far)(
                    batch, state.aux, state.generator, u_coarse=u_c, u_fine=u_f)
                torch.cuda.synchronize()
                out[name] = (float(loss), float(loss_c), grads, eng, state, cfg)
            ref = out["fused_train"]
            rep = {}
            for name in ("fused_train_off", "fused_off"):
                loss, loss_c, grads, *_ = out[name]
                worst = 0.0
                for k, g in ref[2].items():
                    scale = g.abs().max().item()
                    if scale == 0.0 or not torch.isfinite(grads[k]).all():
                        raise AssertionError(f"train_autodiff: bad gradient leaf {k}")
                    worst = max(worst, (grads[k] - g).abs().max().item() / scale)
                rep[name] = {"loss": loss, "loss_coarse": loss_c,
                             "grad_max_rel": worst,
                             "loss_rel": abs(loss - ref[0]) / abs(ref[0])}
                tol = ROUTE_TOL[mode]
                loss_tol = 1e-4 if mode == "f32" else 1e-3
                if mode == "bf16" and name == "fused_off":
                    tol, loss_tol = UNFUSED_BF16_TOL, 5e-2
                # the unfused coarse pass has colors: its loss_coarse is
                # another quantity than the density-only pass's
                same_c = name == "fused_off" or \
                    abs(loss_c - ref[1]) <= 1e-4 * abs(ref[1])
                if not (worst <= tol and rep[name]["loss_rel"] <= loss_tol
                        and same_c):
                    raise AssertionError(
                        f"train_autodiff ({mode}): route {name} disagrees with the "
                        f"fused objective: {rep[name]} (tolerance {tol}, loss {loss_tol})")
            rep["fused_train"] = {"loss": ref[0], "loss_coarse": ref[1]}
            report[mode] = rep
        # ---- time per step of the two autograd routes (shipped types) ----
        times = {}
        for name in ("fused_train_off", "fused_off"):
            _, _, _, eng, state, cfg = out[name]
            step = eng.make_train_step(dataset.intrinsics, near, far, False)
            for _ in range(2):
                state, _ = step(state, images, poses, buf)
            _, ms = timed(lambda: [step(state, images, poses, buf) for _ in range(16)])
            times[name] = ms / 16
        counts = dict(cuda_lib.LAUNCHES)
    report["ms_per_step"] = times
    report["launches"] = counts
    report["tolerance"] = {
        "gradients across routes, per leaf, max abs over the leaf's largest entry":
            ROUTE_TOL, "unfused route in bf16 mode": UNFUSED_BF16_TOL}
    emit(report)
    for k in ("ngp_fused_apply_cf_bwd", "cp_encode_bwd", "ngp_fused_train_cf"):
        if counts[k] <= 0:
            raise AssertionError(f"train_autodiff: {k} was not launched")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="1/16 of the points and 100x100 frames")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says of each kernel")
    ap.add_argument("--profile", action="store_true",
                    help="after training, trace ten more steps with torch.profiler")
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of: " + ", ".join(PHASES)
                    + " (default: all; a subset prints no result line)")
    args = ap.parse_args(argv)
    phases = PHASES if args.phases == "all" else tuple(args.phases.split(","))
    unknown = [p for p in phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phases {unknown}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2

    from nerf_kinematics_tpu_torch.io.fixture import read_fixture
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    t_start = time.perf_counter()
    torch.manual_seed(1234)
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    cuda_lib.load_library(verbose=args.verbose_build)
    emit({"phase": "build", "seconds": cuda_lib.BUILD_INFO["seconds"],
          "cached": cuda_lib.BUILD_INFO["cached"],
          "flags": cuda_lib.NVCC_FLAGS})

    fx = read_fixture()
    rows = []
    with torch.no_grad():
        if "kernels" in phases:
            rows += phase_kernels(fx, dev, args.quick, KERNEL_REPS)
        if "grad_kernels" in phases:
            rows += phase_grad_kernels(fx, dev, args.quick, KERNEL_REPS)
    # Launches on the main path: every path is driven with the counts at 0
    # just before it and read just after; a kernel's figure is their sum.
    counts = dict.fromkeys(cuda_lib.LAUNCHES, 0)

    def add(phase_counts):
        for k, v in phase_counts.items():
            counts[k] += v

    engine = aux = dataset = None
    if {"serve", "golden", "train", "train_autodiff"} & set(phases):
        with torch.no_grad():
            serve_counts, engine, aux = phase_serve(fx, dev, args.quick)
            add(serve_counts)
            if "golden" in phases:
                phase_golden(fx, engine, aux)
    if {"train", "train_autodiff"} & set(phases):
        dataset = build_dataset(fx, engine, aux, dev, args.quick)
    if "train" in phases:
        add(phase_train(fx, dev, args.quick, dataset, args.profile))
    if "train_autodiff" in phases:
        add(phase_train_autodiff(fx, dev, args.quick, dataset))
    if phases != PHASES:
        emit({"phase": "total", "seconds": time.perf_counter() - t_start,
              "partial": list(phases)})
        return 3

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']}: not launched on the main path")
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
