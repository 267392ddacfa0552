#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as a checker runs it
    python3 chip_smoke.py --quick    # small shapes: build, launch, compare

Builds the CUDA kernels from ``nerf_kinematics_tpu_torch/csrc`` (first use),
holds each kernel against its plain PyTorch version on the card at the shapes
the serving path gives it, drives the serving path of the ``machina_ngp``
model (trained weights from the fixture, 400x400 frames) through the engine's
entry points, and holds the port's renders against the golden renders the
JAX package produced from the same weights.

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
            params, c = eng._fused_params(), eng.ngp_config.cp
            k, p = kern(params, c), plain(params, c)
            torch.cuda.synchronize()
            if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
                raise AssertionError(f"{name}: non-finite output")
            mx, mean, rel = fused_errors(k, p, color)
            worst = {"max": max(worst["max"], mx), "mean": max(worst["mean"], mean),
                     "rel": max(worst["rel"], rel)}
            del k, p
        # f32 mode: no bf16 rounding, so only the order of the sums differs.
        params, c = f32_eng._fused_params(), f32_eng.ngp_config.cp
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
        params = trained._fused_params()
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
    missing = [k for k, v in counts.items() if v <= 0]
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="1/16 of the points and 100x100 frames")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print what ptxas says of each kernel")
    args = ap.parse_args(argv)

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
    rows = phase_kernels(fx, dev, args.quick, KERNEL_REPS)
    counts, engine, aux = phase_serve(fx, dev, args.quick)
    phase_golden(fx, engine, aux)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in rows:
        r["launches"] = counts[r["name"]]
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
