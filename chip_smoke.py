#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # everything, as a checker runs it
    python3 chip_smoke.py --quick    # small shapes: build, launch, compare

Builds the CUDA kernels from ``nerf_kinematics_tpu_torch/csrc`` (first use),
holds each kernel against its plain PyTorch version on the card at the shapes
the main paths give it, and drives the main paths of both engines at full
width through the entry points a user calls:

  * serving (``machina_ngp``): 400x400 frames from the fixture's trained
    weights (fast renderer, the compacted recipe, the evaluation renderer, a
    full occupancy sweep, the density grid), held against the golden renders
    the JAX package produced from the same weights;
  * training (``machina_ngp``): ``Trainer.fit`` for 768 steps of the
    flagship configuration from a seeded fresh state, on views the port
    renders from the trained weights, then validation on held-out views and
    a checkpoint round trip; one step of each of the three gradient routes
    from the same state and draws, which must agree;
  * the classic engine (``machina_classic``): ``Trainer.fit`` for 1000 steps
    on 200x200 views, held-out PSNR, both held-out views rendered through the
    fused kernel and through its plain version, one step of the fused and of
    the module gradient route, a checkpoint and a legacy round trip;
  * training from the images on disk (``machina_ngp``, ``ngp.fused_train:
    full``): the port generates machina400, ``Trainer(cfg)`` loads it and
    fits 2048 steps from the JAX package's seed-42 initial weights, one
    whole-step kernel launch a step; ground-truth PSNR of the held-out views
    beside the canonical run's; one step of the whole-step route, of the
    two-call route and of row 8's plain version from one state and one set
    of draws; from the trained state, one step through the kernels against
    the same step through rows 7 and 8's plain versions as Adam takes it,
    beside one-ulp controls;
  * ``configs/fox_ngp.yml`` at full width on the halo scene (the stand-in
    for fox49, whose images are not in the repository: 49 views of 128x128
    generated on the card, aabb_scale 32, so the scene is contracted):
    ``Trainer.fit`` for 1000 steps of the shipped recipe (rows 1, 3-6; it
    falls dark, as its plain versions and the JAX package's route do, and
    is held to its plain versions step for step through the fall), 1000
    with ``ngp.fused: off`` (rows 4, 5), 300 with ``encoder: hash`` at the
    reference-exact grid (two steps from one state bit-identical), 50 of
    the contracted two-call step (rows 2, 7), and a 256^3 mesh by the
    native core, held to its numpy version; rows 2, 3, 6 and 7 in f32
    mode at fox's encoder against their plain versions, the f32 route's
    first 40 steps step for step against rows 3 and 6's plain versions, and
    the hash encoder on a NaN coordinate against the CPU;
  * the robot path: two forward-kinematics captures written on the card
    from the machina field on a table at the D405's 1280x720 (a ring of 48
    poses; a slide of 11 poses looking down, the wheel capture's
    geometry), converted by ``cli/parse_poses.py`` and diagnosed by the
    parallax metrics; ``configs/wheel_ngp.yml`` on the ring (rows 1, 2, 4,
    7) and ``configs/wheel_robot.yml`` (classic, NDC: rows 9, 10) on the
    slide from the robot loader, each against a constant image; and
    ``cli/full_pipeline.py`` on both (the low-parallax warning on the
    slide only);
  * the other pose sources: a COLMAP text model of the ring's known poses
    through ``cli/colmap2nerf.py`` (the poses back up to one similarity),
    the bundle adjustment at a fox49-sized problem (49 cameras, 5000
    points, 3000 iterations on the card, the focal-optimising call held
    against the same call on the CPU), the SfM front-end
    (``cli/sfm2nerf.py``) where cv2 imports, on the ring's poses over
    tests/test_sfm.py's sprite scene, and photometric refinement of a
    perturbed held-out pose and of five perturbed training poses against
    the ring's ``wheel_ngp`` field (row 1 places every step's samples);
  * the command lines on machina400, with ``configs/*.yml`` read by the
    port's own YAML reader: ``cli/ngp_run.py`` trains 512 steps from
    ``configs/machina_ngp.yml``, saves a snapshot, reloads it (the val PSNR
    must not move), renders screenshots and writes a 256^3 mesh from it,
    and trains the hash encoder 512 steps to a PSNR floor;
    ``cli/run_nerf.py`` trains ``configs/machina_classic.yml`` (seed 7)
    200 steps to a PSNR floor, evaluates and renders its video, trains
    ``configs/synthetic_smoke.yml`` 300 steps on the synthetic sphere, and
    renders the fast engine's ``--fast`` video from the ``ngp_run``
    checkpoint;
  * the port's bench (``python -m nerf_kinematics_tpu_torch.bench``) on the
    same scene: rays/s, MFU, time to 25 dB, frame rates;
  * the grid and projected occupancy proposals: ``configs/machina_ngp.yml``
    with ``ngp.occ_proposal`` hull, grid and projected, 512 steps each from
    the train phase's start, each against a constant image, and the three
    grid lookups on the card against the CPU at 524 288 points, non-finite
    points included;
  * data parallelism (``parallel/``) on the one card: a step through an
    NCCL group of world 1, bit for bit the step without a group; two ranks
    over gloo on cuda:0 (started by this script with ``--mesh-rank``)
    against one process: 512 steps of machina_ngp.yml (step 1, the refresh
    at 256 and the step after it from the ranks' state, the loss curve
    beside five one-process controls from weights nudged by one ulp), 100
    of machina_classic.yml (rows 9, 10), the frame batch split over the
    ranks; and ``torchrun --nproc_per_node 2 -m
    nerf_kinematics_tpu_torch.cli.run_nerf --mesh`` on machina400 (512
    steps, then the ``--fast`` video, against one process's render of the
    same checkpoint).

The kernel phases also hold every kernel to its plain version on non-finite
inputs (the cases of tests/test_torch_nonfinite.py, and row 1 on NaN and
+-inf points: equal NaN, +inf and -inf masks), time row 1 at the two-call
step's 524 288 points too, launch each gradient kernel (rows 5-8, 10) twice
on the same inputs
and require the same bits, split row 10 by kernel beside a cuBLAS f32
yardstick, and the ``scene`` phase takes the whole step twice from one state
and requires the same parameters.

It prints one JSON object per phase, then a ``{"kernels": [...]}`` line (with
each kernel's points on the main paths by the body that ran, and their time
at that body's ns a point measured here, beside the bound), the card's name
and power limit as ``nvidia-smi`` gives them, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the process
exits non-zero and prints no result line. It needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (dense): the roofline a bound is taken from,
# and the bench's MFU. "f32x3": f32 work on the tensor cores in 3xTF32, three
# TF32 products for each f32 one (the classic kernels' f32 mode).
from nerf_kinematics_tpu_torch.bench import nvidia_smi_line
from nerf_kinematics_tpu_torch.utils.flops import PEAK_BYTES_PER_S, PEAK_FLOPS

PHASES = ("kernels", "grad_kernels", "serve", "golden", "train", "train_autodiff",
          "classic", "halo", "robot", "poses", "scene", "cli", "bench", "proposals",
          "mesh")

KERNEL_REPS = 5        # timed launches per kernel (median), after 2 warm-ups

FUSED_MEAN_TOL = 2e-4  # mean |kernel - plain| of rgb logits and of log sigma
FUSED_MAX_TOL = 0.25   # largest single difference of the same


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int, flush=None, clean: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` launches (CUDA events),
    after ``warmup`` launches, with the L2 cache overwritten in between:
    by writing ``flush`` (the L2 then holds dirty lines, which a kernel that
    streams more than the cache pays to write back), or with ``clean`` by
    reading it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None and clean:
            flush.sum()
        elif flush is not None:
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


def other_cp_configs():
    """CP encoders other than the flagship's, for rows 4 and 5: fox_ngp.yml's
    (C = 96, T = 256, five levels: its three f32 tables of a level exceed a
    block's shared memory, so the kernels split the channels, and row 5 the
    16 row tiles too) with the hash fold, and a narrow one (C = 40, padded to
    48 in row 5's B operand), each in both modes."""
    from nerf_kinematics_tpu_torch.ops.cp_grid import CPGridConfig

    out = []
    for bf in (True, False):
        out.append(CPGridConfig(n_levels=5, n_components=96, table_size=256,
                                base_resolution=16, max_resolution=2048,
                                use_bf16=bf, fold="hash"))
        out.append(CPGridConfig(n_levels=3, n_components=40, table_size=64,
                                base_resolution=16, max_resolution=256,
                                use_bf16=bf))
    return out


def cp_label(c) -> str:
    return (f"L{c.n_levels} C{c.n_components} T{c.table_size} {c.fold} "
            f"{'bf16' if c.use_bf16 else 'f32'}")


# ---- non-finite inputs --------------------------------------------------
# The cases of tests/test_torch_nonfinite.py, where the plain versions are
# held to the Pallas kernels' NaN, +inf and -inf masks on the CPU: here each
# kernel must give exactly its plain version's masks (finite entries are held
# to their tolerances by the finite cases above). Small shapes: the plain
# versions' rare paths are slow.
NONFINITE_POINTS = 4096
POINT_CASES = ("nan_point", "inf_point")
PARAM_CASES = ("nan_weight", "nan_line")
COT_CASES = ("nan_cot", "inf_cot")


def spoil(case, xt=None, params=None, g=None, w_key="dW"):
    """Copies of the inputs with the case's entry non-finite: a NaN
    coordinate; a +inf and a -inf one; a NaN weight; a NaN entry of a
    line-table row the reference contracts over; a NaN, and a +inf and a
    -inf, cotangent entry. ``xt``: (3, n) points or ray origins; ``g``:
    (points, channels) (a transposed view where the cotangent is
    channels-first)."""
    nan, inf = float("nan"), float("inf")
    if case in POINT_CASES:
        xt = xt.clone()
        if case == "nan_point":
            xt[0, 3] = nan
        else:
            xt[1, 5], xt[2, 7] = inf, -inf
    elif case in PARAM_CASES:
        params = dict(params)
        if case == "nan_weight":
            params[w_key] = list(params[w_key])
            params[w_key][1] = params[w_key][1].clone()
            params[w_key][1][2, 5] = nan
        else:
            params["lines"] = params["lines"].clone()
            params["lines"][1, 2, 5, 3] = nan
    elif case in COT_CASES:
        g = g.clone()
        if case == "nan_cot":
            g[3, 2] = nan
        else:
            g[3, 2], g[7, 1] = inf, -inf
    else:
        raise ValueError(case)
    return xt, params, g


def nonfinite_classes(t):
    """0 finite, 1 NaN, 2 +inf, 3 -inf."""
    c = torch.zeros(t.shape, dtype=torch.int8, device=t.device)
    c[torch.isnan(t)] = 1
    c[t == float("inf")] = 2
    c[t == float("-inf")] = 3
    return c


def same_masks(what, pairs) -> int:
    """``pairs``: (label, kernel tensor, plain tensor). Raises where a NaN,
    +inf or -inf mask differs; returns the non-finite entries."""
    total = 0
    for label, k, p in pairs:
        ck, cp_ = nonfinite_classes(k), nonfinite_classes(p)
        if not torch.equal(ck, cp_):
            count = lambda c: [int((c == i).sum()) for i in (1, 2, 3)]
            raise AssertionError(
                f"{what} {label}: NaN / +inf / -inf masks differ: kernel "
                f"{count(ck)}, plain {count(cp_)}")
        total += int((cp_ != 0).sum())
    return total


def nonfinite_report(name, runs) -> dict:
    """``runs``: {case label: non-finite entries}. A case that gave no
    non-finite entry is only allowed for the inf coordinate (it clamps)."""
    quiet = [c for c, v in runs.items() if v == 0 and "inf_point" not in c]
    if quiet:
        raise AssertionError(f"{name}: cases without a non-finite entry: {quiet}")
    return {"cases": len(runs), "nonfinite_entries": sum(runs.values())}


def hash_nan_cases(xt0, gen, dev):
    """fox_ngp.yml's hash-folded encoder (``other_cp_configs``) in both
    modes, with a NaN coordinate: ``(config, lines, x (n, 3), g)``. There
    the reference's tent of the NaN is NaN on one hashed row only."""
    x = spoil("nan_point", xt0)[0].T.contiguous()
    for c in other_cp_configs():
        if c.fold == "hash":
            lines = 0.5 + 0.3 * torch.randn((c.n_levels, 3, c.table_size, c.n_components),
                                            generator=gen, device=dev)
            g = torch.randn((x.shape[0], c.out_dim), generator=gen, device=dev)
            yield c, lines, x, g


def nonfinite_forwards(engines, dev) -> dict:
    """Rows 2, 3 and 4 (both modes) and row 9 (both modes, its 3xTF32 and
    FMA bodies) on the non-finite cases."""
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import cp_encode_cuda, cp_encode_cuda_ref
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_ref, ngp_fused_sigma_cf,
        ngp_fused_sigma_cf_ref)

    gen = torch.Generator(device=dev).manual_seed(4242)
    xt0, vd = random_points(NONFINITE_POINTS, gen, dev)
    runs = {"ngp_fused_sigma_cf": {}, "ngp_fused_apply_cf": {}, "cp_encode": {}}
    for mode, eng in engines.items():
        prm0, c = eng._fused_params(detach=True), eng.ngp_config.cp
        for case in POINT_CASES + PARAM_CASES:
            xt, prm, _ = spoil(case, xt0, prm0)
            key = f"{mode} {case}"
            runs["ngp_fused_sigma_cf"][key] = same_masks("ngp_fused_sigma_cf " + key, [
                ("out", ngp_fused_sigma_cf(prm, xt, c), ngp_fused_sigma_cf_ref(prm, xt, c))])
            runs["ngp_fused_apply_cf"][key] = same_masks("ngp_fused_apply_cf " + key, [
                ("out", ngp_fused_apply_cf(prm, xt, vd, c),
                 ngp_fused_apply_cf_ref(prm, xt, vd, c))])
            if case != "nan_weight":
                x = xt.T.contiguous()
                runs["cp_encode"][key] = same_masks("cp_encode " + key, [
                    ("encoding", cp_encode_cuda(prm["lines"], x, c),
                     cp_encode_cuda_ref(prm["lines"], x, c))])
    for c, lines, x, _ in hash_nan_cases(xt0, gen, dev):
        key = f"{'bf16' if c.use_bf16 else 'f32'} hash nan_point"
        runs["cp_encode"][key] = same_masks("cp_encode " + key, [
            ("encoding", cp_encode_cuda(lines, x, c), cp_encode_cuda_ref(lines, x, c))])
    runs["classic_fused_apply_cf"] = {}
    xc0, vc = classic_points(NONFINITE_POINTS, gen, dev)
    for mode, eng in classic_engines(dev).items():
        mcfg = eng.cfg.model_coarse
        prm0 = {k: [t.detach() for t in v]
                for k, v in eng._fused_params(eng.model_coarse).items()}
        for case in POINT_CASES + ("nan_weight",):
            xc, prm, _ = spoil(case, xc0, prm0, w_key="W")
            p = cfc.classic_fused_apply_cf_ref(prm, xc, vc, mcfg)
            for body, tc in (("3xtf32", True), ("fma", False)):
                key = f"{mode} {body} {case}"
                runs["classic_fused_apply_cf"][key] = same_masks(
                    "classic_fused_apply_cf " + key,
                    [("out", cfc._forward(prm, xc, vc, mcfg, tc=tc), p)])
    torch.cuda.synchronize()
    return {name: nonfinite_report(name, r) for name, r in runs.items()}


def nonfinite_grads(fx, engines, dev) -> dict:
    """Rows 5, 6, 7, 8 and 10, both modes, on the non-finite cases (rows 7
    and 8 take their cotangent from their own loss; row 8's coordinate cases
    set a ray's origin)."""
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
        cp_encode_cuda_bwd, cp_encode_cuda_bwd_ref)
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf_bwd, ngp_fused_apply_cf_bwd_ref, ngp_fused_train_cf,
        ngp_fused_train_cf_ref, ngp_fused_train_full_cf, ngp_fused_train_full_cf_ref)
    from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections

    gen = torch.Generator(device=dev).manual_seed(4343)
    n = NONFINITE_POINTS
    xt0, vd = random_points(n, gen, dev)
    cp = fx.config.ngp.cp
    g_enc0 = torch.randn((n, cp.out_dim), generator=gen, device=dev)
    g40 = torch.randn((4, n), generator=gen, device=dev)
    ngp, t = fx.config.ngp, fx.config.nerf.train
    S, Sc, NB, R = t.num_fine, t.num_coarse, ngp.occ_bins, 128
    o0, d, vr, tgt, uc, uf = full_step_inputs(R, S, Sc, gen, dev)
    xr, vrr = random_points(R * S, gen, dev)
    z = 2.0 + 4.0 * torch.sort(torch.rand((R, S), generator=gen, device=dev), dim=-1).values
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)], -1)
    dists = dists.reshape(1, R * S).contiguous()
    proj2 = pair_projections(grid_from_numpy(fx.grid_density, fx.grid_bound,
                                             device=dev)).contiguous()
    near, far, inv = fx.config.dataset.near, fx.config.dataset.far, 1.0 / (3.0 * R)
    leaves = lambda k, p: [(n_, a, b) for (n_, a), (_, b) in zip(_leaf_list(k), _leaf_list(p))]
    names = ("cp_encode_bwd", "ngp_fused_apply_cf_bwd", "ngp_fused_train_cf",
             "ngp_fused_train_full_cf", "classic_fused_apply_cf_bwd")
    runs = {k: {} for k in names}
    for mode, eng in engines.items():
        prm0, c = eng._fused_params(detach=True), eng.ngp_config.cp
        for case in POINT_CASES + PARAM_CASES + COT_CASES:
            key = f"{mode} {case}"
            xt, prm, g_enc = spoil(case, xt0, prm0, g_enc0)
            if case != "nan_weight":
                x = xt.T.contiguous()
                runs["cp_encode_bwd"][key] = same_masks("cp_encode_bwd " + key, [
                    ("dlines", cp_encode_cuda_bwd(prm["lines"], x, g_enc, c),
                     cp_encode_cuda_bwd_ref(prm["lines"], x, g_enc, c))])
            _, _, g4t = spoil(case, None, None, g40.T) if case in COT_CASES else (0, 0, g40.T)
            g4 = g4t.T.contiguous()
            runs["ngp_fused_apply_cf_bwd"][key] = same_masks(
                "ngp_fused_apply_cf_bwd " + key,
                leaves(ngp_fused_apply_cf_bwd(prm, xt, vd, g4, c),
                       ngp_fused_apply_cf_bwd_ref(prm, xt, vd, g4, c)))
            if case in COT_CASES:
                continue
            xs, _, _ = spoil(case, xr) if case in POINT_CASES else (xr, 0, 0)
            ek, mk, k = ngp_fused_train_cf(prm, xs, vrr, dists, tgt, c, S, True, inv)
            ep, mp, p = ngp_fused_train_cf_ref(prm, xs, vrr, dists, tgt, c, S, True, inv)
            runs["ngp_fused_train_cf"][key] = same_masks(
                "ngp_fused_train_cf " + key, [("err", ek, ep), ("maps", mk, mp)] + leaves(k, p))
            o = spoil(case, o0)[0] if case in POINT_CASES else o0
            args = (o, d, vr, tgt, uc, uf, proj2, c, S, Sc, NB, True, inv, near, far,
                    1.0, ngp.occ_floor)
            k = ngp_fused_train_full_cf(prm, *args)
            p = ngp_fused_train_full_cf_ref(prm, *args)
            runs["ngp_fused_train_full_cf"][key] = same_masks(
                "ngp_fused_train_full_cf " + key,
                [("err", k[0], p[0]), ("maps", k[1], p[1]), ("err_c", k[2], p[2])]
                + leaves(k[3], p[3]))
    for c, lines, x, g in hash_nan_cases(xt0, gen, dev):
        key = f"{'bf16' if c.use_bf16 else 'f32'} hash nan_point"
        runs["cp_encode_bwd"][key] = same_masks("cp_encode_bwd " + key, [
            ("dlines", cp_encode_cuda_bwd(lines, x, g, c),
             cp_encode_cuda_bwd_ref(lines, x, g, c))])
    xc0, vc = classic_points(n, gen, dev)
    for mode, eng in classic_engines(dev).items():
        mcfg = eng.cfg.model_coarse
        prm0 = {k: [t.detach() for t in v]
                for k, v in eng._fused_params(eng.model_coarse).items()}
        for case in POINT_CASES + ("nan_weight",) + COT_CASES:
            xc, prm, g4t = spoil(case, xc0, prm0, g40.T, w_key="W")
            g4 = g4t.T.contiguous()
            k = cfc.classic_fused_apply_cf_bwd(prm, xc, vc, g4, mcfg)
            p = cfc.classic_fused_apply_cf_bwd_ref(prm, xc, vc, g4, mcfg)
            runs["classic_fused_apply_cf_bwd"][f"{mode} {case}"] = same_masks(
                f"classic_fused_apply_cf_bwd {mode} {case}",
                [(f"{key}[{i}]", a, b) for key in ("W", "b")
                 for i, (a, b) in enumerate(zip(k[key], p[key]))])
    torch.cuda.synchronize()
    return {name: nonfinite_report(name, r) for name, r in runs.items()}


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
    # non-finite points: a NaN in one or two coordinates (each pair that
    # reads it gives 0, as the reference's all-zero one-hot row does), +-inf
    # (the end cells); the kernel and the plain version agree exactly
    xt_nf = random_points(4096, gen, dev)[0].clone()
    nan, inf = float("nan"), float("inf")
    for i, axes in enumerate(((0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2))):
        xt_nf[list(axes), i::8] = nan
    xt_nf[0, 7::16], xt_nf[1, 15::16], xt_nf[2, 7::24] = inf, -inf, -inf
    err = 0.0
    for proj in (proj_t, proj_r):
        for pts in (xt, xt_nf):
            k = occupancy_at_hull_cuda(proj, pts)
            torch.cuda.synchronize()
            p = occupancy_at_hull_cuda_ref(proj, pts)
            torch.cuda.synchronize()
            if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
                raise AssertionError("occupancy_at_hull: non-finite output")
            err = max(err, (k - p).abs().max().item())
    if err != 0.0:
        raise AssertionError(f"occupancy_at_hull: max abs err {err} != 0 "
                             "(finite, NaN and inf points)")
    # projections whose bf16 copy does not fit a block's shared memory
    try:
        occupancy_at_hull_cuda(torch.zeros((3, 197, 197), device=dev), xt_nf)
    except ValueError:
        pass
    else:
        raise AssertionError("occupancy_at_hull: R = 197 was not refused")
    b, by = bound_ms(n_hull * 16 + proj_t.numel() * 4, n_hull * 12, "f32")
    # also at the two-call step's launch (8192 rays x 64 bins), and at 4096
    # points, where the time is the launch and the table's staging
    # (each also after an L2 that holds clean lines: ms_clean_l2)
    at = {}
    for m in (8192 * 64 // shrink, 4096):
        xm = xt[:, :m].contiguous()
        run = lambda xm=xm: occupancy_at_hull_cuda(proj_t, xm)
        at[str(m)] = {
            "ms": time_ms(run, reps, 2, flush),
            "ms_clean_l2": time_ms(run, reps, 2, flush, clean=True),
            "bound_ms": bound_ms(m * 16 + proj_t.numel() * 4, m * 12, "f32")[0]}
    rows.append({
        "name": "occupancy_at_hull", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/occupancy_hull.cu",
        "replaces": "nerf_kinematics_tpu/ops/occupancy_pallas.py:68",
        "n_points": n_hull, "max_abs_err": err, "max_rel_err": 0.0,
        "nonfinite_points": int(xt_nf.shape[1]),
        "tolerance": "exact (also on NaN and +-inf points)",
        "ms": (ms := time_ms(lambda: occupancy_at_hull_cuda(proj_t, xt), reps, 2, flush)),
        "ms_by_body": {"kernel": ms}, "ms_at_other_sizes": at,
        "ms_clean_l2": time_ms(lambda: occupancy_at_hull_cuda(proj_t, xt), reps, 2, flush,
                               clean=True),
        # the same timing of a one-element add: the launch and the events
        "launch_floor_ms": time_ms(lambda t=torch.zeros(1, device=dev): t.add_(1.0),
                                   reps, 2, flush, clean=True),
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
    other, gen_o = {}, torch.Generator(device=dev).manual_seed(96)
    for c in other_cp_configs():
        lo = torch.randn((c.n_levels, 3, c.table_size, c.n_components),
                         generator=gen_o, device=dev) * 0.5
        xo = random_points(4099, gen_o, dev)[0].T.contiguous()
        k = cp_encode_cuda(lo, xo, c)
        p = cp_encode_cuda_ref(lo, xo, c)
        torch.cuda.synchronize()
        other[cp_label(c)] = e = (k - p).abs().max().item()
        err = max(err, e)
    tol = 1e-6
    if not err <= tol:
        raise AssertionError(f"cp_encode: max abs err {err} > {tol} ({other})")
    lines = trained.model.cp_lines.detach()
    l32, c32 = f32_eng.model.cp_lines.detach(), f32_eng.ngp_config.cp
    enc_flops = n_enc * LC * 11
    b, by = bound_ms(n_enc * (12 + 4 * LC) + lines.numel() * 4, enc_flops, "f32")
    rows.append({
        "name": "cp_encode", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/cp_encode.cu",
        "replaces": "nerf_kinematics_tpu/ops/cp_grid_pallas.py:211",
        "n_points": n_enc, "max_abs_err": err, "max_rel_err": None,
        "other_configs_max_abs_err": other,
        "tolerance": f"abs {tol} (same roundings, same order of the two products)",
        "ms": (ms := time_ms(lambda: cp_encode_cuda(lines, x_enc, cp), reps, 2, flush)),
        # f32 mode is the kernel's other instance (f32 tables)
        "ms_by_body": {"bf16": ms, "f32": time_ms(
            lambda: cp_encode_cuda(l32, x_enc, c32), reps, 2, flush)},
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
            "source": "nerf_kinematics_tpu_torch/csrc/"
                      + ("ngp_apply.cu" if color else "ngp_fused.cu"),
            "replaces": f"nerf_kinematics_tpu/ops/ngp_fused_pallas.py:{line}",
            "n_points": n, "max_abs_err": worst["max"],
            "mean_abs_err": worst["mean"], "max_rel_err": worst["rel"],
            "f32_mode_max_abs_err": f32_max, "f32_mode_mean_abs_err": f32_mean,
            "tolerance": (
                f"rgb logits and log(sigma): mean abs {FUSED_MEAN_TOL}, max abs "
                f"{FUSED_MAX_TOL} (the sums run in another order than the plain "
                "version's matmul, which can flip the bf16 rounding of a hidden "
                "activation); f32 mode max abs 2e-3"),
            "ms": (ms := time_ms(lambda: kern(params, cp), reps, 2, flush)),
            # f32 mode runs other kernels (the FMA bodies)
            "ms_by_body": {"bf16": ms, "f32": time_ms(
                lambda: kern(f32_eng._fused_params(detach=True), f32_eng.ngp_config.cp),
                reps, 2, flush)},
            "plain_ms": time_ms(lambda: plain(params, cp), 2, 1, flush),
            "bound_ms": b, "bound_by": by, "library_ms": None,
        })
        del xt, vd
    rows[-1].update(apply_kernel_checks(trained, dev))
    rows.append(classic_forward_row(dev, quick, reps, flush))
    nonfinite = nonfinite_forwards({"bf16": trained, "f32": f32_eng}, dev)
    for r in rows:
        r["nonfinite"] = nonfinite.get(r["name"], r.get("nonfinite"))
    emit({"phase": "kernels", "quick": quick, "kernels": rows})
    return rows


RAGGED_POINTS = (1, 15, 17, 31, 33, 65, 4099)  # around row 3's tiles of 16


def apply_kernel_checks(trained, dev) -> dict:
    """Row 3's bf16 kernel (csrc/ngp_apply.cu) beyond the main shape: at the
    encodings of OTHER_WIDTHS with seeded weights, at ragged sizes around its
    tiles, two launches bit-identical, and its shared-memory layout as the
    library computes it against the host's mirror
    (ops/ngp_fused_cuda.py::apply_layout) and nkt_fused_smem_bytes."""
    import ctypes

    from nerf_kinematics_tpu_torch.ops import cuda_lib, ngp_fused_cuda as nf

    gen = torch.Generator(device=dev).manual_seed(3030)
    params, cp = trained._fused_params(detach=True), trained.ngp_config.cp
    cases = {"machina_ngp": (params, cp)}
    gen_w = torch.Generator(device=dev).manual_seed(62)
    for label, (L, C, T, _) in OTHER_WIDTHS.items():
        cw = dataclasses.replace(cp, n_levels=L, n_components=C, table_size=T)
        cases[label] = (seeded_fused_params(cw, gen_w, dev), cw)
    widths, layouts = {}, {}
    lib = cuda_lib.load_library()
    for label, (prm, c) in cases.items():
        xt, vd = random_points(65536, gen, dev)
        k, p = nf.ngp_fused_apply_cf(prm, xt, vd, c), nf.ngp_fused_apply_cf_ref(prm, xt, vd, c)
        torch.cuda.synchronize()
        if not (torch.isfinite(k).all() and torch.isfinite(p).all()):
            raise AssertionError(f"ngp_fused_apply_cf, {label}: non-finite output")
        mx, mean, _ = fused_errors(k, p, True)
        if not (mean <= FUSED_MEAN_TOL and mx <= FUSED_MAX_TOL):
            raise AssertionError(f"ngp_fused_apply_cf, {label}: max {mx}, mean {mean}")
        widths[label] = {"max_abs_err": mx, "mean_abs_err": mean}
        out = torch.empty((4, xt.shape[1]), device=dev)
        args, keep = nf._fused_args(prm, xt, vd, out, c, True)
        got = (ctypes.c_longlong * 6)()
        lib.nkt_apply_layout(ctypes.byref(args), got)
        want = nf.apply_layout_of(prm, c)
        smem = int(lib.nkt_fused_smem_bytes(ctypes.byref(args), 1))
        if tuple(int(v) for v in got) != want.as_tuple() or smem != want.total:
            raise AssertionError(f"row 3's layout, {label}: the library says "
                                 f"{tuple(got)} ({smem} B), the host {want}")
        layouts[label] = dataclasses.asdict(want)
        del keep
    ragged = {}
    xr, vr = random_points(max(RAGGED_POINTS), gen, dev)
    for label, (prm, c) in cases.items():
        for m in RAGGED_POINTS:
            xs, vs = xr[:, :m].contiguous(), vr[:, :m].contiguous()
            k, p = nf.ngp_fused_apply_cf(prm, xs, vs, c), nf.ngp_fused_apply_cf_ref(prm, xs, vs, c)
            torch.cuda.synchronize()
            mx, mean, _ = fused_errors(k, p, True)
            if not (torch.isfinite(k).all() and mean <= FUSED_MEAN_TOL and mx <= FUSED_MAX_TOL):
                raise AssertionError(
                    f"ngp_fused_apply_cf, {label}, {m} points: max {mx}, mean {mean}")
            ragged[f"{label} {m}"] = {"max_abs_err": mx, "mean_abs_err": mean}
    xt, vd = random_points(1 << 20, gen, dev)
    a, b = nf.ngp_fused_apply_cf(params, xt, vd, cp), nf.ngp_fused_apply_cf(params, xt, vd, cp)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    if not same:
        raise AssertionError("ngp_fused_apply_cf: two launches differ")
    return {"other_widths": widths, "ragged": ragged, "twice_bit_identical": same,
            "smem_layout": layouts}


# machina_classic at full width (configs/machina_classic.yml; the card has no
# PyYAML, and tests/test_torch_classic_train.py holds this dict to the file).
CLASSIC_CONFIG = {
    "dataset": {"basedir": "cache/machina400", "far": 6, "half_res": True,
                "near": 2, "no_ndc": True, "testskip": 1, "type": "blender"},
    "experiment": {"id": "machina-classic-lowres", "logdir": "logs",
                   "print_every": 500, "randomseed": 42, "save_every": 20000,
                   "train_iters": 200000, "validate_every": 2000},
    "models": {net: {"hidden_size": 128, "include_input_dir": True,
                     "include_input_xyz": True, "log_sampling_dir": True,
                     "log_sampling_xyz": True, "num_encoding_fn_dir": 4,
                     "num_encoding_fn_xyz": 10, "num_layers": 8,
                     "skip_connect_every": 3, "use_viewdirs": True}
               for net in ("coarse", "fine")},
    "nerf": {
        "encode_direction_fn": "positional_encoding",
        "encode_position_fn": "positional_encoding",
        "train": {"chunksize": 131072, "lindisp": False, "num_coarse": 64,
                  "num_fine": 64, "num_random_rays": 1024, "perturb": True,
                  "radiance_field_noise_std": 0.2, "white_background": True},
        "use_viewdirs": True,
        "validation": {"chunksize": 131072, "lindisp": False, "num_coarse": 64,
                       "num_fine": 64, "perturb": False,
                       "radiance_field_noise_std": 0.0, "white_background": True},
    },
    "optimizer": {"lr": 0.005, "type": "Adam"},
    "scheduler": {"lr_decay": 250, "lr_decay_factor": 0.1},
}

# rows 9 and 10: kernel against plain version, relative to the largest entry
# of the plain version's row (forward) or leaf (gradient). f32: only the
# order of the sums differs; bf16: that order can flip the bf16 rounding of
# an activation, one bf16 step (2^-8) of a single input.
CLASSIC_FWD_TOL = {"f32": {"max": 1e-4, "mean": 1e-5},
                   "bf16": {"max": 5e-2, "mean": 2e-3}}


def classic_engines(dev, modes=("f32", "bf16"), seed=0):
    """ClassicNerf at full width in each compute type, the same seeded
    weights."""
    import dataclasses

    from nerf_kinematics_tpu_torch.train.config import config_from_dict
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    base = config_from_dict(CLASSIC_CONFIG)
    out = {}
    for mode in modes:
        dt = "bfloat16" if mode == "bf16" else "float32"
        cfg = base.replace(
            model_coarse=dataclasses.replace(base.model_coarse, compute_dtype=dt),
            model_fine=dataclasses.replace(base.model_fine, compute_dtype=dt))
        eng = ClassicNerf(cfg, device=dev)
        eng.init_state(seed=seed)
        out[mode] = eng
    return out


def classic_points(n: int, gen, dev):
    """Points of rays through a machina-like scene: origins on a sphere of
    radius 4, directions towards the middle, depths in [near, far] = [2, 6]
    (|x| up to 6, so the L = 10 encoding sees arguments of thousands of
    radians); unit view directions. Channels-first."""
    o = torch.randn((3, n), generator=gen, device=dev)
    o = 4.0 * o / torch.linalg.norm(o, dim=0, keepdim=True)
    d = -o / 4.0 + 0.3 * torch.randn((3, n), generator=gen, device=dev)
    d = d / torch.linalg.norm(d, dim=0, keepdim=True)
    z = 2.0 + 4.0 * torch.rand((1, n), generator=gen, device=dev)
    return (o + d * z).contiguous(), d.contiguous()


def classic_flops(cfg) -> int:
    """Multiply-adds of one point of the fused classic forward, times two."""
    H, h2 = cfg.hidden_size, cfg.hidden_size // 2
    t = cfg.trunk_depth
    macs = cfg.dim_xyz * H + (t - 1) * H * H + H + H * H + (H + cfg.dim_dir) * h2 + h2 * 3
    return 2 * macs


def classic_rel_errors(k, p):
    """(max, mean) of |kernel - plain| per output row over the row's largest
    plain entry; the worst row."""
    mx = mean = 0.0
    for r in range(4):
        scale = max(p[r].abs().max().item(), 1e-30)
        d = (k[r] - p[r]).abs()
        mx, mean = max(mx, d.max().item() / scale), max(mean, d.mean().item() / scale)
    return mx, mean


def classic_forward_row(dev, quick: bool, reps: int, flush):
    """Row 9 at the classic main path's shape (the fine pass of a train step
    and of a 1024-ray render chunk: 1024 x 128 points), f32 and bf16, plus a
    ragged size."""
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc
    from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import (
        classic_fused_apply_cf, classic_fused_apply_cf_ref)

    gen = torch.Generator(device=dev).manual_seed(99)
    n = 1024 * 128 // (16 if quick else 1)
    xt, vd = classic_points(n, gen, dev)
    engines = classic_engines(dev)
    errs = {}
    for mode, eng in engines.items():
        mcfg = eng.cfg.model_coarse
        params = eng._fused_params(eng.model_coarse)
        worst = {"max": 0.0, "mean": 0.0}
        for m in (n, 999):
            k = classic_fused_apply_cf(params, xt[:, :m].contiguous(),
                                       vd[:, :m].contiguous(), mcfg)
            p = classic_fused_apply_cf_ref(params, xt[:, :m], vd[:, :m], mcfg)
            torch.cuda.synchronize()
            if not (torch.isfinite(k).all() and k.shape == p.shape):
                raise AssertionError("classic_fused_apply_cf: bad output")
            mx, mean = classic_rel_errors(k, p)
            worst = {"max": max(worst["max"], mx), "mean": max(worst["mean"], mean),
                     "max_abs": max(worst.get("max_abs", 0.0), (k - p).abs().max().item())}
        if mode == "f32":
            # a forward whose gradient is taken runs the FMA body (the one
            # row 10 runs again for its masks): held to the same tolerance
            grad_prm = {k: [t.detach().requires_grad_(True) for t in v]
                        for k, v in params.items()}
            with torch.enable_grad():
                k = classic_fused_apply_cf(grad_prm, xt, vd, mcfg).detach()
            p = classic_fused_apply_cf_ref(params, xt, vd, mcfg)
            torch.cuda.synchronize()
            mx, mean = classic_rel_errors(k, p)
            errs["f32_differentiable"] = {"max": mx, "mean": mean}
            worst = {**worst, "max": max(worst["max"], mx), "mean": max(worst["mean"], mean)}
            del grad_prm
        tol = CLASSIC_FWD_TOL[mode]
        if not (worst["max"] <= tol["max"] and worst["mean"] <= tol["mean"]):
            raise AssertionError(
                f"classic_fused_apply_cf ({mode}): {worst} beyond {tol}")
        errs[mode] = worst
    eng = engines["f32"]
    mcfg = eng.cfg.model_coarse
    params = eng._fused_params(eng.model_coarse)
    # f32 mode runs in 3xTF32 on the tensor cores: its bound is taken at
    # that rate; the bound at the FMA pipe's rate stays beside it
    io, flops = n * 40 + eng.layout.total * 2, n * classic_flops(mcfg)
    b, by = bound_ms(io, flops, "f32x3")
    b_fma, _ = bound_ms(io, flops, "f32")
    return {
        "name": "classic_fused_apply_cf", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/classic_fused.cu",
        "replaces": "nerf_kinematics_tpu/ops/classic_fused_pallas.py:312",
        "n_points": n, "max_abs_err": errs["f32"]["max_abs"], "errors": errs,
        "tolerance": f"per output row, over the row's largest entry: {CLASSIC_FWD_TOL}",
        "ms": (ms := time_ms(lambda: classic_fused_apply_cf(params, xt, vd, mcfg),
                             reps, 2, flush)),
        # the FMA body: the forward of a call whose gradient is taken
        "ms_by_body": {"3xtf32": ms, "fma": time_ms(
            lambda: cfc._forward(params, xt, vd, mcfg, tc=False), reps, 2, flush)},
        "plain_ms": time_ms(lambda: classic_fused_apply_cf_ref(params, xt, vd, mcfg),
                            3, 1, flush),
        "bound_ms": b, "bound_by": by, "bound_ms_f32_fma": b_fma, "library_ms": None,
    }


def classic_grad_row(dev, quick: bool, reps: int, flush):
    """Row 10 at the same shape, f32 and bf16, seeded random cotangents;
    plus a ragged size in one launch and split over several."""
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc

    gen = torch.Generator(device=dev).manual_seed(98)
    n = 1024 * 128 // (16 if quick else 1)
    xt, vd = classic_points(n, gen, dev)
    g4 = torch.randn((4, n), generator=gen, device=dev)
    engines = classic_engines(dev)
    reports = {}
    abs_err = 0.0

    def leaves(d):
        return [(f"W[{i}]", w) for i, w in enumerate(d["W"])] + \
               [(f"b[{i}]", b) for i, b in enumerate(d["b"])]

    def compare(k, p, mode, what):
        rep, worst_abs = {}, 0.0
        for (name, a), (_, b_) in zip(leaves(k), leaves(p)):
            if a.shape != b_.shape or not torch.isfinite(a).all():
                raise AssertionError(f"{what} {name}: bad gradient")
            scale = b_.abs().max().item()
            if scale == 0.0:
                raise AssertionError(f"{what} {name}: the plain gradient is all zero")
            d = (a - b_).abs()
            rep[name] = d.max().item() / scale
            worst_abs = max(worst_abs, d.max().item())
        bad = {k_: v for k_, v in rep.items() if not v <= GRAD_TOL[mode]}
        if bad:
            raise AssertionError(f"{what} ({mode}): beyond {GRAD_TOL[mode]}: {bad}")
        return rep, worst_abs

    for mode, eng in engines.items():
        mcfg = eng.cfg.model_coarse
        prm = {k: [t.detach() for t in v]
               for k, v in eng._fused_params(eng.model_coarse).items()}
        k = cfc.classic_fused_apply_cf_bwd(prm, xt, vd, g4, mcfg)
        p = cfc.classic_fused_apply_cf_bwd_ref(prm, xt, vd, g4, mcfg)
        torch.cuda.synchronize()
        rep, ae = compare(k, p, mode, "classic_fused_apply_cf_bwd")
        reports[mode] = max(rep.values())
        if mode == "f32":
            abs_err = ae
        # ragged: 999 points in one launch and over three
        m = 999
        xs, vs, gs = (t[:, :m].contiguous() for t in (xt, vd, g4))
        p = cfc.classic_fused_apply_cf_bwd_ref(prm, xs, vs, gs, mcfg)
        for label, chunk in (("one launch", cfc.BWD_CHUNK), ("split", 400)):
            keep, cfc.BWD_CHUNK = cfc.BWD_CHUNK, chunk
            k = cfc.classic_fused_apply_cf_bwd(prm, xs, vs, gs, mcfg)
            cfc.BWD_CHUNK = keep
            torch.cuda.synchronize()
            rep, _ = compare(k, p, mode, f"classic_fused_apply_cf_bwd, 999 points, {label}")
            reports[f"{mode}_999_{label.replace(' ', '_')}"] = max(rep.values())
    eng = engines["f32"]
    mcfg = eng.cfg.model_coarse
    prm = {k: [t.detach() for t in v]
           for k, v in eng._fused_params(eng.model_coarse).items()}
    run = lambda: cfc.classic_fused_apply_cf_bwd(prm, xt, vd, g4, mcfg)
    # deterministic: two launches on the same inputs, the same bits
    d1, d2 = run(), run()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b_) for (_, a), (_, b_) in zip(leaves(d1), leaves(d2)))
    if not same:
        raise AssertionError("classic_fused_apply_cf_bwd: two launches differ")
    del d1, d2
    # f32 mode runs in 3xTF32 on the tensor cores: its bound is taken at
    # that rate (the work's own bytes: points, directions, cotangent,
    # weights); the bound at the FMA pipe's rate stays beside it
    io, flops = n * (24 + 16) + eng.layout.total * 2, 3 * n * classic_flops(mcfg)
    b, by = bound_ms(io, flops, "f32x3")
    b_fma, _ = bound_ms(io, flops, "f32")
    parts = profile_parts(run, ROW10_PARTS)
    yard = classic_wgrad_yardstick(prm, n, reps, flush)
    return {
        "name": "classic_fused_apply_cf_bwd", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/classic_fused.cu",
        "replaces": "nerf_kinematics_tpu/ops/classic_fused_pallas.py:345",
        "n_points": n, "max_abs_err": abs_err, "max_rel_err": max(reports.values()),
        "errors": reports,
        "tolerance": f"per leaf, max abs over the leaf's largest entry: {GRAD_TOL}",
        "ms": (ms := time_ms(run, reps, 2, flush)),
        "ms_by_body": {"3xtf32": ms},
        "plain_ms": time_ms(lambda: cfc.classic_fused_apply_cf_bwd_ref(prm, xt, vd, g4, mcfg),
                            2, 1, flush),
        "bound_ms": b, "bound_by": by, "bound_ms_f32_fma": b_fma, "library_ms": None,
        "deterministic": same, "parts_ms": parts, "yardsticks": yard,
    }


# Row 10's parts by kernel name (either mode's kernels), for the profiles.
ROW10_PARTS = {
    "row 10: weight packing": ("nkc_pack",),
    "row 10: forward with saves, cotangents": ("nkc_tc_bwd_tile", "nkc_bwd_tile"),
    "row 10: weight gradients": ("nkc_tc_wgrad", "nkt_wgrad"),
    "row 10: sum of the partials": ("nkt_reduce_partials",),
}
# The classic step's profile: row 9's forward, then row 10's parts (the
# packing serves both rows).
CLASSIC_PARTS = {
    "row 9: forward": ("nkc_tc_forward", "nkc_forward"),
    "rows 9, 10: weight packing": ("nkc_pack",),
    **{k: v for k, v in ROW10_PARTS.items() if "packing" not in k},
}


def device_ms_by_group(prof, groups, other="other kernels"):
    """Device milliseconds of a torch.profiler run by kernel group (name ->
    kernel name prefixes), the rest under ``other``, and the kernels sorted
    by their time."""
    by_group = dict.fromkeys(groups, 0.0)
    by_group[other] = 0.0
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
            by_group[other] += dev_us / 1e3
    kernels.sort(key=lambda t: -t[1])
    return by_group, kernels


def profile_parts(fn, groups, reps: int = 5):
    """Device ms per call of ``fn`` by kernel group (torch.profiler over
    ``reps`` calls after one untraced call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_group, _ = device_ms_by_group(prof, groups)
    out = {k: v / reps for k, v in by_group.items()}
    out["total"] = sum(by_group.values()) / reps
    return out


def classic_wgrad_yardstick(prm, n: int, reps: int, flush):
    """cuBLAS in full f32 (``allow_tf32`` is False, set in ``main``) on row
    10's weight-gradient products: (K x n) . (n x J) for the eight layers,
    n points, one call each. A yardstick for the hand-written kernel; the
    port never calls it."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 yardstick needs full-f32 matmuls")
    dev = prm["W"][0].device
    gen = torch.Generator(device=dev).manual_seed(78)
    shapes = [tuple(w.shape) for w in prm["W"]]
    mats = [(torch.randn((k, n), generator=gen, device=dev),
             torch.randn((j, n), generator=gen, device=dev)) for k, j in shapes]

    def all_layers():
        for a, g in mats:
            torch.matmul(a, g.T)

    out = {"n_points": n, "layers": shapes, "allow_tf32": False,
           "matmul_f32_all_layers_ms": time_ms(all_layers, reps, 2, flush)}
    del mats
    return out


GRAD_TOL = {"bf16": 5e-3, "f32": 2e-4}  # per leaf, relative to its largest entry
# (levels, channels, table rows, samples a ray) of encodings other than
# machina_ngp.yml's, for rows 6 and 7, so that every instance of the tile
# kernel (csrc/ngp_fused_bwd.cu::launch_tile_for) runs: wheel_ngp.yml's at
# its 64 fine samples (the generic instance up to 256), fox_ngp.yml's at the
# halo two-call route's 48 (its own), and 8 x 64 (the generic one up to 512)
OTHER_WIDTHS = {"wheel_ngp": (4, 32, 128, 64), "fox_ngp": (5, 96, 256, 48),
                "8_levels_x_64": (8, 64, 128, 48)}


def seeded_fused_params(cp, gen, dev) -> dict:
    """Seeded weights of the shipped MLPs (density 64 -> 64 -> 16, color
    32 -> 64 -> 64 -> 64 -> 3) on the encoding ``cp``, He-scaled."""
    w = lambda k, j: torch.randn((k, j), generator=gen, device=dev) * (2.0 / k) ** 0.5
    b = lambda j: torch.randn((j, 1), generator=gen, device=dev) * 0.1
    dens = [(cp.out_dim, 64), (64, 64), (64, 16)]
    col = [(32, 64), (64, 64), (64, 64), (64, 3)]
    return {"lines": torch.randn((cp.n_levels, 3, cp.table_size, cp.n_components),
                                 generator=gen, device=dev) * 0.5,
            "dW": [w(*s) for s in dens], "db": [b(s[1]) for s in dens],
            "cW": [w(*s) for s in col], "cb": [b(s[1]) for s in col]}
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
    from nerf_kinematics_tpu_torch.ops import cuda_lib, ngp_fused_cuda
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
    other, gen_o = {}, torch.Generator(device=dev).manual_seed(97)
    for c in other_cp_configs():
        lo = torch.randn((c.n_levels, 3, c.table_size, c.n_components),
                         generator=gen_o, device=dev) * 0.5
        xo = random_points(999 if quick else 9999, gen_o, dev)[0].T.contiguous()
        go = torch.randn((xo.shape[0], c.out_dim), generator=gen_o, device=dev)
        k = cp_encode_cuda_bwd(lo, xo, go, c)
        p = cp_encode_cuda_bwd_ref(lo, xo, go, c)
        k2 = cp_encode_cuda_bwd(lo, xo, go, c)
        torch.cuda.synchronize()
        mode = "bf16" if c.use_bf16 else "f32"
        rep = grad_errors({"lines": k, "dW": [], "db": [], "cW": [], "cb": []},
                          {"lines": p, "dW": [], "db": [], "cW": [], "cb": []})
        check(f"cp_encode_bwd, {cp_label(c)}", mode, rep)
        if not torch.equal(k, k2):
            raise AssertionError(f"cp_encode_bwd, {cp_label(c)}: two launches differ")
        other[cp_label(c)] = rep["lines"]["max_rel"]
        del k, p, k2
    lines = engines["bf16"].model.cp_lines.detach()
    l32, c32 = engines["f32"].model.cp_lines.detach(), engines["f32"].ngp_config.cp
    b, by = bound_ms(n * (12 + 4 * LC) + 2 * lines.numel() * 4, n * LC * 20, "f32")
    rows.append({
        "name": "cp_encode_bwd", "route": "cuda",
        "source": "nerf_kinematics_tpu_torch/csrc/cp_encode.cu",
        "replaces": "nerf_kinematics_tpu/ops/cp_grid_pallas.py:240",
        "n_points": n, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "tolerance": f"per leaf, max abs over the leaf's largest entry: {GRAD_TOL} "
                     "(tile sums on the tensor cores and chunk sums, in another "
                     "order than index_add_; 3xTF32 products in f32 mode)",
        "other_configs_max_rel_err": other,
        "ms": (ms := time_ms(lambda: cp_encode_cuda_bwd(lines, x_enc, g_enc, cp),
                             reps, 2, flush)),
        # f32 mode is the kernel's other instance (3xTF32, batches of 32)
        "ms_by_body": {"bf16": ms, "f32": time_ms(
            lambda: cp_encode_cuda_bwd(l32, x_enc, g_enc, c32), reps, 2, flush)},
        "plain_ms": time_ms(lambda: cp_encode_cuda_bwd_ref(lines, x_enc, g_enc, cp), 2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })

    # ---- rows 6 and 7: fused VJP and fused train objective -------------
    params = engines["bf16"]._fused_params(detach=True)
    p32, c32 = engines["f32"]._fused_params(detach=True), engines["f32"].ngp_config.cp
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
    parts6 = ngp_fused_cuda.grad_bytes(params, cp, n, 0, cuda_lib.sm_count(dev))
    rows.append({
        "name": "ngp_fused_apply_cf_bwd", "route": "cuda",
        "bytes_a_call": sum(parts6.values()), "bytes_by_part": parts6,
        "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused_bwd.cu",
        "replaces": "nerf_kinematics_tpu/ops/ngp_fused_pallas.py:475",
        "n_points": n, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "tolerance": f"per leaf, max abs over the leaf's largest entry: {GRAD_TOL} "
                     "(other summation order; a flipped bf16 rounding of a cotangent)",
        "ms": (ms := time_ms(lambda: ngp_fused_apply_cf_bwd(params, xt, vd, g4, cp),
                             reps, 2, flush)),
        "ms_by_body": {"bf16": ms, "f32": time_ms(
            lambda: ngp_fused_apply_cf_bwd(p32, xt, vd, g4, c32), reps, 2, flush)},
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
    parts7 = ngp_fused_cuda.grad_bytes(params, cp, n, S, cuda_lib.sm_count(dev))
    rows.append({
        "name": "ngp_fused_train_cf", "route": "cuda",
        "bytes_a_call": sum(parts7.values()), "bytes_by_part": parts7,
        "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused_bwd.cu",
        "replaces": "nerf_kinematics_tpu/ops/ngp_fused_pallas.py:752",
        "n_points": n, "n_rays": R, "max_abs_err": abs_err,
        "max_rel_err": worst_of(reports.values()), "errors": reports,
        "err_maps_max_abs_err": out_err,
        "tolerance": f"err, maps: abs {TRAIN_OUT_TOL}; gradients per leaf, max abs "
                     f"over the leaf's largest entry: {GRAD_TOL}",
        "ms": (ms := time_ms(
            lambda: ngp_fused_train_cf(params, xt, vd, dists, tgt, cp, S, True, inv),
            reps, 2, flush)),
        "ms_by_body": {"bf16": ms, "f32": time_ms(
            lambda: ngp_fused_train_cf(p32, xt, vd, dists, tgt, c32, S, True, inv),
            reps, 2, flush)},
        "plain_ms": time_ms(lambda: ngp_fused_train_cf_ref(params, xt, vd, dists, tgt, cp, S, True, inv),
                            2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    })
    # ---- ragged sizes: the tails of a block, a warp and a tile, and the
    # wrappers' split into several launches -------------------------------
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
    for mode, eng5 in engines.items():
        l5, c5 = eng5.model.cp_lines.detach(), eng5.ngp_config.cp
        k5 = cp_encode_cuda_bwd(l5, xr.T.contiguous(), ger, c5)
        p5 = cp_encode_cuda_bwd_ref(l5, xr.T.contiguous(), ger, c5)
        rep5 = grad_errors({"lines": k5, "dW": [], "db": [], "cW": [], "cb": []},
                           {"lines": p5, "dW": [], "db": [], "cW": [], "cb": []})
        check("cp_encode_bwd, ragged", mode, rep5)
        ragged[f"row_5_{mode}_max_rel"] = worst_of([rep5])
    # ---- the other shipped encodings: each instance of the tile kernel
    # (csrc/ngp_fused_bwd.cu::launch_tile_for) at a config's widths and
    # samples a ray, seeded weights, against the plain versions
    widths = {}
    gen_w = torch.Generator(device=dev).manual_seed(61)
    for label, (L, C, T, Sw) in OTHER_WIDTHS.items():
        cw = dataclasses.replace(cp, n_levels=L, n_components=C, table_size=T)
        pw = seeded_fused_params(cw, gen_w, dev)
        Rw = 512
        nw = Rw * Sw
        xw, vw = random_points(nw, gen_w, dev)
        gw = torch.randn((4, nw), generator=gen_w, device=dev)
        gw[3] *= 1e-3
        zw = 2.0 + 4.0 * torch.sort(torch.rand((Rw, Sw), generator=gen_w, device=dev),
                                    dim=-1).values
        dw = torch.cat([zw[:, 1:] - zw[:, :-1], torch.full((Rw, 1), 1e10, device=dev)],
                       dim=-1).reshape(1, nw).contiguous()
        tw = torch.rand((3, Rw), generator=gen_w, device=dev)
        iw = 1.0 / (3.0 * Rw)
        k6 = ngp_fused_apply_cf_bwd(pw, xw, vw, gw, cw)
        ek, mk, k7 = ngp_fused_train_cf(pw, xw, vw, dw, tw, cw, Sw, True, iw)
        k7b = ngp_fused_train_cf(pw, xw, vw, dw, tw, cw, Sw, True, iw)[2]
        p6 = ngp_fused_apply_cf_bwd_ref(pw, xw, vw, gw, cw)
        ep, mp, p7 = ngp_fused_train_cf_ref(pw, xw, vw, dw, tw, cw, Sw, True, iw)
        torch.cuda.synchronize()
        rep6, rep7 = grad_errors(k6, p6), grad_errors(k7, p7)
        check(f"ngp_fused_apply_cf_bwd, {label}", "bf16", rep6)
        check(f"ngp_fused_train_cf, {label}", "bf16", rep7)
        out_w = max((ek - ep).abs().max().item(), (mk - mp).abs().max().item())
        if not out_w <= TRAIN_OUT_TOL:
            raise AssertionError(f"ngp_fused_train_cf, {label}: err / maps differ by {out_w}")
        plan = ngp_fused_cuda.bwd_plan_of(pw, cw, Sw)
        widths[label] = {
            "encoding": [L, C], "samples_a_ray": Sw, "n_points": nw,
            "tile": [plan.points, plan.rays], "row_6_max_rel": worst_of([rep6]),
            "row_7_max_rel": worst_of([rep7]), "err_maps_max_abs": out_w,
            "row_7_deterministic": all(torch.equal(u, v) for (_, u), (_, v)
                                       in zip(_leaf_list(k7), _leaf_list(k7b)))}
        del k6, k7, k7b, p6, p7
    # ---- determinism: two launches on the same inputs give the same bits
    # (rows 5-7 here, row 8 in full_step_row, row 10 in classic_grad_row)
    det = {f"ngp_fused_train_cf_{k}": v["row_7_deterministic"] for k, v in widths.items()}
    for mode, eng in engines.items():
        prm, c = eng._fused_params(detach=True), eng.ngp_config.cp
        lines = prm["lines"]
        calls = {
            "cp_encode_bwd": lambda: {"lines": cp_encode_cuda_bwd(lines, x_enc, g_enc, c),
                                      "dW": [], "db": [], "cW": [], "cb": []},
            "ngp_fused_apply_cf_bwd": lambda: ngp_fused_apply_cf_bwd(prm, xt, vd, g4, c),
            "ngp_fused_train_cf": lambda: ngp_fused_train_cf(
                prm, xt, vd, dists, tgt, c, S, True, inv)[2],
        }
        for name, fn in calls.items():
            a, b_ = fn(), fn()
            torch.cuda.synchronize()
            det[f"{name}_{mode}"] = all(
                torch.equal(u, v) for (_, u), (_, v) in zip(_leaf_list(a), _leaf_list(b_)))
            del a, b_
    long_rays = long_ray_checks(fx, engines, dev, quick, reps, flush)
    rows.append(full_step_row(fx, engines, dev, quick, reps, flush))
    rows.append(classic_grad_row(dev, quick, reps, flush))
    det["ngp_fused_train_full_cf"] = rows[-2]["deterministic"]
    det["classic_fused_apply_cf_bwd"] = rows[-1]["deterministic"]
    nonfinite = nonfinite_grads(fx, engines, dev)
    for r in rows:
        r["nonfinite"] = nonfinite[r["name"]]
    emit({"phase": "grad_kernels", "quick": quick, "kernels": rows,
          "ragged_999_points": ragged, "other_widths": widths, "long_rays": long_rays,
          "deterministic": det})
    if not all(det.values()):
        raise AssertionError(f"grad_kernels: two launches differ: {det}")
    return rows


# Rows 7 and 8 at samples a ray against the tile: (label, encoding (L, C, T)
# or None for the fixture's, S). A ray longer than a tile (machina's 96
# points, fox's 64) takes the long-ray path; machina_ngp_fast.yml's 24 puts
# four rays in a tile.
LONG_RAY_CASES = (("machina_ngp, S 128", None, 128), ("fox_ngp, S 65", (5, 96, 256), 65),
                  ("machina_ngp_fast, S 24", None, 24))
LONG_RAY_RAYS = 512        # rays of each check
LONG_RAY_TIMED_RAYS = 3072  # 3072 x 128 = the flagship's 393 216 fine points


def long_ray_checks(fx, engines, dev, quick: bool, reps: int, flush) -> dict:
    """Rows 7 and 8 in bf16 mode at LONG_RAY_CASES against their plain
    versions on the same inputs (err and maps, the gradients per leaf, one
    launch a call, the plan's path), on finite inputs and on the non-finite
    cases of :func:`nonfinite_grads`; then both at machina's widths and S =
    128 timed at the flagship's fine points."""
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops import cuda_lib, ngp_fused_cuda
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_train_cf, ngp_fused_train_cf_ref, ngp_fused_train_full_cf,
        ngp_fused_train_full_cf_ref)
    from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections

    gen = torch.Generator(device=dev).manual_seed(1280)
    ngp, t = fx.config.ngp, fx.config.nerf.train
    Sc, NB = t.num_coarse, ngp.occ_bins
    near, far = fx.config.dataset.near, fx.config.dataset.far
    proj2 = pair_projections(grid_from_numpy(fx.grid_density, fx.grid_bound,
                                             device=dev)).contiguous()
    # not cut by --quick: with fewer rays a leaf's largest entry sums fewer
    # samples, and one sample that row 8's inverse CDF moves by the coarse
    # pass's last bits weighs more (row 8 at fox's widths in bf16: 7.6 % of
    # a leaf at 128 rays, 0.03 % at 512)
    R = LONG_RAY_RAYS
    inv = 1.0 / (3.0 * R)
    leaves = lambda k, p: [(n_, a, b) for (n_, a), (_, b) in zip(_leaf_list(k), _leaf_list(p))]

    def rays_of(S):
        xt, vd = random_points(R * S, gen, dev)
        vd = vd.reshape(3, R, S)[:, :, :1].expand(3, R, S).reshape(3, -1).contiguous()
        z = 2.0 + 4.0 * torch.sort(torch.rand((R, S), generator=gen, device=dev),
                                   dim=-1).values
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)],
                          dim=-1).reshape(1, R * S).contiguous()
        return xt, vd, dists, torch.rand((3, R), generator=gen, device=dev)

    def counted(name, fn):
        cuda_lib.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, cuda_lib.LAUNCHES[name]

    report, fail = {}, []
    for label, enc, S in LONG_RAY_CASES:
        c = engines["bf16"].ngp_config.cp
        if enc is None:
            prm = engines["bf16"]._fused_params(detach=True)
        else:
            c = dataclasses.replace(c, n_levels=enc[0], n_components=enc[1],
                                    table_size=enc[2])
            prm = seeded_fused_params(c, gen, dev)
        plan = ngp_fused_cuda.bwd_plan_of(prm, c, S)
        xt, vd, dists, tgt = rays_of(S)
        (ek, mk, k), n7 = counted("ngp_fused_train_cf", lambda: ngp_fused_train_cf(
            prm, xt, vd, dists, tgt, c, S, True, inv))
        ep, mp, p = ngp_fused_train_cf_ref(prm, xt, vd, dists, tgt, c, S, True, inv)
        rep7 = grad_errors(k, p)
        out7 = max((ek - ep).abs().max().item(), (mk - mp).abs().max().item())
        del k, p
        o, d, vr, tg, uc, uf = full_step_inputs(R, S, Sc, gen, dev)
        args = (o, d, vr, tg, uc, uf, proj2, c, S, Sc, NB, True, inv, near, far, 1.0,
                ngp.occ_floor)
        k8, n8 = counted("ngp_fused_train_full_cf",
                         lambda: ngp_fused_train_full_cf(prm, *args))
        p8 = ngp_fused_train_full_cf_ref(prm, *args)
        rep8 = grad_errors(k8[3], p8[3])
        out8 = max((a - b).abs().max().item() for a, b in zip(k8[:3], p8[:3]))
        del k8, p8
        # the non-finite cases: row 7 on its rays, row 8 with a ray's origin
        nonfinite = {}
        for case in POINT_CASES + PARAM_CASES:
            xs, pr_, _ = spoil(case, xt if case in POINT_CASES else None,
                               prm if case in PARAM_CASES else None)
            xs = xt if xs is None else xs
            pr_ = prm if pr_ is None else pr_
            k = ngp_fused_train_cf(pr_, xs, vd, dists, tgt, c, S, True, inv)
            p = ngp_fused_train_cf_ref(pr_, xs, vd, dists, tgt, c, S, True, inv)
            nonfinite[f"row 7 {case}"] = same_masks(
                f"ngp_fused_train_cf {label} {case}",
                [("err", k[0], p[0]), ("maps", k[1], p[1])] + leaves(k[2], p[2]))
            oo = spoil(case, o)[0] if case in POINT_CASES else o
            a8 = (oo,) + args[1:]
            k = ngp_fused_train_full_cf(pr_, *a8)
            p = ngp_fused_train_full_cf_ref(pr_, *a8)
            nonfinite[f"row 8 {case}"] = same_masks(
                f"ngp_fused_train_full_cf {label} {case}",
                [("err", k[0], p[0]), ("maps", k[1], p[1]), ("err_c", k[2], p[2])]
                + leaves(k[3], p[3]))
        torch.cuda.synchronize()
        report[label] = {
            "encoding": [c.n_levels, c.n_components], "samples_a_ray": S, "rays": R,
            "tile": [plan.points, plan.rays], "long_rays": plan.long_rays,
            "launches": {"row_7": n7, "row_8": n8},
            "row_7_max_rel": max(v["max_rel"] for v in rep7.values()),
            "row_7_err_maps_max_abs": out7,
            "row_8_max_rel": max(v["max_rel"] for v in rep8.values()),
            "row_8_outputs_max_abs": out8, "nonfinite_masks_equal": nonfinite}
        if plan.long_rays != (S > plan.points) or (n7, n8) != (1, 1):
            fail.append(f"{label}: plan {plan}, launches {n7}, {n8}")
        if not (max(v["max_rel"] for v in rep7.values()) <= GRAD_TOL["bf16"]
                and out7 <= TRAIN_OUT_TOL):
            fail.append(f"{label}: row 7 against its plain version: {rep7}, outputs {out7}")
        if not (max(v["max_rel"] for v in rep8.values()) <= FULL_GRAD_TOL["bf16"]
                and out8 <= FULL_OUT_TOL):
            fail.append(f"{label}: row 8 against its plain version: {rep8}, outputs {out8}")
    # the long-ray path's time at the flagship's fine points
    S, Rt = 128, LONG_RAY_TIMED_RAYS // (16 if quick else 1)
    prm, c = engines["bf16"]._fused_params(detach=True), engines["bf16"].ngp_config.cp
    xt, vd = random_points(Rt * S, gen, dev)
    dists = torch.full((1, Rt * S), 0.03, device=dev)
    dists.view(Rt, S)[:, -1] = 1e10
    tgt = torch.rand((3, Rt), generator=gen, device=dev)
    o, d, vr, tg, uc, uf = full_step_inputs(Rt, S, Sc, gen, dev)
    it = 1.0 / (3.0 * Rt)
    # the bounds as rows 7 and 8's at the flagship's shape count them
    n, LC = Rt * S, c.out_dim
    Ws, pbytes = prm["dW"] + prm["cW"], param_bytes(prm, True)
    fine = 3 * mlp_flops(Ws) + LC * 12 + LC * 30 + 120
    b7 = bound_ms(n * 28 + Rt * (12 + 20) + 2 * pbytes, n * fine, "bf16")
    b8 = bound_ms(Rt * (4 * 12 + 4 * (S + Sc) + 24) + proj2.numel() * 4 + 2 * pbytes,
                  Rt * Sc * (mlp_flops(prm["dW"]) + LC * 12) + n * fine, "bf16")
    report["timed"] = {
        "samples_a_ray": S, "rays": Rt, "fine_points": n,
        "row_7_bound_ms": b7[0], "row_8_bound_ms": b8[0], "bound_by": [b7[1], b8[1]],
        "row_7_ms": time_ms(lambda: ngp_fused_train_cf(prm, xt, vd, dists, tgt, c, S,
                                                       True, it), reps, 2, flush),
        "row_8_ms": time_ms(lambda: ngp_fused_train_full_cf(
            prm, o, d, vr, tg, uc, uf, proj2, c, S, Sc, NB, True, it, near, far, 1.0,
            ngp.occ_floor), reps, 2, flush),
        "row_7_plain_ms": time_ms(lambda: ngp_fused_train_cf_ref(
            prm, xt, vd, dists, tgt, c, S, True, it), 2, 1, flush),
    }
    if fail:
        emit({"phase": "grad_kernels", "failed_long_rays": report})
        raise AssertionError(f"grad_kernels, long rays: {fail}")
    return report


# Row 8 against its plain version. Stages A-B (proposal, coarse depths) are
# the same IEEE operations in both; the density-only pass sums in another
# order than the plain version's matmul, so coarse weights and then fine
# depths differ in their last bits, which the inverse CDF amplifies in bins
# of little mass: the fine stage then sees slightly moved samples. err,
# maps, err_c: abs; gradients per leaf over the leaf's largest entry.
FULL_OUT_TOL = 1e-3
FULL_GRAD_TOL = {"f32": 2e-3, "bf16": 1e-2}


def full_step_inputs(R: int, S: int, Sc: int, gen, dev):
    """Rays of a machina-like camera (origins at radius 4, directions towards
    the middle with a spread, norms in [1, 1.2] as get_rays gives them), unit
    view directions, targets, and sorted stratified inverse-CDF positions
    (Sc, R) / (S, R). Channels-first."""
    o = torch.randn((3, R), generator=gen, device=dev)
    o = 4.0 * o / torch.linalg.norm(o, dim=0, keepdim=True)
    d = -o / 4.0 + 0.15 * torch.randn((3, R), generator=gen, device=dev)
    vd = d / torch.linalg.norm(d, dim=0, keepdim=True)
    d = vd * (1.0 + 0.2 * torch.rand((1, R), generator=gen, device=dev))
    tgt = torch.rand((3, R), generator=gen, device=dev)

    def strat(n):
        base = torch.arange(n, dtype=torch.float32, device=dev)[:, None] / n
        return (base + torch.rand((n, R), generator=gen, device=dev) / n).contiguous()

    return (o.contiguous(), d.contiguous(), vd.contiguous(), tgt, strat(Sc), strat(S))


def wgrad_yardsticks(params, n: int, reps: int, flush):
    """cuBLAS times of the weight gradients' products at row 8's fine shape:
    bf16 (K x n) . (n x J) for layer 0 and for all the layers, one call
    each. A yardstick for the hand-written kernel; the port never calls
    it."""
    dev = params["lines"].device
    gen = torch.Generator(device=dev).manual_seed(77)
    shapes = [tuple(w.shape) for w in params["dW"] + params["cW"]]
    mats = [(torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16),
             torch.randn((j, n), generator=gen, device=dev).to(torch.bfloat16))
            for k, j in shapes]

    def all_layers():
        for a, g in mats:
            torch.matmul(a, g.T)

    out = {"n_points": n, "layers": shapes,
           "matmul_layer0_ms": time_ms(lambda: torch.matmul(mats[0][0], mats[0][1].T),
                                       reps, 2, flush),
           "matmul_all_layers_ms": time_ms(all_layers, reps, 2, flush)}
    del mats
    return out


def full_step_row(fx, engines, dev, quick: bool, reps: int, flush):
    """Row 8 at the flagship step's shape: 8192 rays, 48 + 48 samples, 64
    proposal bins on the fixture's 96^3 grid; bf16 and f32 mode, both
    backgrounds; then 37 rays in one launch and split over five."""
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.ops import cuda_lib, ngp_fused_cuda
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_train_full_cf, ngp_fused_train_full_cf_ref)
    from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections

    gen = torch.Generator(device=dev).manual_seed(8888)
    ngp, t = fx.config.ngp, fx.config.nerf.train
    S, Sc, NB = t.num_fine, t.num_coarse, ngp.occ_bins
    R = fx.config.nerf.num_random_rays // (16 if quick else 1)
    near, far = fx.config.dataset.near, fx.config.dataset.far
    proj2 = pair_projections(grid_from_numpy(fx.grid_density, fx.grid_bound,
                                             device=dev)).contiguous()
    o, d, vd, tgt, uc, uf = full_step_inputs(R, S, Sc, gen, dev)

    def call(fn, prm, c, white, rays=None, inv=1.0 / (3.0 * R)):
        args = (o, d, vd, tgt, uc, uf) if rays is None else rays
        return fn(prm, *args, proj2, c, S, Sc, NB, white, inv, near, far, 1.0,
                  ngp.occ_floor)

    reports, out_err, abs_err = {}, 0.0, 0.0
    for mode, eng in engines.items():
        prm, c = eng._fused_params(detach=True), eng.ngp_config.cp
        for white in (True, False):
            ek, mk, eck, k = call(ngp_fused_train_full_cf, prm, c, white)
            ep, mp, ecp, p = call(ngp_fused_train_full_cf_ref, prm, c, white)
            torch.cuda.synchronize()
            if ek.shape != (1, R) or mk.shape != (4, R) or eck.shape != (1, R):
                raise AssertionError("ngp_fused_train_full_cf: wrong output shapes")
            out_err = max(out_err, *((a - b).abs().max().item()
                                     for a, b in ((ek, ep), (mk, mp), (eck, ecp))))
            reports[f"{mode}{'_white' if white else ''}"] = grad_errors(k, p)
            abs_err = max(abs_err, *((a - b_).abs().max().item()
                                     for (_, a), (_, b_) in zip(_leaf_list(k), _leaf_list(p))))
            del k, p
    # ragged: 37 rays (no multiple of a warp or of 128) in one launch and in
    # launches of 8 rays
    Rr = 37
    rays_r = tuple(x[:, :Rr].contiguous() for x in (o, d, vd, tgt, uc, uf))
    prm, c = engines["bf16"]._fused_params(detach=True), engines["bf16"].ngp_config.cp
    ep, mp, ecp, p = call(ngp_fused_train_full_cf_ref, prm, c, True, rays_r, 1 / (3 * Rr))
    for label, chunk in (("one launch", ngp_fused_cuda.BWD_CHUNK), ("split", 400)):
        keep, ngp_fused_cuda.BWD_CHUNK = ngp_fused_cuda.BWD_CHUNK, chunk
        ek, mk, eck, k = call(ngp_fused_train_full_cf, prm, c, True, rays_r, 1 / (3 * Rr))
        ngp_fused_cuda.BWD_CHUNK = keep
        torch.cuda.synchronize()
        out_err = max(out_err, *((a - b).abs().max().item()
                                 for a, b in ((ek, ep), (mk, mp), (eck, ecp))))
        reports[f"bf16_37_rays_{label.replace(' ', '_')}"] = grad_errors(k, p)
    prm, c = engines["bf16"]._fused_params(detach=True), engines["bf16"].ngp_config.cp
    same = True
    for mode, eng in engines.items():
        p_m, c_m = eng._fused_params(detach=True), eng.ngp_config.cp
        k1 = call(ngp_fused_train_full_cf, p_m, c_m, True)
        k2 = call(ngp_fused_train_full_cf, p_m, c_m, True)
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b_) for a, b_ in zip(k1[:3], k2[:3])) and all(
            torch.equal(a, b_) for (_, a), (_, b_) in zip(_leaf_list(k1[3]), _leaf_list(k2[3])))
        del k1, k2
    yard = wgrad_yardsticks(prm, R * S, reps, flush)
    LC = c.out_dim
    n_c, n_f = R * Sc, R * S
    flops = n_c * (mlp_flops(prm["dW"]) + LC * 12) + \
        n_f * (3 * mlp_flops(prm["dW"] + prm["cW"]) + LC * 12 + LC * 30 + 120)
    io = R * (4 * 12 + 4 * (S + Sc) + 24) + proj2.numel() * 4 + \
        2 * param_bytes(prm, True)
    b, by = bound_ms(io, flops, "bf16")
    worst = max(v["max_rel"] for rep in reports.values() for v in rep.values())
    # bytes a call: the fine stage's tile kernel (as row 7), stages (a)-(c):
    # the rays and draws read, the coarse depths, points and sigma written
    # and read back, the fine stage's operands written (read in the tile
    # kernel's count), the pair projections; row 2's staged weights
    parts8 = ngp_fused_cuda.grad_bytes(prm, c, n_f, S, cuda_lib.sm_count(dev))
    parts8["stages_a_c"] = R * (4 * 12 + 4 * (S + Sc) + 4) + proj2.numel() * 4 + \
        2 * n_c * (4 + 12 + 16) + n_f * 28
    row = {
        "name": "ngp_fused_train_full_cf", "route": "cuda",
        "bytes_a_call": sum(parts8.values()), "bytes_by_part": parts8,
        "source": "nerf_kinematics_tpu_torch/csrc/ngp_fused_full.cu",
        "replaces": "nerf_kinematics_tpu/ops/ngp_fused_pallas.py:1013",
        "n_rays": R, "n_points": n_c + n_f, "max_abs_err": abs_err,
        "max_rel_err": worst, "errors": reports,
        "err_maps_errc_max_abs_err": out_err,
        "tolerance": f"err, maps, err_c: abs {FULL_OUT_TOL}; gradients per leaf, "
                     f"max abs over the leaf's largest entry: {FULL_GRAD_TOL}",
        "ms": (ms := time_ms(lambda: call(ngp_fused_train_full_cf, prm, c, True),
                             reps, 2, flush)),
        "ms_by_body": {"bf16": ms, "f32": time_ms(
            lambda: call(ngp_fused_train_full_cf, engines["f32"]._fused_params(detach=True),
                         engines["f32"].ngp_config.cp, True), reps, 2, flush)},
        "plain_ms": time_ms(lambda: call(ngp_fused_train_full_cf_ref, prm, c, True),
                            2, 1, flush),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "yardsticks": yard, "deterministic": same,
    }
    bad = {k: {n: v for n, v in rep.items()
               if not v["max_rel"] <= FULL_GRAD_TOL[k.split("_")[0]]}
           for k, rep in reports.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad or not out_err <= FULL_OUT_TOL:
        emit({"phase": "grad_kernels", "failed_row": row})
        raise AssertionError(
            f"ngp_fused_train_full_cf: outputs {out_err} (tolerance {FULL_OUT_TOL}), "
            f"gradients beyond {FULL_GRAD_TOL}: {bad}")
    return row


def main_path_time(r, points) -> None:
    """A kernel's time on the main paths: for each body that ran there, its
    points times that body's time a point, measured in this run at the row's
    shape (``ms_by_body``), and the part of that above the bound. A body
    that ran on the main paths without a timing here is an error."""
    n = r["n_points"]
    r["bound_ns_per_point"] = r["bound_ms"] * 1e6 / n
    by_body = {}
    for (name, body), pts in sorted(points.items()):
        if name != r["name"] or pts == 0:
            continue
        if body not in r["ms_by_body"]:
            raise AssertionError(f"{name}: body {body} ran on the main path "
                                 "but was not timed")
        ns = r["ms_by_body"][body] * 1e6 / n
        by_body[body] = {"points": pts, "ns_per_point": ns,
                         "ms": pts * ns / 1e6,
                         "gap_ms": pts * (ns - r["bound_ns_per_point"]) / 1e6}
    r["main_path_by_body"] = by_body
    r["main_path_points"] = sum(v["points"] for v in by_body.values())
    r["main_path_ms"] = sum(v["ms"] for v in by_body.values())
    r["main_path_gap_ms"] = sum(v["gap_ms"] for v in by_body.values())


def fused_dlines_time(row5, points) -> dict:
    """Row 5's kernel inside the fused gradient kernels (rows 6-8) on the
    main paths: for each body, the points it walked there times that body's
    time a point measured in this run at the same shape. Part of those rows'
    times, not added to row 5's own. A body without a timing is an error."""
    by_body = {}
    for (name, body), pts in sorted(points.items()):
        if name != "cp_encode_bwd_in_fused" or pts == 0:
            continue
        if body not in row5["ms_by_body"]:
            raise AssertionError(f"cp_encode_bwd: body {body} ran inside the "
                                 "fused gradients but was not timed")
        ns = row5["ms_by_body"][body] * 1e6 / row5["n_points"]
        by_body[body] = {"points": pts, "ns_per_point": ns, "ms": pts * ns / 1e6,
                         "gap_ms": pts * (ns - row5["bound_ns_per_point"]) / 1e6}
    return {"by_body": by_body,
            "points": sum(v["points"] for v in by_body.values()),
            "ms": sum(v["ms"] for v in by_body.values()),
            "gap_ms": sum(v["gap_ms"] for v in by_body.values())}


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
    points = collections.Counter(cuda_lib.POINTS)
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
    return (counts, points), engine, aux


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


def _train_config(fx, logdir, quick: bool, steps=None, **ngp_kw):
    """The train phase's configuration (machina_ngp.yml, seed TRAIN_SEED):
    ``steps`` (default TRAIN_STEPS) with a refresh every TRAIN_STEPS // 3
    (a full sweep first, then incremental ones); -> (cfg, steps)."""
    import dataclasses

    shrink = 16 if quick else 1
    every = (96 if quick else TRAIN_STEPS) // 3
    if steps is None:
        steps = 96 if quick else TRAIN_STEPS
    elif quick:
        steps = max(steps // 8, 2 * every)
    ngp = dataclasses.replace(
        fx.config.ngp, occ_update_every=every,
        occ_full_every=2048 if not quick else 128, **ngp_kw)
    exp = dataclasses.replace(
        fx.config.experiment, logdir=logdir, id="chip_smoke", print_every=0,
        validate_every=0, save_every=0, train_iters=steps, randomseed=TRAIN_SEED)
    nerf = dataclasses.replace(
        fx.config.nerf, num_random_rays=fx.config.nerf.num_random_rays // shrink)
    return fx.config.replace(ngp=ngp, experiment=exp, nerf=nerf), steps


def build_dataset(fx, engine, aux, dev, quick: bool, size=None):
    """Views of the fixture's trained model, rendered by the port's
    evaluation renderer: 80 for training on five orbits between 5 and 60
    degrees of elevation (the span of the reference scene's training
    cameras), 2 held out. ``size``: the views' side (the focal scales with
    it), by default the fixture's (100 with ``quick``)."""
    from nerf_kinematics_tpu_torch.data.machina import (
        machina_intrinsics, orbit_poses)
    from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays

    if size is None:
        size = 100 if quick else fx.intrinsics.width
    intr = fx.intrinsics if size == fx.intrinsics.width else machina_intrinsics(size)
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
        points = collections.Counter(cuda_lib.POINTS)
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
    return counts, points


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


def profile_steps(trainer, state, n_steps: int = 10, groups=None):
    """torch.profiler over ``n_steps`` train steps: device time by kernel
    group (``groups``: name -> kernel name prefixes; the fast engine's by
    default), the top operations and the device's idle share: busy ms a
    step from the trace over the host-clock ms a step of the same steps run
    without the profiler (the profiler slows the host; the share against
    the profiled wall clock stays beside it)."""
    from torch.profiler import ProfilerActivity, profile

    step = trainer._train_step
    args = (trainer.images, trainer.poses, trainer.ray_buf)
    state = state.clone()  # the steps below must not move the caller's state
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the tracer's own start-up, thrown away
        for _ in range(3):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
    start = state.clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, _ = step(state, *args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    state = start.clone()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups = groups or {
        "hull proposal (row 1)": ("nkt_hull",),
        "coarse density (row 2)": ("nkt_fused_sigma", "nkt_mma_sigma"),
        "fused train objective (row 7)": (
            "nkt_fused_tile", "nkt_fused_apply_save", "nkt_train_rays",
            "nkt_fused_point_bwd", "nkt_cp_encode_bwd", "nkt_wgrad",
            "nkt_reduce_partials"),
        "non-finite checks: table scans, row 5's record and fix-up": NONFINITE_KERNELS}
    by_group, kernels = device_ms_by_group(
        prof, groups, other="PyTorch ops (sampling, compositing, gathers, Adam)")
    busy_ms = sum(by_group.values())
    return {
        "steps": n_steps, "wall_ms": wall_ms, "wall_ms_unprofiled": plain_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / plain_ms) if busy_ms else None,
        "device_idle_share_profiled": max(0.0, 1.0 - busy_ms / wall_ms) if busy_ms else None,
        "ms_per_step_by_group": {k: v / n_steps for k, v in by_group.items()},
        "top": [{"name": k[:80], "ms_per_step": ms / n_steps, "calls": c}
                for k, ms, c in kernels[:12]],
        # each non-finite check's launches a step and device us a launch
        "nonfinite_kernels": {
            name: {"calls_per_step": sum(c for k, _, c in kernels if name in k) / n_steps,
                   "us_per_launch": 1e3 * sum(ms for k, ms, _ in kernels if name in k)
                   / max(1, sum(c for k, _, c in kernels if name in k))}
            for name in NONFINITE_KERNELS},
    }


def phase_train_autodiff(fx, dev, quick: bool, dataset):
    """One step of each of the three routes from the same initial state and
    the same draws; then 16 steps of each autograd route for a time."""
    import dataclasses
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
        points = collections.Counter(cuda_lib.POINTS)
    report["ms_per_step"] = times
    report["launches"] = counts
    report["tolerance"] = {
        "gradients across routes, per leaf, max abs over the leaf's largest entry":
            ROUTE_TOL, "unfused route in bf16 mode": UNFUSED_BF16_TOL}
    emit(report)
    for k in ("ngp_fused_apply_cf_bwd", "cp_encode_bwd", "ngp_fused_train_cf"):
        if counts[k] <= 0:
            raise AssertionError(f"train_autodiff: {k} was not launched")
    return counts, points


# machina400 as configs/machina_ngp.yml's comment generates it: 400x400,
# 100 / 8 / 16 views, 1024 ground-truth samples per ray, seed 7.
SCENE = {"resolution": 400, "n_train": 100, "n_val": 8, "n_test": 16,
         "n_samples": 1024, "seed": 7}
SCENE_QUICK = {"resolution": 100, "n_train": 16, "n_val": 4, "n_test": 2,
               "n_samples": 256, "seed": 7}
SCENE_STEPS = 2048
# The canonical JAX run of configs/machina_ngp.yml on these images
# (logs/machina-ngp/metrics.jsonl): val view 0 at steps 1024 and 2048.
CANONICAL_VAL_DB = {1024: 31.36460424471172, 2048: 33.59586248188184}
# ground-truth val PSNR (view 0) after SCENE_STEPS: the first full-size
# run's 34.06 dB less 2 dB, rounded down; see PERF.md section 6
SCENE_VAL_FLOOR_DB = 32.0
# The whole-step and the two-call route, per leaf over the leaf's largest
# entry. The two place samples by the same formulas written differently
# (a CDF accumulated bin by bin against a cumulative sum, bin edges
# near + b * step against the blended linspace), so depths differ in their
# last bits, which the inverse CDF amplifies in bins of little mass.
SCENE_ROUTE_TOL = {"f32": ROUTE_TOL["f32"], "bf16": 5e-2}


# One step from the trained state through the kernels and through row 8's
# plain version, as Adam takes it (chip_smoke.py::adam_compare), beside the
# kernel's step from the same state nudged by one ulp (seeds 1..): each
# leaf's update distance must stay within SCENE_ADAM_FACTOR times the
# controls' largest reading of that leaf or of the whole buffer, whichever
# is larger. scripts/torch_scene_witness.py read the kernel's distance from
# the plain version's at 0 to 0.017 of that reading at step 1024 of the
# plain route and 0 to 0.46 at step 2048, leaf by leaf (five controls;
# PERF.md section 6).
SCENE_ADAM_CONTROLS = 5
SCENE_ADAM_FACTOR = 2.0


def route_distance(full, other) -> dict:
    """One step of the whole-step route (``full``) against another route
    from the same state and draws: (loss, loss_c, grads, launches) each ->
    the losses' relative distances and the gradients' largest per leaf,
    over the other route's largest entry."""
    rel, bad = {}, {}
    for k, g in other[2].items():
        scale = g.abs().max().item()
        if scale > 0.0 and math.isfinite(scale) and torch.isfinite(full[2][k]).all():
            rel[k] = (full[2][k] - g).abs().max().item() / scale
        else:  # reported, then refused by the caller
            bad[k] = {"other_scale": scale,
                      "full_finite": bool(torch.isfinite(full[2][k]).all())}
    return {"loss": {"full": full[0], "other": other[0]},
            "loss_rel": abs(full[0] - other[0]) / abs(other[0]),
            "loss_coarse_rel": abs(full[1] - other[1]) / abs(other[1]),
            "grad_max_rel": max(rel.values(), default=math.nan),
            "bad_leaves": bad,
            "worst_leaves": sorted(rel.items(), key=lambda kv: -kv[1])[:4]}


def scene_adam_check(trainer, state) -> dict:
    """The step from ``state`` through the kernels against the same step
    with rows 7 and 8 plain, as Adam takes it, beside SCENE_ADAM_CONTROLS
    one-ulp controls of the kernel's step (see SCENE_ADAM_FACTOR)."""
    layout = trainer.engine.layout
    k = adam_step_of(trainer, state)
    kvp = adam_compare(layout, k, adam_step_of(trainer, state, plain_fused_train_rows))
    ctrl = [adam_compare(layout, adam_step_of(trainer, nudged(state, i)), k)
            for i in range(1, SCENE_ADAM_CONTROLS + 1)]
    top = {leaf: max(c[leaf]["update_rel"] for c in ctrl) for leaf in kvp}
    limit = {leaf: SCENE_ADAM_FACTOR * max(top[leaf], top["all"]) for leaf in kvp}
    return {
        "kernel_vs_plain": kvp,
        "controls_update_rel": {leaf: [min(c[leaf]["update_rel"] for c in ctrl), top[leaf]]
                                for leaf in kvp},
        "controls_sign_disagree_max": {leaf: max(c[leaf]["sign_disagree"] for c in ctrl)
                                       for leaf in kvp},
        "controls_zero_mismatch_max": {leaf: max(c[leaf]["zero_mismatch"] for c in ctrl)
                                       for leaf in kvp},
        "limit": limit,
        "over_limit": {leaf: v["update_rel"] for leaf, v in kvp.items()
                       if not v["update_rel"] <= limit[leaf]},
    }


def scene_config(fx, basedir: str, logdir: str, steps: int, quick: bool,
                 fused_train: str = "full"):
    """configs/machina_ngp.yml (the fixture's configuration; the card has no
    PyYAML) with its dataset at ``basedir``, ``ngp.fused_train`` as given,
    validation at every 1024 steps as the canonical run logged it."""
    import dataclasses

    c = fx.config
    exp = dataclasses.replace(
        c.experiment, logdir=logdir, id="chip_smoke_scene", print_every=0,
        validate_every=256 if quick else 1024, save_every=0, train_iters=steps)
    ngp = dataclasses.replace(c.ngp, fused_train=fused_train)
    if quick:
        # The ray count stays: from these weights 512 rays a step fall into
        # the all-white dead state within 16 steps, in the JAX trainer too
        # (PERF.md section 6); 8192 train.
        ngp = dataclasses.replace(ngp, occ_update_every=64, occ_full_every=128)
    return c.replace(dataset=dataclasses.replace(c.dataset, basedir=basedir),
                     experiment=exp, ngp=ngp)


# Row 8's parts by kernel name (either mode's kernels), for the profile.
# The launches that give non-finite inputs the reference's classes: the
# line tables' scan before each encoder launch, row 5's record and fix-up
# (each returns at once on finite inputs).
NONFINITE_KERNELS = ("nkt_table_scan_kernel", "nkt_dl_record_kernel",
                     "nkt_dl_nonfinite_kernel")

ROW8_PARTS = {
    "row 8: sigma pass (row 2's body)": ("nkt_mma_sigma", "nkt_fused_sigma"),
    # bf16 mode: the tile kernel (forward, compositing, backward, weight
    # gradients); f32 mode: the forward with saves and the per-point backward
    "row 8: fine stage (the tile kernel; f32: forward with saves, per-point backward)": (
        "nkt_fused_tile", "nkt_fused_apply_save", "nkt_fused_point_bwd"),
    "row 8: line-table gradient (row 5's kernel)": ("nkt_cp_encode_bwd",),
    # the partial sums (f32 mode: and the weight gradients' kernels)
    "row 8: sums of the partials (f32: weight gradients)": ("nkt_wgrad",
                                                            "nkt_reduce_partials"),
    "row 8: proposal, fine inputs, ray kernel": ("nkf_", "nkt_train_rays"),
    "non-finite checks: table scans, row 5's record and fix-up": NONFINITE_KERNELS,
}


def phase_scene(fx, dev, quick: bool, profile: bool, basedir: str):
    """Training from the images on disk: generate machina400 with the port
    into ``basedir`` (the ``cli`` and ``bench`` phases use it after),
    ``Trainer(cfg)`` with ``ngp.fused_train: full`` from the JAX package's
    seed-42 initial weights for SCENE_STEPS steps, ground-truth PSNR on the
    held-out views against the canonical run, the launch counts, and one
    step of the whole-step and of the two-call route from one state (the
    initial weights, the trained occupancy grid) and one set of draws."""
    from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset
    from nerf_kinematics_tpu_torch.io.convert import params_from_npz
    from nerf_kinematics_tpu_torch.io.fixture import MACHINA_NGP_INIT42
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.loop import build_objective
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    scene = SCENE_QUICK if quick else SCENE
    steps = 256 if quick else SCENE_STEPS
    report = {"phase": "scene", "quick": quick, "scene": scene, "steps": steps}
    with tempfile.TemporaryDirectory() as root:
        # ---- the main path: the scene generator ---------------------------
        t0 = time.perf_counter()
        write_machina_dataset(basedir, **scene)  # device=None: the card
        torch.cuda.synchronize()
        report["generate_seconds"] = time.perf_counter() - t0

        cfg = scene_config(fx, basedir, root, steps, quick)
        t0 = time.perf_counter()
        trainer = Trainer(cfg)  # loads cfg.dataset from disk; the card
        report["load_seconds"] = time.perf_counter() - t0
        ds = trainer.dataset
        report["views"] = [len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)]
        eng = trainer.engine
        eng.load_flax_params(params_from_npz(MACHINA_NGP_INIT42))
        state = eng.init_state(keep_weights=True)  # the step's generator: seed 42
        init_params = state.params.clone()  # fit updates the state in place
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        # ---- the main path: training from disk, held-out renders ----------
        t0 = time.perf_counter()
        res = trainer.fit(state=state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = dict(cuda_lib.LAUNCHES)
        points = collections.Counter(cuda_lib.POINTS)
        # -------------------------------------------------------------------
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        val = trainer.validate(res.state)
        split = trainer.evaluate_split(res.state, "val")
        with open(os.path.join(trainer.rundir, "metrics.jsonl")) as f:
            val_log = {r["step"]: r["value"] for r in map(json.loads, f)
                       if r["tag"] == "val/psnr"}
        # the whole step twice from one cloned state: the same parameters
        # and Adam moments, bit for bit (the line tables' gradient too)
        step = trainer._train_step
        args = (trainer.images, trainer.poses, trainer.ray_buf)
        twins = [step(res.state.clone(), *args)[0] for _ in range(2)]
        torch.cuda.synchronize()
        step_same = all(torch.equal(getattr(twins[0], k), getattr(twins[1], k))
                        for k in ("params", "step")) and all(
            torch.equal(getattr(twins[0].opt_state, k), getattr(twins[1].opt_state, k))
            for k in ("mu", "nu"))
        changed = not torch.equal(twins[0].params, res.state.params)
        del twins
        prof = profile_steps(trainer, res.state, groups=ROW8_PARTS) \
            if profile else None
        if prof is not None:
            prof["row_8_ms_per_step"] = sum(
                prof["ms_per_step_by_group"][k] for k in ROW8_PARTS)

        # ---- one step of the two routes from one state and one set of
        # draws: the initial weights, whose gradients are large, and the
        # trained grid, which shapes the proposal. At the trained weights
        # the loss is small and each gradient entry a sum that cancels, so
        # bf16 roundings that the two routes' last bits flip weigh up to 10 %
        # of a leaf there (quick run, PERF.md section 6).
        n_rays = cfg.nerf.num_random_rays
        t = cfg.nerf.train
        gen = torch.Generator(device=dev).manual_seed(31)
        sl = slice(2000, 2000 + n_rays)
        d = trainer.ray_buf["rays_d"][sl]
        batch = (trainer.ray_buf["rays_o"][sl], d,
                 d / torch.linalg.norm(d, dim=-1, keepdim=True),
                 trainer.ray_buf["target"][sl])
        u_c = torch.rand((n_rays, t.num_coarse), generator=gen, device=dev)
        u_f = torch.rand((n_rays, t.num_fine), generator=gen, device=dev)
        # the whole step against the two-call route and, outside the tile
        # kernel that both run, against row 8's plain version
        routes = {}
        for mode in ("f32", "bf16"):
            for name, fused_train in (("full", "full"), ("two_call", "on"),
                                      ("plain", "full")):
                c = scene_config(fx, basedir, root, steps, quick, fused_train=fused_train)
                c = c.replace(ngp=_replace_cp(c.ngp, use_bf16=mode == "bf16"))
                e = NGPEngine(c, 1.0)
                e.layout.bind(e.model, init_params)
                cuda_lib.reset_launch_counts()
                with plain_fused_train_rows() if name == "plain" else \
                        contextlib.nullcontext():
                    (loss, (loss_c, _)), grads = build_objective(e, ds.near, ds.far)(
                        batch, res.state.aux, None, u_coarse=u_c, u_fine=u_f)
                torch.cuda.synchronize()
                routes[mode, name] = (float(loss), float(loss_c), grads,
                                      dict(cuda_lib.LAUNCHES))
        # ---- one step from the trained state as Adam takes it: the kernel's
        # update against the plain version's, beside one-ulp controls
        adam = scene_adam_check(trainer, res.state)
        trainer.close()

    route_rep = {}
    for mode in ("f32", "bf16"):
        full = routes[mode, "full"]
        route_rep[mode] = {other: route_distance(full, routes[mode, other])
                           for other in ("two_call", "plain")}
        route_rep[mode]["launches"] = {
            "full": full[3]["ngp_fused_train_full_cf"],
            "two_call": routes[mode, "two_call"][3]["ngp_fused_train_cf"],
            "plain": sum(routes[mode, "plain"][3][k] for k in (
                "ngp_fused_train_full_cf", "ngp_fused_train_cf"))}
    losses = np.asarray(res.losses)
    ms_per_step = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
    floor = None if quick else SCENE_VAL_FLOOR_DB
    report.update({
        "train_seconds_fit": fit_s, "ms_per_step": ms_per_step,
        "rays_per_s": n_rays / ms_per_step * 1e3,
        "loss_first16": float(losses[:16].mean()), "loss_last64": float(losses[-64:].mean()),
        "val_psnr_db_by_step": val_log, "canonical_val_psnr_db_by_step": CANONICAL_VAL_DB,
        "val_psnr_db": val["val_psnr"], "val_mean_psnr_db": split["mean_psnr"],
        "val_psnr_per_view_db": split["per_frame"], "val_psnr_floor_db": floor,
        "occupancy_refreshes": [[i, k, s * 1e3] for i, k, s in res.occupancy_refreshes],
        "launches": counts, "peak_memory_gib": peak_gb,
        "routes": route_rep, "routes_tolerance": {"grad": SCENE_ROUTE_TOL, "loss": 1e-3},
        "adam_update": adam, "step_twice_bit_identical": step_same,
    })
    if prof is not None:
        report["profile"] = prof
    emit(report)
    if not (np.isfinite(losses).all() and np.isfinite(split["mean_psnr"])):
        raise AssertionError("scene: non-finite loss or PSNR")
    # one row-8 launch a step; rows 7, 2 and the hull only in the held-out
    # renders, where every chunk launches the hull, row 2 and row 3 once
    evals = counts["ngp_fused_apply_cf"]
    want = {"ngp_fused_train_full_cf": steps, "ngp_fused_train_cf": 0,
            "ngp_fused_sigma_cf": evals, "occupancy_at_hull": evals,
            "ngp_fused_apply_cf_bwd": 0, "cp_encode_bwd": 0}
    got = {k: counts[k] for k in want}
    if got != want or evals <= 0:
        raise AssertionError(f"scene: launches {got}, expected {want}")
    for mode, r in route_rep.items():
        if r["launches"] != {"full": 1, "two_call": 1, "plain": 0}:
            raise AssertionError(f"scene: the routes took other paths: {r}")
        for other in ("two_call", "plain"):
            d = r[other]
            if d["bad_leaves"]:
                raise AssertionError(f"scene ({mode}, {other}): zero or non-finite "
                                     f"gradients {d['bad_leaves']}")
            if not (d["grad_max_rel"] <= SCENE_ROUTE_TOL[mode] and d["loss_rel"] <= 1e-3
                    and d["loss_coarse_rel"] <= 1e-3):
                raise AssertionError(f"scene ({mode}): the whole step and {other} "
                                     f"differ: {d}")
    if adam["over_limit"]:
        raise AssertionError(f"scene: the kernel's Adam update lies beyond "
                             f"{SCENE_ADAM_FACTOR} x the one-ulp controls' from the "
                             f"plain version's: {adam['over_limit']}")
    if not (step_same and changed):
        raise AssertionError(f"scene: two steps from one state differ ({step_same}) "
                             f"or moved nothing ({not changed})")
    if not float(losses[-64:].mean()) < 0.5 * float(losses[:16].mean()):
        raise AssertionError("scene: the loss did not fall")
    if floor is not None and not val["val_psnr"] >= floor:
        raise AssertionError(f"scene: val PSNR {val['val_psnr']:.2f} dB under {floor}")
    return counts, points


# ---- the halo scene: configs/fox_ngp.yml on a contracted scene --------------

# fox49's images are not in the repository; the JAX package's stand-in for
# its regime is the halo scene: a unit-scale subject and satellites out to
# radius ~7, aabb_scale 32 (bound 16, inner 4), so contraction switches on.
HALO_SCENE = {"n_views": 49, "resolution": 128}  # fox49: 47 train + 2 val views
HALO_SCENE_QUICK = {"n_views": 9, "resolution": 48}
HALO_QUICK = {"steps": 256, "hash_steps": 64, "mesh_res": 64}  # --quick
HALO_STEPS = 1000          # a full sweep at 256, incremental refreshes at 512, 768
HALO_HASH_STEPS = 300
HALO_TWO_CALL_STEPS = 50
HALO_LOSS_RATIO = 0.35     # last step's loss / first's, tests/test_contraction.py:140
# The CP encoder's routes of this recipe fall to an all-black prediction's
# loss within a few steps on the halo scene (a black background), through
# the rows' plain versions on the card and through the JAX package's fused
# route as well (PERF.md section 6, ROADMAP C): a val PSNR there is the
# all-black image's (11.59 dB) and holds nothing, so the fused route has no
# floor. It is held instead to its plain versions step for step through the
# fall (from one fresh state and the same draws), and rows 3-6 at the fresh,
# the falling and the trained weights. The floors below are for routes that
# train, from the first full run less about half a dB; both lie above 11.59.
HALO_VAL_FLOOR_DB = {"cp_unfused": 14.3, "hash": 13.5}  # 14.90, 14.08 measured
HALO_LOCKSTEP_STEPS = 40   # the fused route's first steps, through kernels and plain versions
# |loss through the kernels / through the plain versions - 1| at each step:
# 8.9e-7 measured; dropping row 6's density cotangent moves it to 1.4e-5
# (scripts/torch_halo_probe.py --lockstep 40; PERF.md section 6)
HALO_LOCKSTEP_TOL = 5e-6
HALO_FALLING_STEP = 20     # rows 3-6 are also held at the weights after this many steps
HALO_DARK_LOSS = 0.5       # a live route's last losses stay under this share of all-black's
HALO_MESH_RES = 256        # instant-ngp's --save_mesh defaults
HALO_MESH_ISO = 2.5
MESH_VERT_TOL = 1e-5       # native core against its numpy version, abs

# the kernel table's rows by the name each wrapper counts under
ROW_OF = {"occupancy_at_hull": 1, "ngp_fused_sigma_cf": 2, "ngp_fused_apply_cf": 3,
          "cp_encode": 4, "cp_encode_bwd": 5, "ngp_fused_apply_cf_bwd": 6,
          "ngp_fused_train_cf": 7, "ngp_fused_train_full_cf": 8,
          "classic_fused_apply_cf": 9, "classic_fused_apply_cf_bwd": 10}


def by_row(counts: dict, points) -> dict:
    """Launches by kernel row; row 5 also as the points it walked inside the
    fused gradient launches (rows 6-8 launch it on their stream)."""
    rows = {f"row {ROW_OF[k]}": v for k, v in counts.items()}
    rows["row 5 inside rows 6-8, points"] = sum(
        v for (name, _), v in points.items() if name == "cp_encode_bwd_in_fused")
    return rows


def halo_config(root: str, steps: int, quick: bool):
    """configs/fox_ngp.yml as shipped, read by the port's YAML reader, with
    the cuts this phase makes (returned beside it, each as [shipped, here]).
    Its dataset section (cache/fox49) is replaced by the halo scene, which
    the phase hands the trainer."""
    from nerf_kinematics_tpu_torch.train.config import load_config

    lines = {"logdir": os.path.join(root, "logs"), "train_iters": steps,
             "validate_every": 0, "save_every": 0, "print_every": 0}
    cuts = {"experiment.train_iters": [25000, steps], "experiment.validate_every": [1000, 0],
            "experiment.save_every": [5000, 0], "experiment.print_every": [500, 0],
            "dataset": ["cache/fox49 (49 views)", "the halo scene"]}
    if quick:
        lines["num_random_rays"] = 2048
        cuts["nerf.train.num_random_rays"] = [16384, 2048]
    cfg = load_config(copy_config("fox_ngp.yml", root, **lines))
    return cfg, cuts


def halo_fit(cfg, ds, dev, state=None):
    """Trainer.fit from a fresh state (the YAML's seed), or on from
    ``state`` for the config's train_iters more steps, then validation;
    -> (report, trainer, result, counts, points)."""
    import dataclasses

    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    if state is not None:
        cfg = cfg.replace(experiment=dataclasses.replace(
            cfg.experiment, train_iters=int(state.step) + cfg.experiment.train_iters))
    trainer = Trainer(cfg, ds, device=dev)
    state = trainer.engine.init_state() if state is None else state.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    # ---- the main path: training and the held-out renders ------------------
    t0 = time.perf_counter()
    res = trainer.fit(state=state)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)
    points = collections.Counter(cuda_lib.POINTS)
    # -------------------------------------------------------------------------
    val = trainer.validate(res.state)
    split = trainer.evaluate_split(res.state, "val")
    losses = np.asarray(res.losses)
    ms = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
    n_rays = cfg.nerf.num_random_rays
    t = cfg.nerf.train
    report = {
        "encoder": trainer.engine.ngp_config.resolved_encoder(),
        "contracted": trainer.engine.contracted, "inner": trainer.engine._inner,
        "steps": len(losses), "rays_per_step": n_rays,
        "samples_per_ray": [t.num_coarse, t.num_fine],
        "fused": trainer.engine.fused,
        "objective": "two-call" if trainer.engine.fused_objective_fn(
            ds.near, ds.far, t) is not None else "autograd",
        "ms_per_step": ms, "rays_per_s": n_rays / ms * 1e3, "fit_seconds": fit_s,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "loss_first16": float(losses[:16].mean()), "loss_last16": float(losses[-16:].mean()),
        "val_psnr_db": val["val_psnr"], "val_mean_psnr_db": split["mean_psnr"],
        "occupancy_refreshes_ms": [[i, k, s * 1e3] for i, k, s in res.occupancy_refreshes],
        "launches_by_row": by_row(counts, points),
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    if not (np.isfinite(losses).all() and np.isfinite(split["mean_psnr"])):
        raise AssertionError(f"halo ({report['encoder']}): non-finite loss or PSNR")
    return report, trainer, res, counts, points


@contextlib.contextmanager
def plain_fused_rows():
    """The fused module route with rows 3 and 6 through their plain versions
    on the card (row 5 inside row 6's with them); restored on exit. Nothing
    is launched or counted in between."""
    from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf

    saved = nf._fused_forward, nf.ngp_fused_apply_cf_bwd
    nf._fused_forward, nf.ngp_fused_apply_cf_bwd = (
        nf.ngp_fused_apply_cf_ref, nf.ngp_fused_apply_cf_bwd_ref)
    try:
        yield
    finally:
        nf._fused_forward, nf.ngp_fused_apply_cf_bwd = saved


@contextlib.contextmanager
def plain_fused_train_rows():
    """The fused objectives with rows 7 and 8 through their plain versions
    on the card (``ngp_fused_train_cf_ref``, ``ngp_fused_train_full_cf_ref``:
    rows 1, 2 and 5 inside them plain too); restored on exit. Nothing is
    launched or counted in between."""
    from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf
    from nerf_kinematics_tpu_torch.train import ngp_engine

    names = ("ngp_fused_train_cf", "ngp_fused_train_full_cf")
    saved = [getattr(ngp_engine, k) for k in names]
    for k in names:
        setattr(ngp_engine, k, getattr(nf, k + "_ref"))
    try:
        yield
    finally:
        for k, fn in zip(names, saved):
            setattr(ngp_engine, k, fn)


def nudged(state, seed: int):
    """A clone of ``state`` with one ulp added to or taken from a random half
    of its weights (numpy seed ``seed``), as :func:`mesh_controls` nudges."""
    st = state.clone()
    rng = np.random.default_rng(seed)
    n = st.params.numel()
    pick = torch.as_tensor(rng.random(n) < 0.5, device=st.params.device)
    toward = torch.as_tensor(np.where(rng.random(n) < 0.5, np.inf, -np.inf),
                             dtype=torch.float32, device=st.params.device)
    st.params.copy_(torch.where(pick, torch.nextafter(st.params, toward), st.params))
    return st


def adam_step_of(trainer, state, route=contextlib.nullcontext):
    """One train step from a clone of ``state`` (its batch and draws: the
    state's generator) under the context manager ``route``: -> (the flat
    gradient as Adam takes it, before the decay term, and the step's change
    of the parameters)."""
    from nerf_kinematics_tpu_torch.train import loop

    seen = {}
    real = loop.adam_update

    def spy(params, grads, *args, **kw):
        seen["g"] = grads.clone()
        before = params.clone()
        real(params, grads, *args, **kw)
        seen["delta"] = params - before

    s = state.clone()
    loop.adam_update = spy
    try:
        with route():
            trainer._train_step(s, trainer.images, trainer.poses, trainer.ray_buf)
    finally:
        loop.adam_update = real
    return seen["g"], seen["delta"]


def adam_compare(layout, a, b) -> dict:
    """Two (gradient, parameter change) pairs of one step from one state, as
    Adam saw them, leaf by leaf: entries exactly 0 in one gradient and not in
    the other, entries whose signs disagree (both non-zero), and the
    relative distance |delta_a - delta_b| / |delta_b| of the two updates
    under the state's own moments; ``all``: over the whole buffer."""
    ga, da = a
    gb, db = b
    out = {}
    for name, _shape, off, numel in (*layout.entries, ("all", None, 0, ga.numel())):
        sl = slice(off, off + numel)
        x, y = ga[sl], gb[sl]
        nb = torch.linalg.vector_norm(db[sl]).item()
        out[name] = {
            "n": numel,
            "zero_mismatch": int(((x == 0) != (y == 0)).sum()),
            "sign_disagree": int((torch.sign(x) * torch.sign(y) < 0).sum()),
            "update_rel": (torch.linalg.vector_norm(da[sl] - db[sl]).item() / nb
                           if nb > 0 else 0.0 if torch.equal(da[sl], db[sl]) else math.inf),
        }
    return out


def halo_lockstep(trainer, state0, steps: int, routes=None) -> tuple:
    """The fused route's first ``steps`` steps from one fresh state, through
    the kernels and through their plain versions (and through any other
    ``routes``: name -> context manager), with the same draws (the step's
    generator is part of the state): each route's losses and their largest
    relative distance from the plain versions'; and the kernel route's
    state after HALO_FALLING_STEP steps."""
    routes = {"kernels": contextlib.nullcontext, "plain": plain_fused_rows, **(routes or {})}
    args = (trainer.images, trainer.poses, trainer.ray_buf)
    losses, falling = {}, None
    for route, ctx in routes.items():
        s = state0.clone()
        losses[route] = []
        with ctx():
            for i in range(steps):
                s, m = trainer._train_step(s, *args)
                losses[route].append(float(m["loss"]))
                if route == "kernels" and i + 1 == HALO_FALLING_STEP:
                    falling = s.clone()
    rep = {"losses": losses, "max_rel_diff": {
        route: max(abs(a / b - 1.0) for a, b in zip(losses[route], losses["plain"]))
        for route in losses if route != "plain"}}
    return rep, falling


def halo_points(trainer, state, gen):
    """One step's rays (the ray buffer's first num_random_rays) at the depths
    its occupancy proposal places from ``state``, in contracted unit
    coordinates, ray-major: -> (x (n, 3), xt (3, n), vdt (3, n), z (R, S))."""
    eng, cfg, ds = trainer.engine, trainer.cfg, trainer.dataset
    n_rays = cfg.nerf.num_random_rays
    o = trainer.ray_buf["rays_o"][:n_rays]
    d = trainer.ray_buf["rays_d"][:n_rays]
    z = eng.proposal_for(state.aux, ds.near, ds.far, cfg.nerf.train, gen)(o, d)
    x = eng._to_unit(o[:, None, :] + d[:, None, :] * z[..., None]).reshape(-1, 3)
    vd = (d / torch.linalg.norm(d, dim=-1, keepdim=True))[:, None, :].expand(
        -1, z.shape[1], -1).reshape(-1, 3)
    return x, x.T.contiguous(), vd.T.contiguous(), z


def halo_kernels(trainer, state, dev, timed: bool = True) -> dict:
    """Rows 3, 4, 5 and 6 at the halo path's own shape, which the kernel
    phases do not hold (they take the flagship's encoder, and fox's with
    the hash fold for rows 4 and 5 only): fox's encoder as shipped (L 5,
    C 96, T 256, periodic fold, bf16), the weights of ``state``, and one
    step's 16384 rays x 64 depths placed by its occupancy proposal, in
    contracted coordinates (1.05 M points: row 6 in two launches). Each
    against its plain version with the kernel phases' tolerances, row 6
    twice for the same bits; the share of points whose density is not
    clamped (sigma = exp(clip(z0, -15, 15)): only there does row 6 carry a
    density gradient); with times when ``timed``."""
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import (
        cp_encode_cuda, cp_encode_cuda_bwd, cp_encode_cuda_bwd_ref, cp_encode_cuda_ref)
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_bwd, ngp_fused_apply_cf_bwd_ref,
        ngp_fused_apply_cf_ref)

    eng = trainer.engine
    cp = eng.ngp_config.cp
    gen = torch.Generator(device=dev).manual_seed(77)
    with torch.no_grad(), eng.bound(state.params):
        x, xt, vdt, _ = halo_points(trainer, state, gen)
        params = eng._fused_params(detach=True)
        lines = params["lines"]
        n = xt.shape[1]
        g4 = torch.randn((4, n), generator=gen, device=dev)
        g_enc = torch.randn((n, cp.out_dim), generator=gen, device=dev)
        rep = {"points": n, "cp": cp_label(cp),
               "contracted_unit_range": [x.min().item(), x.max().item()]}
        out, ref = ngp_fused_apply_cf(params, xt, vdt, cp), ngp_fused_apply_cf_ref(params, xt, vdt, cp)
        mx, mean, rel = fused_errors(out, ref, True)
        lo, hi = torch.exp(torch.tensor([-15.0, 15.0], device=dev))
        rep["unclamped_density_share"] = ((ref[3] > lo) & (ref[3] < hi)).float().mean().item()
        rep["row 3"] = {"max_abs_err": mx, "mean_abs_err": mean, "max_rel_sigma": rel}
        del out, ref
        k = ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp)
        k2 = ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp)
        p = ngp_fused_apply_cf_bwd_ref(params, xt, vdt, g4, cp)
        rep["row 6"] = {"max_rel_err_by_leaf": {k_: v["max_rel"] for k_, v in
                                                grad_errors(k, p).items()},
                        "twice_bit_identical": all(torch.equal(a, b) for (_, a), (_, b)
                                                   in zip(_leaf_list(k), _leaf_list(k2)))}
        del k, k2, p
        e_k, e_p = cp_encode_cuda(lines, x, cp), cp_encode_cuda_ref(lines, x, cp)
        rep["row 4"] = {"max_abs_err": (e_k - e_p).abs().max().item()}
        del e_k, e_p
        k5, p5 = cp_encode_cuda_bwd(lines, x, g_enc, cp), cp_encode_cuda_bwd_ref(lines, x, g_enc, cp)
        rep["row 5"] = {"max_rel_err": (k5 - p5).abs().max().item() / p5.abs().max().item()}
        del k5, p5
        if timed:
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            rep["ms"] = {
                "row 3": time_ms(lambda: ngp_fused_apply_cf(params, xt, vdt, cp), KERNEL_REPS, 2, flush),
                "row 3 plain": time_ms(lambda: ngp_fused_apply_cf_ref(params, xt, vdt, cp), 2, 1, flush),
                "row 6": time_ms(lambda: ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp),
                                 KERNEL_REPS, 2, flush),
                "row 6 plain": time_ms(lambda: ngp_fused_apply_cf_bwd_ref(params, xt, vdt, g4, cp),
                                       2, 1, flush),
                "row 4": time_ms(lambda: cp_encode_cuda(lines, x, cp), KERNEL_REPS, 2, flush),
                "row 4 plain": time_ms(lambda: cp_encode_cuda_ref(lines, x, cp), 2, 1, flush),
                "row 5": time_ms(lambda: cp_encode_cuda_bwd(lines, x, g_enc, cp), KERNEL_REPS, 2, flush),
                "row 5 plain": time_ms(lambda: cp_encode_cuda_bwd_ref(lines, x, g_enc, cp), 2, 1, flush),
            }
    bad = []
    if not (rep["row 3"]["mean_abs_err"] <= FUSED_MEAN_TOL
            and rep["row 3"]["max_abs_err"] <= FUSED_MAX_TOL):
        bad.append("row 3")
    if not (max(rep["row 6"]["max_rel_err_by_leaf"].values()) <= GRAD_TOL["bf16"]
            and rep["row 6"]["twice_bit_identical"]):
        bad.append("row 6")
    if not rep["row 4"]["max_abs_err"] <= 1e-6:
        bad.append("row 4")
    if not rep["row 5"]["max_rel_err"] <= GRAD_TOL["bf16"]:
        bad.append("row 5")
    rep["failed"] = bad
    return rep


F32_FWD_TOL = 2e-3  # the kernel phases' f32 mode: max abs of rgb logits and log sigma


def leaf_rel_errors(got: dict, want: dict) -> dict:
    """grad_errors' max_rel of each leaf, where a leaf the plain version
    gives all zero (fox's route at its dark trained weights: no density
    and no live unit reach the tables) must be all zero in the kernel's
    too (0.0, else inf)."""
    rep = {}
    for (name, a), (_, b) in zip(_leaf_list(got), _leaf_list(want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name}: shape {tuple(a.shape)} or non-finite gradient")
        scale = b.abs().max().item()
        rep[name] = ((a - b).abs().max().item() / scale if scale
                     else 0.0 if not a.abs().max().item() else math.inf)
    return rep


def halo_f32_kernels(trainer, state, dev, timed: bool = True) -> dict:
    """Rows 2, 3, 6 and 7 in f32 mode (``ngp.cp.use_bf16: false``: the FMA
    bodies, which stage W0 level by level) at fox's encoder (L 5, C 96,
    T 256: a first layer of 480 x 64), the weights of ``state`` and the
    points of halo_points (16384 rays x 64 depths, 1.05 M points), each
    against its plain version with the kernel phases' f32 tolerances: rows
    2 and 3 max abs F32_FWD_TOL, rows 6 and 7 GRAD_TOL["f32"] a leaf, row
    7's err and maps TRAIN_OUT_TOL; rows 6 and 7 twice for the same bits."""
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_bwd, ngp_fused_apply_cf_bwd_ref,
        ngp_fused_apply_cf_ref, ngp_fused_sigma_cf, ngp_fused_sigma_cf_ref,
        ngp_fused_train_cf, ngp_fused_train_cf_ref)

    eng = trainer.engine
    cp = dataclasses.replace(eng.ngp_config.cp, use_bf16=False)
    gen = torch.Generator(device=dev).manual_seed(78)
    with torch.no_grad(), eng.bound(state.params):
        _, xt, vdt, z = halo_points(trainer, state, gen)
        params = eng._fused_params(detach=True)
        R, S = z.shape
        n = xt.shape[1]
        dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)],
                          dim=-1).reshape(1, n).contiguous()
        tgt = torch.rand((3, R), generator=gen, device=dev)
        g4 = torch.randn((4, n), generator=gen, device=dev)
        g4[3] *= 1e-3  # as the grad_kernels phase: sigma reaches e^15
        inv = 1.0 / (3.0 * R)
        rep = {"points": n, "rays": R, "samples": S, "cp": cp_label(cp)}
        for row, kern, plain, color in (
                ("row 2", lambda: ngp_fused_sigma_cf(params, xt, cp),
                 lambda: ngp_fused_sigma_cf_ref(params, xt, cp), False),
                ("row 3", lambda: ngp_fused_apply_cf(params, xt, vdt, cp),
                 lambda: ngp_fused_apply_cf_ref(params, xt, vdt, cp), True)):
            k, p = kern(), plain()
            mx, mean, _ = fused_errors(k, p, color)
            rep[row] = {"max_abs_err": mx, "mean_abs_err": mean}
            del k, p
        k = ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp)
        k2 = ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp)
        p = ngp_fused_apply_cf_bwd_ref(params, xt, vdt, g4, cp)
        rep["row 6"] = {"max_rel_err_by_leaf": leaf_rel_errors(k, p),
                        "twice_bit_identical": all(torch.equal(a, b) for (_, a), (_, b)
                                                   in zip(_leaf_list(k), _leaf_list(k2)))}
        del k, k2, p
        ek, mk, k = ngp_fused_train_cf(params, xt, vdt, dists, tgt, cp, S, False, inv)
        k2 = ngp_fused_train_cf(params, xt, vdt, dists, tgt, cp, S, False, inv)[2]
        ep, mp, p = ngp_fused_train_cf_ref(params, xt, vdt, dists, tgt, cp, S, False, inv)
        rep["row 7"] = {"max_rel_err_by_leaf": leaf_rel_errors(k, p),
                        "err_maps_max_abs_err": max((ek - ep).abs().max().item(),
                                                    (mk - mp).abs().max().item()),
                        "twice_bit_identical": all(torch.equal(a, b) for (_, a), (_, b)
                                                   in zip(_leaf_list(k), _leaf_list(k2)))}
        del ek, mk, k, k2, ep, mp, p
        if timed:
            flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
            rep["ms"] = {
                "row 2": time_ms(lambda: ngp_fused_sigma_cf(params, xt, cp), KERNEL_REPS, 2, flush),
                "row 2 plain": time_ms(lambda: ngp_fused_sigma_cf_ref(params, xt, cp), 2, 1, flush),
                "row 3": time_ms(lambda: ngp_fused_apply_cf(params, xt, vdt, cp), KERNEL_REPS, 2, flush),
                "row 3 plain": time_ms(lambda: ngp_fused_apply_cf_ref(params, xt, vdt, cp), 2, 1, flush),
                "row 6": time_ms(lambda: ngp_fused_apply_cf_bwd(params, xt, vdt, g4, cp),
                                 KERNEL_REPS, 2, flush),
                "row 6 plain": time_ms(lambda: ngp_fused_apply_cf_bwd_ref(params, xt, vdt, g4, cp),
                                       2, 1, flush),
                "row 7": time_ms(lambda: ngp_fused_train_cf(params, xt, vdt, dists, tgt, cp, S,
                                                            False, inv), KERNEL_REPS, 2, flush),
                "row 7 plain": time_ms(lambda: ngp_fused_train_cf_ref(
                    params, xt, vdt, dists, tgt, cp, S, False, inv), 2, 1, flush),
            }
            # bound at the f32 FMA rate, as the bodies run: MLP products and
            # the encoder's taps; inputs read and outputs written once
            Ws = params["dW"] + params["cW"]
            enc = cp.out_dim * 12
            fl = {"row 2": n * (mlp_flops(params["dW"]) + enc),
                  "row 3": n * (mlp_flops(Ws) + enc)}
            fl["row 6"] = 3 * fl["row 3"]
            fl["row 7"] = fl["row 6"] + n * 120
            io = {"row 2": n * 28 + param_bytes(params, False),
                  "row 3": n * 40 + param_bytes(params, True),
                  "row 6": n * 56 + 2 * param_bytes(params, True),
                  "row 7": n * 28 + R * 32 + 2 * param_bytes(params, True)}
            rep["bound_ms"] = {r: bound_ms(io[r], fl[r], "f32")[0] for r in fl}
    bad = [r for r in ("row 2", "row 3") if not rep[r]["max_abs_err"] <= F32_FWD_TOL]
    for r in ("row 6", "row 7"):
        if not (max(rep[r]["max_rel_err_by_leaf"].values()) <= GRAD_TOL["f32"]
                and rep[r]["twice_bit_identical"]):
            bad.append(r)
    if not rep["row 7"]["err_maps_max_abs_err"] <= TRAIN_OUT_TOL:
        bad.append("row 7 err / maps")
    rep["failed"] = bad
    return rep


def f32_smem_bytes(engines: dict, dev) -> dict:
    """Bytes of shared memory each f32 launcher asks for (the library's own
    queries, which the launches use): row 2, row 3, and the largest of the
    gradient kernels (rows 6-8: the forward with saves and the per-point
    backward), for each engine's MLPs and encoder."""
    import ctypes

    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import _fused_args

    lib = cuda_lib.load_library()
    xt = torch.rand((3, 256), device=dev)
    rep = {}
    for name, eng in engines.items():
        cp = dataclasses.replace(eng.ngp_config.cp, use_bf16=False)
        params = eng._fused_params(detach=True)
        out = torch.empty((4, 256), device=dev)
        a, keep = _fused_args(params, xt, xt, out, cp, True)
        sizes = (ctypes.c_longlong * 6)()
        lib.nkt_fused_bwd_sizes(ctypes.byref(a), sizes)
        rep[name] = {"cp": cp_label(cp),
                     "row 2": int(lib.nkt_fused_smem_bytes(ctypes.byref(a), 0)),
                     "row 3": int(lib.nkt_fused_smem_bytes(ctypes.byref(a), 1)),
                     "rows 6-8": int(sizes[3]), "limit": cuda_lib.SMEM_LIMIT}
        del keep
    return rep


def hash_nan_on_card(grid, dev) -> dict:
    """The hash encoder (fox's reference-exact grid) on 8 seeded points, one
    with a NaN coordinate, on the CPU and on the card, as
    tests/test_torch_hashgrid.py::test_nan_coordinate_matches_jax holds the
    CPU against the JAX package: every feature of that point NaN and no
    other; the table gradient NaN on exactly the rows of the point's eight
    corners at every level (cell 0 along the NaN axis); the card's masks
    equal the CPU's and its finite values within 1e-5."""
    from nerf_kinematics_tpu_torch.ops import hashgrid

    rng = np.random.default_rng(11)
    L, T, F = grid.n_levels, grid.table_size, grid.n_features
    table = rng.uniform(-1e-4, 1e-4, (L, T, F)).astype(np.float32)
    x = rng.random((8, 3)).astype(np.float32)
    x[3, 1] = np.nan
    got = {}
    for where in ("cpu", dev):
        t = torch.tensor(table, device=where, requires_grad=True)
        f = hashgrid.hash_encode(t, torch.tensor(x, device=where), grid)
        f.backward(torch.ones_like(f))
        got[str(where)] = (f.detach().cpu().numpy(), t.grad.cpu().numpy())
    (fc, gc), (fg, gg) = got["cpu"], got[str(dev)]
    # the rows of point 3's corners, its NaN axis in cell 0
    x3 = np.nan_to_num(x[3:4], nan=0.0)
    want = set()
    corners = torch.as_tensor(hashgrid._CORNERS)
    for l, res in enumerate(grid.resolutions):
        c0 = np.clip(np.floor(x3 * res).astype(np.int64), 0, res - 1)
        idx = hashgrid._level_indices(torch.as_tensor(c0)[:, None, :] + corners[None], res, T)
        want.update((idx.reshape(-1) + l * T).tolist())
    nan_rows = set(np.flatnonzero(np.isnan(gg).any(-1).reshape(-1)).tolist())
    feat_mask = np.isnan(fg).any(-1)
    fin_c, fin_g = ~np.isnan(gc), ~np.isnan(gg)
    rep = {
        "point_all_nan": bool(np.isnan(fg[3]).all()),
        "other_points_finite": bool(feat_mask.sum() == 1),
        "nan_rows": len(nan_rows), "corner_rows": len(want),
        "nan_rows_are_corner_rows": nan_rows == want,
        "feature_masks_equal_cpu": bool(np.array_equal(np.isnan(fg), np.isnan(fc))),
        "grad_masks_equal_cpu": bool(np.array_equal(fin_g, fin_c)),
        "features_max_abs_diff_cpu": float(np.abs(np.delete(fg, 3, 0) - np.delete(fc, 3, 0)).max()),
        "grad_max_abs_diff_cpu": float(np.abs(gg[fin_g & fin_c] - gc[fin_g & fin_c]).max()),
    }
    rep["ok"] = bool(rep["point_all_nan"] and rep["other_points_finite"]
                     and rep["nan_rows_are_corner_rows"] and rep["feature_masks_equal_cpu"]
                     and rep["grad_masks_equal_cpu"] and rep["features_max_abs_diff_cpu"] <= 1e-5
                     and rep["grad_max_abs_diff_cpu"] <= 1e-5)
    return rep


def step_twice(trainer, state) -> bool:
    """The whole step twice from one cloned state: the same parameters and
    Adam moments, bit for bit, and the parameters moved."""
    args = (trainer.images, trainer.poses, trainer.ray_buf)
    twins = [trainer._train_step(state.clone(), *args)[0] for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(getattr(twins[0], k), getattr(twins[1], k))
               for k in ("params", "step")) and all(
        torch.equal(getattr(twins[0].opt_state, k), getattr(twins[1].opt_state, k))
        for k in ("mu", "nu"))
    return same and not torch.equal(twins[0].params, state.params)


def phase_halo(dev, quick: bool):
    """configs/fox_ngp.yml at full width on the halo scene, the stand-in for
    fox49: 49 views of 128x128 generated on the card; ``Trainer.fit`` of the
    shipped cp_pallas recipe (L 5, C 96, T 256, 16384 rays x 64 coarse
    samples, shuffled sampler, 96^3 occupancy) on the contracted scene, on
    its fused route (rows 3 and 6) and with ``ngp.fused: off`` (rows 4 and
    5 under autograd); rows 3-6 at this shape against their plain versions
    at the fresh, the falling and the trained weights, and the fused
    route's first steps through the kernels against the same steps through
    their plain versions; the recipe with ``encoder: hash`` at the
    reference-exact grid, and the whole step twice from one state; the
    contracted two-call step (48 + 48 samples) on from the unfused route's
    trained state; a 256^3 mesh from the unfused route's model by the
    native core, held to its numpy version."""
    import dataclasses

    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.export.mesh import (
        extract_mesh, extract_mesh_from_engine, extract_mesh_ref)
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.loop import eval_params
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    scene = HALO_SCENE_QUICK if quick else HALO_SCENE
    steps = HALO_QUICK["steps"] if quick else HALO_STEPS
    hash_steps = HALO_QUICK["hash_steps"] if quick else HALO_HASH_STEPS
    report = {"phase": "halo", "quick": quick, "scene": scene}
    total = collections.Counter()
    all_points = collections.Counter()
    with tempfile.TemporaryDirectory() as root:
        # ---- the main path: the scene generator ------------------------------
        t0 = time.perf_counter()
        ds = make_synthetic_scene(variant="halo", device=dev, **scene)
        torch.cuda.synchronize()
        report["generate_seconds"] = time.perf_counter() - t0
        report["views"] = [len(ds.train_idx), len(ds.val_idx)]
        # the loss of an all-black prediction: the state a dead start sits in
        report["all_black_loss"] = float((ds.images[ds.train_idx] ** 2).mean())
        report["near_far_aabb"] = [ds.near, ds.far, ds.aabb_scale]

        cfg, cuts = halo_config(root, steps, quick)
        report["cuts"] = cuts
        ngp = cfg.ngp
        report["config"] = {
            "encoder": ngp.encoder, "cp": [ngp.cp.n_levels, ngp.cp.n_components,
                                           ngp.cp.table_size, ngp.cp.fold],
            "grid": [ngp.grid.n_levels, ngp.grid.n_features, ngp.grid.log2_table_size,
                     ngp.grid.base_resolution, ngp.grid.max_resolution],
            "mlp": [ngp.density_width, ngp.density_layers, ngp.color_width,
                    ngp.color_layers], "compute_dtype": ngp.compute_dtype,
            "occupancy": [ngp.occ_resolution, ngp.occ_update_every, ngp.occ_full_every],
            "rays": cfg.nerf.num_random_rays, "sampler": cfg.nerf.train.pixel_sampler,
            "seed": cfg.experiment.randomseed}

        # ---- fox's recipe: cp_pallas through the fused module route ----------
        cp_rep, trainer, res, counts, points = halo_fit(cfg, ds, dev)
        total.update(counts)
        all_points.update(points)
        report["cp"] = cp_rep
        # rows 3-6 at the trained weights (timed), then the first steps again
        # from a fresh state through the kernels and through their plain
        # versions, and rows 3-6 at the fresh and at the falling weights
        kernels = {"trained": halo_kernels(trainer, res.state, dev)}
        fresh = trainer.engine.init_state()
        report["cp_lockstep"], falling = halo_lockstep(trainer, fresh, HALO_LOCKSTEP_STEPS)
        kernels["fresh"] = halo_kernels(trainer, fresh, dev, timed=False)
        kernels[f"after {HALO_FALLING_STEP} steps"] = halo_kernels(
            trainer, falling, dev, timed=False)
        report["kernels_at_this_shape"] = kernels
        # ---- f32 mode at fox's encoder (ROADMAP C.1): rows 2, 3, 6, 7 at
        # the trained and the fresh weights, the launchers' shared memory,
        # and the f32 route's first steps against rows 3 and 6's plain
        # versions -------------------------------------------------------------
        report["f32_kernels_at_this_shape"] = {
            "trained": halo_f32_kernels(trainer, res.state, dev),
            "fresh": halo_f32_kernels(trainer, fresh, dev, timed=False)}
        from nerf_kinematics_tpu_torch.train.config import load_config
        from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

        machina = NGPEngine(load_config(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "configs", "machina_ngp.yml")),
                            1.0, device=dev)
        report["f32_smem_bytes"] = f32_smem_bytes({"machina_ngp": machina,
                                                   "fox_ngp": trainer.engine}, dev)
        del machina
        trainer.close()
        del trainer, res, fresh, falling
        f32_cfg = cfg.replace(ngp=dataclasses.replace(
            ngp, compute_dtype="float32", cp=dataclasses.replace(ngp.cp, use_bf16=False)))
        trainer = Trainer(f32_cfg, ds, device=dev)
        report["cp_f32_lockstep"], _ = halo_lockstep(
            trainer, trainer.engine.init_state(), HALO_LOCKSTEP_STEPS)
        trainer.close()
        del trainer
        # ---- the hash encoder on a NaN coordinate (ROADMAP C.4) --------------
        report["hash_nan_point"] = hash_nan_on_card(ngp.grid, dev)

        # ---- the same recipe with ngp.fused: off: rows 4 and 5 every step ----
        cp_rep, trainer, res, counts, points = halo_fit(
            cfg.replace(ngp=dataclasses.replace(ngp, fused="off")), ds, dev)
        total.update(counts)
        all_points.update(points)
        report["cp_unfused"] = cp_rep
        eng, state = trainer.engine, res.state

        # ---- the mesh: the density grid on the card, the native core ---------
        mesh_res = HALO_QUICK["mesh_res"] if quick else HALO_MESH_RES
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        t0 = time.perf_counter()
        verts, tris = extract_mesh_from_engine(eng, eval_params(state), resolution=mesh_res,
                                               iso=HALO_MESH_ISO,
                                               path=os.path.join(root, "halo.ply"))
        mesh_s = time.perf_counter() - t0
        total.update(cuda_lib.LAUNCHES)
        all_points.update(cuda_lib.POINTS)
        with eng.bound(eval_params(state)):
            grid, grid_ms = timed(lambda: eng.density_grid(resolution=mesh_res))
        g = grid.cpu().numpy()
        b = eng.scene_bound
        bounds = (-b, -b, -b, b, b, b)
        report["mesh"] = {
            "resolution": mesh_res, "iso": HALO_MESH_ISO, "vertices": len(verts),
            "triangles": len(tris), "seconds_engine_to_ply": mesh_s,
            "density_grid_ms": grid_ms, "density_max": float(g.max()),
            "density_median": float(np.median(g)),
            "cells_above_iso": float((g > HALO_MESH_ISO).mean())}
        # the native core against its numpy version on the same grid
        t0 = time.perf_counter()
        v_nat, t_nat = extract_mesh(g, iso=HALO_MESH_ISO, bounds=bounds)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        v_ref, t_ref = extract_mesh_ref(g, iso=HALO_MESH_ISO, bounds=bounds)
        ref_s = time.perf_counter() - t0
        same = v_nat.shape == v_ref.shape and t_nat.shape == t_ref.shape
        report["mesh"].update({
            "native_seconds": native_s, "numpy_seconds": ref_s,
            "numpy_vertices": len(v_ref), "numpy_triangles": len(t_ref),
            "max_abs_vertex_err": float(np.abs(v_nat - v_ref).max())
            if same and len(v_nat) else None,
            "triangles_equal": bool(same and np.array_equal(t_nat, t_ref)),
            "engine_mesh_equal": bool(np.array_equal(verts, v_nat)
                                      and np.array_equal(tris, t_nat))})
        trainer.close()
        del trainer, res, eng

        # ---- the contracted two-call step: rows 2 and 7 ----------------------
        # on from the unfused route's trained state (weights, moments, grid):
        # from fresh weights this recipe falls dark as the fused route does
        nerf = cfg.nerf
        two_cfg = cfg.replace(
            ngp=dataclasses.replace(ngp, fused_train="on"),
            experiment=dataclasses.replace(cfg.experiment, train_iters=HALO_TWO_CALL_STEPS),
            nerf=dataclasses.replace(nerf, train=dataclasses.replace(
                nerf.train, num_coarse=48, num_fine=48)))
        two_rep, trainer, res, counts, points = halo_fit(two_cfg, ds, dev, state=state)
        total.update(counts)
        all_points.update(points)
        report["two_call"] = two_rep
        trainer.close()
        del trainer, res, state

        # ---- the hash encoder at the reference-exact grid --------------------
        hash_cfg = cfg.replace(
            ngp=dataclasses.replace(ngp, encoder="hash"),
            experiment=dataclasses.replace(cfg.experiment, train_iters=hash_steps))
        hash_rep, trainer, res, counts, points = halo_fit(hash_cfg, ds, dev)
        total.update(counts)
        all_points.update(points)
        hash_rep["table_shape"] = list(trainer.engine.model.hash_table.shape)
        hash_rep["step_twice_bit_identical"] = step_twice(trainer, res.state)
        report["hash"] = hash_rep
        trainer.close()
        del trainer, res
    for name in ("cp", "cp_unfused", "two_call", "hash"):
        r = report[name]
        # within 5 % of an all-black prediction's loss: the dead start
        r["ends_at_all_black"] = r["loss_last16"] >= 0.95 * report["all_black_loss"]
    report["launches"] = {k: v for k, v in total.items()}
    emit(report)

    # ---- pass criteria -----------------------------------------------------------
    failed = {k: v["failed"] for k, v in report["kernels_at_this_shape"].items() if v["failed"]}
    if failed:
        raise AssertionError(f"halo: kernels against their plain versions at fox's shape: "
                             f"{failed}")
    failed = {k: v["failed"] for k, v in report["f32_kernels_at_this_shape"].items()
              if v["failed"]}
    if failed:
        raise AssertionError(f"halo: f32 kernels against their plain versions at fox's "
                             f"shape: {failed}")
    for key in ("cp_lockstep", "cp_f32_lockstep"):
        lock = report[key]
        if not lock["max_rel_diff"]["kernels"] <= HALO_LOCKSTEP_TOL:
            raise AssertionError(f"halo ({key}): the first {HALO_LOCKSTEP_STEPS} steps "
                                 f"through the kernels leave their plain versions' losses "
                                 f"by {lock['max_rel_diff']['kernels']:.3g} "
                                 f"(> {HALO_LOCKSTEP_TOL}): {lock}")
    if not report["hash_nan_point"]["ok"]:
        raise AssertionError(f"halo: the hash encoder's NaN point on the card differs from "
                             f"the CPU's: {report['hash_nan_point']}")
    for name in ("cp", "cp_unfused", "hash"):
        r = report[name]
        if not (r["contracted"] and r["loss_last"] < HALO_LOSS_RATIO * r["loss_first"]):
            raise AssertionError(f"halo ({name}): loss {r['loss_first']} -> "
                                 f"{r['loss_last']}, not under {HALO_LOSS_RATIO} of it")
    for name, floor in HALO_VAL_FLOOR_DB.items():
        r = report[name]
        if r["ends_at_all_black"]:
            raise AssertionError(f"halo ({name}): ends at the all-black state, loss "
                                 f"{r['loss_last16']}")
        if not quick and not r["val_psnr_db"] >= floor:
            raise AssertionError(f"halo ({name}): val PSNR {r['val_psnr_db']:.2f} dB "
                                 f"under {floor}")
    rows = report["cp"]["launches_by_row"]
    if not (all(rows[f"row {i}"] > 1 for i in (1, 3, 4, 6))
            and rows["row 5 inside rows 6-8, points"] > 0
            and all(rows[f"row {i}"] == 0 for i in (2, 7, 8))):
        raise AssertionError(f"halo (cp): launches by row {rows}")
    rows = report["cp_unfused"]["launches_by_row"]
    if not (rows["row 1"] > 1 and rows["row 4"] > 1 and rows["row 5"] > 1
            and all(rows[f"row {i}"] == 0 for i in (2, 3, 6, 7, 8))):
        raise AssertionError(f"halo (cp_unfused): launches by row {rows}")
    for name in ("cp", "cp_unfused"):
        kinds = [k for _, k, _ in report[name]["occupancy_refreshes_ms"]]
        if not quick and kinds != ["full", "incremental", "incremental"]:
            raise AssertionError(f"halo ({name}): occupancy refreshes {kinds}")
    rows = report["hash"]["launches_by_row"]
    if not (rows["row 1"] > 1 and all(rows[f"row {i}"] == 0 for i in range(2, 11))):
        raise AssertionError(f"halo (hash): launches by row {rows}")
    if not report["hash"]["step_twice_bit_identical"]:
        raise AssertionError("halo (hash): two steps from one state differ or moved nothing")
    two = report["two_call"]
    rows = two["launches_by_row"]
    # 16384 rays x 48 fine points: row 7 in two launches a step (its BWD_CHUNK)
    if not (two["objective"] == "two-call" and rows["row 7"] >= HALO_TWO_CALL_STEPS
            and rows["row 2"] >= HALO_TWO_CALL_STEPS and rows["row 1"] > 1
            and two["loss_last16"] < two["loss_first16"]
            and two["loss_last16"] < HALO_DARK_LOSS * report["all_black_loss"]):
        raise AssertionError(f"halo (two-call): {two}")
    m = report["mesh"]
    if not (m["vertices"] > 0 and m["numpy_vertices"] == m["vertices"]
            and m["numpy_triangles"] == m["triangles"] and m["triangles_equal"]
            and m["max_abs_vertex_err"] is not None
            and m["max_abs_vertex_err"] <= MESH_VERT_TOL and m["engine_mesh_equal"]):
        raise AssertionError(f"halo: mesh {m}")
    return total, all_points


# ---- the robot path: FK captures, the converter, parallax, the wheel configs
# and the full pipeline ---------------------------------------------------------
ROBOT_SIZE = (1280, 720)        # the D405's frames (W, H)
ROBOT_SIZE_CUT = (640, 360)     # when ROBOT_SIZE would take over ROBOT_RENDER_BUDGET_S
ROBOT_SIZE_QUICK = (320, 180)
ROBOT_RENDER_BUDGET_S = 60.0
ROBOT_RENDER_SAMPLES = 256      # samples a ray of the object's field (2..6)
# A table under the object, as a real capture has one: an opaque checkered
# plane just below the wheels (-0.518), within the ring's box (half-width
# 3.49 about the ring's centre). Over a black background the fast engine's
# cp routes fall to the dark state (PERF.md section 6, the halo scene).
ROBOT_FLOOR_Z = -0.52
ROBOT_FLOOR_HALF = 3.3
ROBOT_FLOOR_TILE = 0.25
ROBOT_RING_POSES = 48           # around the object: high parallax
ROBOT_RING_ELEV_DEG = 30.0
ROBOT_SLIDE_POSES = 11          # the wheel capture's geometry: a line, looking down
ROBOT_SLIDE_STEP_MM = 73.0      # its spacing (tests/test_poses.py:23-33)
ROBOT_SLIDE_HEIGHT = 3.0        # camera line above the object, world units
ROBOT_MM_PER_UNIT = 250.0       # robot millimetres a world unit
ROBOT_BASE_MM = (1072.532608, 132.989927, -53.612386)  # the real capture's first pose
ROBOT_NGP_STEPS = 2000
ROBOT_CLASSIC_STEPS = 500
ROBOT_PIPE_SLIDE_STEPS = 300
ROBOT_QUICK_STEPS = 200
ROBOT_PSNR_MARGIN_DB = 5.0      # wheel_ngp on the ring against the constant image
ROBOT_NGP_FLOOR_DB = 32.5       # wheel_ngp on the ring, val mean (33.83 measured); PERF.md section 6
ROBOT_LOW_PARALLAX = 0.3        # directional_std under this: the pipeline's warning
ROBOT_LOADER_TOL = 1e-5         # the loader's poses against the rendered ones
ROBOT_BOX = 1.0                 # the engine's bound for the loader's aabb_scale 2


def robot_world_poses():
    """-> {name: (N, 4, 4) camera-to-world poses (OpenGL, -Z forward) in the
    machina field's world}: the ring, on a circle at 30 degrees of
    elevation at the machina cameras' radius, looking at the object; the
    slide, ROBOT_SLIDE_POSES on a line along +y at ROBOT_SLIDE_HEIGHT,
    ROBOT_SLIDE_STEP_MM apart, looking straight down."""
    from nerf_kinematics_tpu_torch.data.machina import orbit_poses

    ring = orbit_poses(ROBOT_RING_POSES, elev_deg=ROBOT_RING_ELEV_DEG)
    step = ROBOT_SLIDE_STEP_MM / ROBOT_MM_PER_UNIT
    y = (np.arange(ROBOT_SLIDE_POSES) - (ROBOT_SLIDE_POSES - 1) / 2) * step
    slide = np.tile(np.eye(4), (ROBOT_SLIDE_POSES, 1, 1))
    slide[:, 1, 3] = y
    slide[:, 2, 3] = ROBOT_SLIDE_HEIGHT
    return {"ring": np.asarray(ring, np.float64), "slide": slide}


def fk_matrices(world) -> np.ndarray:
    """The raw FK matrices a robot would log for camera poses ``world``:
    millimetres from a base offset, the camera's z axis forward (the third
    column of the OpenGL rotation and the z translation negated, which the
    loader's Z flip undoes). The loader then returns ``world`` up to one
    similarity: x -> k (x - m), m the train poses' centroid and 1 / k
    their largest distance from it (robot_similarity)."""
    raw = np.array(world, np.float64)
    raw[:, :3, 2] *= -1.0
    t = raw[:, :3, 3] * ROBOT_MM_PER_UNIT
    t[:, 2] *= -1.0
    raw[:, :3, 3] = t + np.asarray(ROBOT_BASE_MM)
    return raw


def robot_similarity(world):
    """(m, k) of the map the loader applies to ``world``'s positions."""
    t = np.asarray(world)[:, :3, 3]
    m = t[1:].mean(0)
    return m, 1.0 / float(np.linalg.norm(t[1:] - m, axis=1).max())


def write_poses_txt(path: str, mats) -> None:
    """poses.txt as the robot controller writes it: bracket-and-semicolon
    4x4 matrices, one blank line between them."""
    with open(path, "w") as f:
        for m in mats:
            rows = [", ".join(f"{v:12.6f}" for v in r) for r in m]
            f.write("[" + " ;\n ".join(rows) + " ];\n\n")


def render_capture_rays(o, d):
    """Colours of rays (n, 3) through the machina field on the table: the
    field's ROBOT_RENDER_SAMPLES samples from NEAR to FAR (its z-depth
    parameterisation) cut where the ray meets the table, then the table's
    checker behind what the field leaves; black where a ray misses both."""
    from nerf_kinematics_tpu_torch.data.machina import FAR, NEAR, machina_field
    from nerf_kinematics_tpu_torch.ops.sampling import linspace

    t = linspace(NEAR, FAR, ROBOT_RENDER_SAMPLES, device=o.device)
    tf = (ROBOT_FLOOR_Z - o[:, 2]) / d[:, 2]
    pf = o + d * tf[:, None]
    hit = (d[:, 2] < 0) & (pf[:, 0].abs() < ROBOT_FLOOR_HALF) & (
        pf[:, 1].abs() < ROBOT_FLOOR_HALF)
    rgb, sigma = machina_field(o[:, None, :] + d[:, None, :] * t[:, None])
    sigma = torch.where(t[None, :] < torch.where(hit, tf, math.inf)[:, None], sigma, 0.0)
    dist = (FAR - NEAR) / (ROBOT_RENDER_SAMPLES - 1) * torch.linalg.vector_norm(
        d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-sigma * dist)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    w = alpha * torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    check = torch.remainder(torch.floor(pf[:, 0] / ROBOT_FLOOR_TILE)
                            + torch.floor(pf[:, 1] / ROBOT_FLOOR_TILE), 2.0)[:, None]
    light = torch.tensor([0.62, 0.55, 0.45], device=o.device)
    dark = torch.tensor([0.30, 0.33, 0.38], device=o.device)
    table = torch.where(hit[:, None], dark + check * (light - dark), 0.0)
    return (w[..., None] * rgb).sum(-2) + (1.0 - w.sum(-1, keepdim=True)) * table


def write_fk_capture(root: str, world, size, dev) -> dict:
    """A robot capture in ``root``: poses.txt from fk_matrices(world) and
    images_robot/TestNERF k.png rendered at the poses the loader will
    return (up to its similarity) from the machina field on a table
    (render_capture_rays), with the D405's field of view (87 x 58
    degrees, so fl_x != fl_y off the square), on the card."""
    from nerf_kinematics_tpu_torch.cameras.rays import get_rays
    from nerf_kinematics_tpu_torch.io.image import write_png

    W, H = size
    fl_x = 0.5 * W / math.tan(math.radians(87.0) / 2)
    fl_y = 0.5 * H / math.tan(math.radians(58.0) / 2)
    os.makedirs(os.path.join(root, "images_robot"), exist_ok=True)
    write_poses_txt(os.path.join(root, "poses.txt"), fk_matrices(world))
    t0 = time.perf_counter()
    for k, c2w in enumerate(world):
        o, d = get_rays(H, W, fl_x, torch.as_tensor(c2w, dtype=torch.float32, device=dev),
                        focal_y=fl_y)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        rgb = torch.cat([render_capture_rays(o[s:s + 16384], d[s:s + 16384])
                         for s in range(0, o.shape[0], 16384)])
        img = (rgb.reshape(H, W, 3).clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy()
        write_png(os.path.join(root, "images_robot", f"TestNERF {k}.png"), img)
    return {"frames": len(world), "size": [W, H], "fl_x": fl_x, "fl_y": fl_y,
            "seconds": time.perf_counter() - t0}


def robot_fit(cfg, dev, keep=None):
    """Trainer(cfg) from the capture on disk (the robot loader), fit, then
    validation against a constant image of the train views' mean colour;
    -> (report, counts, points). ``keep`` (a dict) receives the trainer and
    its trained state."""
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev)
    load_s = time.perf_counter() - t0
    ds = trainer.dataset
    state = trainer.engine.init_state()
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    # ---- the main path: training and the held-out renders ------------------
    t0 = time.perf_counter()
    res = trainer.fit(state=state)
    split = trainer.evaluate_split(res.state, "val")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = dict(cuda_lib.LAUNCHES)
    points = collections.Counter(cuda_lib.POINTS)
    # -------------------------------------------------------------------------
    mean_rgb = ds.images[ds.train_idx].reshape(-1, 3).mean(0)
    const = [float(-10.0 * np.log10(np.mean((ds.images[int(i)] - mean_rgb) ** 2)))
             for i in ds.val_idx]
    losses = np.asarray(res.losses)
    ms = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
    n_rays = cfg.nerf.num_random_rays
    t = cfg.nerf.train
    report = {
        "engine": cfg.engine, "views": [len(ds.train_idx), len(ds.val_idx)],
        "image": [ds.W, ds.H], "fl": [ds.intrinsics.fl_x, ds.intrinsics.fl_y],
        "ndc": ds.use_ndc, "steps": len(losses), "rays_per_step": n_rays,
        "samples_per_ray": [t.num_coarse, t.num_fine], "load_seconds": load_s,
        "ms_per_step": ms, "rays_per_s": n_rays / ms * 1e3, "fit_seconds": fit_s,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "loss_first16": float(losses[:16].mean()), "loss_last16": float(losses[-16:].mean()),
        "val_mean_psnr_db": split["mean_psnr"], "val_psnr_by_view_db": split["per_frame"],
        "constant_image_psnr_db": float(np.mean(const)),
        "launches_by_row": by_row(counts, points),
    }
    if cfg.engine == "ngp":
        eng = trainer.engine
        report["encoder"] = eng.ngp_config.resolved_encoder()
        report["objective"] = "two-call" if eng.fused_objective_fn(
            ds.near, ds.far, t) is not None else "autograd"
    else:
        from nerf_kinematics_tpu_torch.ops.classic_fused_cuda import fused_supported

        report["route"] = "fused" if trainer.engine.cf_apply_fns()[0] is not None \
            else "module"
        report["route_why"] = {
            net: f"fused_supported={fused_supported(m.config)} (use_viewdirs "
                 f"{m.config.use_viewdirs}, skip_connect_every "
                 f"{m.config.skip_connect_every}, trunk_depth {m.config.trunk_depth})"
            for net, m in (("coarse", trainer.engine.model_coarse),
                           ("fine", trainer.engine.model_fine)) if m is not None}
    if not (np.isfinite(losses).all() and np.isfinite(split["mean_psnr"])):
        raise AssertionError(f"robot ({cfg.experiment.id}): non-finite loss or PSNR")
    trainer.close()
    if keep is not None:
        keep.update(trainer=trainer, state=res.state)
    return report, counts, points


def robot_lines(root: str, capture: str, steps: int, factor: int) -> dict:
    """The lines a robot config's YAML copy changes: the capture, the steps
    cut, no validation, snapshots or printing."""
    return {"basedir": capture, "logdir": os.path.join(root, "logs"),
            "train_iters": steps, "validate_every": 0, "save_every": 0,
            "print_every": 0, "downsample_factor": factor}


def robot_ngp_config(root: str, capture: str, factor: int, quick: bool):
    """configs/wheel_ngp.yml as shipped on a capture, its steps cut; -> (cfg,
    the cuts)."""
    from nerf_kinematics_tpu_torch.train.config import load_config

    steps = ROBOT_QUICK_STEPS if quick else ROBOT_NGP_STEPS
    cfg = load_config(copy_config("wheel_ngp.yml", root,
                                  **robot_lines(root, capture, steps, factor)))
    cuts = {
        "dataset.basedir": ["the wheel capture", "the ring"],
        "experiment.train_iters": [10000, steps],
        "experiment.validate_every": [1000, 0], "experiment.save_every": [5000, 0],
        "experiment.print_every": [500, 0], **({"dataset.downsample_factor": [8, factor]}
                                                if factor != 8 else {})}
    return cfg, cuts


def phase_robot(dev, quick: bool, root=None, keep=None):
    """The robot path on the card: two FK captures written here (the ring, 48
    poses around the object; the slide, 11 poses on a line looking down, the
    wheel capture's geometry) from the machina field at the D405's size;
    the converter's command line on both; parallax on both; the robot
    loader against the rendered poses; configs/wheel_ngp.yml as shipped on
    the ring (the two-call step: rows 1, 2, 7 with 5 inside, 4 in the
    occupancy sweeps) and configs/wheel_robot.yml (classic, NDC: rows 9,
    10) on the slide, each with its steps cut; cli/full_pipeline.py on the
    ring, then on the slide without the mesh. With ``root`` the captures
    stay there; ``keep`` (a dict) receives the ring's capture and its
    wheel_ngp trainer and state, for the poses phase."""
    import subprocess

    from nerf_kinematics_tpu_torch.cli import full_pipeline
    from nerf_kinematics_tpu_torch.data.robot import load_robot
    from nerf_kinematics_tpu_torch.export.mesh import load_ply
    from nerf_kinematics_tpu_torch.metrics.parallax import (
        analyze_transforms_json, summary_table)
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.config import load_config

    report = {"phase": "robot", "quick": quick}
    total = collections.Counter()
    all_points = collections.Counter()
    world = robot_world_poses()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with contextlib.nullcontext(root) if root else tempfile.TemporaryDirectory() as root:
        # ---- the captures: FK poses.txt and PNG images at the D405's size -----
        size, factor, cuts = (ROBOT_SIZE_QUICK, 2, {"size": [ROBOT_SIZE, ROBOT_SIZE_QUICK]}) \
            if quick else (ROBOT_SIZE, 8, {})
        caps = {}
        for name in ("ring", "slide"):
            caps[name] = os.path.join(root, name)
            if name == "ring" and not quick:
                # one frame first (after one that warms the field's kernels
                # up): at the full size both captures must fit the budget
                for _ in range(2):
                    probe = write_fk_capture(os.path.join(root, "probe"), world[name][:1],
                                             size, dev)
                if probe["seconds"] * (ROBOT_RING_POSES + ROBOT_SLIDE_POSES) > ROBOT_RENDER_BUDGET_S:
                    size, factor = ROBOT_SIZE_CUT, 4
                    cuts["size"] = [ROBOT_SIZE, ROBOT_SIZE_CUT]
                    cuts["downsample_factor"] = [8, 4]
                report["render_probe_seconds"] = probe["seconds"]
            report[f"capture_{name}"] = write_fk_capture(caps[name], world[name], size, dev)
        report["cuts"] = cuts

        # ---- the converter's command line on both ------------------------------
        for name, d in caps.items():
            t0 = time.perf_counter()
            cmd = [sys.executable, "-m", "nerf_kinematics_tpu_torch.cli.parse_poses",
                   "--poses", os.path.join(d, "poses.txt"),
                   "--image_folder", os.path.join(d, "images_robot"),
                   "--image_ext", "png", "--recenter",
                   "--output", os.path.join(d, "transforms.json")]
            out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
            if out.returncode != 0:
                raise AssertionError(f"robot: parse_poses on the {name}: {out.stderr[-2000:]}")
            files = {k: os.path.join(d, f"transforms{k}.json")
                     for k in ("", "_val", "_test", "_test_video")}
            js = {k: json.load(open(p)) for k, p in files.items()}
            sharp = [f["sharpness"] for f in js[""]["frames"]]
            report[f"convert_{name}"] = {
                "seconds": time.perf_counter() - t0, "stdout": out.stdout.splitlines(),
                "frames": {k or "train": len(v["frames"]) for k, v in js.items()},
                "aabb_scale": js[""]["aabb_scale"], "w_h": [js[""]["w"], js[""]["h"]],
                "sharpness_range": [min(sharp), max(sharp)]}

        # ---- parallax on both ----------------------------------------------------
        metrics = {n: analyze_transforms_json(os.path.join(d, "transforms.json"), n)
                   for n, d in caps.items()}
        report["parallax"] = {n: m.as_dict() for n, m in metrics.items()}
        report["parallax_table"] = summary_table(list(metrics.values())).splitlines()

        # ---- the loader returns the rendered poses up to its similarity ---------
        loaded = {}
        for name, d in caps.items():
            cfg = load_config(copy_config("wheel_ngp.yml", root, basedir=d))
            ds = load_robot(cfg.dataset)
            m, k = robot_similarity(world[name])
            want = np.array(world[name])
            want[:, :3, 3] = (want[:, :3, 3] - m) * k
            # the scene's extent (the machina field on the table), in the
            # loader's coordinates
            lo = (np.array([-ROBOT_FLOOR_HALF, -ROBOT_FLOOR_HALF, ROBOT_FLOOR_Z]) - m) * k
            hi = (np.array([ROBOT_FLOOR_HALF, ROBOT_FLOOR_HALF, 0.45]) - m) * k
            loaded[name] = {
                "max_abs_pose_err": float(np.abs(ds.poses - want).max()),
                "object_centre": (-m * k).tolist(),
                "scene_lo_hi": [lo.tolist(), hi.tolist()],
                "inside_box": bool(np.abs(np.stack([lo, hi])).max() <= ROBOT_BOX),
                "fl_x_fl_y": [ds.intrinsics.fl_x, ds.intrinsics.fl_y],
                "image": [ds.W, ds.H], "split": [len(ds.train_idx), len(ds.val_idx)]}
        report["loader"] = loaded

        # ---- configs/wheel_ngp.yml as shipped on the ring -------------------------
        cfg, report["wheel_ngp_cuts"] = robot_ngp_config(root, caps["ring"], factor, quick)
        ring_fit = {}
        r, counts, points = robot_fit(cfg, dev, keep=ring_fit)
        total.update(counts)
        all_points.update(points)
        report["wheel_ngp_ring"] = r
        if keep is not None:
            keep.update(ring=caps["ring"], size=size, factor=factor, **ring_fit)

        # ---- configs/wheel_robot.yml as shipped on the slide (classic, NDC) ------
        steps = ROBOT_QUICK_STEPS if quick else ROBOT_CLASSIC_STEPS
        cfg = load_config(copy_config("wheel_robot.yml", root,
                                      **robot_lines(root, caps["slide"], steps, factor)))
        report["wheel_robot_cuts"] = {
            "dataset.basedir": ["the wheel capture", "the slide"],
            "experiment.train_iters": [250000, steps],
            "experiment.validate_every": [100, 0], "experiment.save_every": [5000, 0],
            "experiment.print_every": [100, 0], **({"dataset.downsample_factor": [8, factor]}
                                                   if factor != 8 else {})}
        r, counts, points = robot_fit(cfg, dev)
        total.update(counts)
        all_points.update(points)
        report["wheel_robot_slide"] = r

        # ---- cli/full_pipeline.py on the ring, then on the slide ----------------
        pipes = {}
        for name, extra in (("ring", ["--mesh-res", "32" if quick else "256"]
                             + (["--steps", str(ROBOT_QUICK_STEPS)] if quick else [])),
                            ("slide", ["--steps", str(ROBOT_QUICK_STEPS if quick
                                                      else ROBOT_PIPE_SLIDE_STEPS),
                                       "--skip-mesh"])):
            out = os.path.join(root, f"pipeline_{name}")
            argv = ["--capture", caps[name], "--out", out, "--encoder", "cp_pallas",
                    "--downsample", str(factor), "--device", str(dev), *extra]
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            rep = full_pipeline.main(argv)
            torch.cuda.synchronize()
            total.update(cuda_lib.LAUNCHES)
            all_points.update(cuda_lib.POINTS)
            written = sorted(os.listdir(out))
            ply = os.path.join(out, "scene.ply")
            pipes[name] = {
                "argv": argv, "seconds": time.perf_counter() - t0,
                "stage_seconds": rep["stage_seconds"], "val_psnr_db": rep["val_psnr"],
                "rays_per_s": rep["rays_per_sec"],
                "low_parallax_warning": rep["low_parallax_warning"],
                "directional_std": rep["parallax"]["directional_std"],
                "video": os.path.basename(rep["video"]) if rep["video"] else None,
                "files": written,
                "report_matches_disk": json.load(open(os.path.join(out, "report.json")))
                == json.loads(json.dumps(rep)),
                "launches_by_row": by_row(dict(cuda_lib.LAUNCHES), cuda_lib.POINTS)}
            if os.path.exists(ply):
                v, f = load_ply(ply)
                pipes[name]["ply_vertices_triangles"] = [len(v), len(f)]
        report["full_pipeline"] = pipes
    report["launches"] = dict(total)
    emit(report)

    # ---- pass criteria -----------------------------------------------------------
    fail = []
    for name in ("ring", "slide"):
        c = report[f"convert_{name}"]
        n = len(world[name])
        if c["frames"] != {"train": n - 1, "_val": 1, "_test": 8, "_test_video": 60}:
            fail.append(f"converter on the {name}: frames {c['frames']}")
        if not loaded[name]["max_abs_pose_err"] <= ROBOT_LOADER_TOL:
            fail.append(f"loader on the {name}: poses {loaded[name]['max_abs_pose_err']}")
    if not report["parallax"]["slide"]["directional_std"] < ROBOT_LOW_PARALLAX:
        fail.append("parallax: the slide reads high")
    if not report["parallax"]["ring"]["directional_std"] > ROBOT_LOW_PARALLAX:
        fail.append("parallax: the ring reads low")
    # the ring trains the fast engine, whose box the scene must lie in; the
    # slide is forward-facing and trains in NDC, which wants it beyond depth 1
    if not loaded["ring"]["inside_box"]:
        fail.append(f"the scene leaves the engine's box on the ring: {loaded['ring']}")
    r = report["wheel_ngp_ring"]
    rows = r["launches_by_row"]
    if not r["loss_last16"] < r["loss_first16"]:
        fail.append(f"wheel_ngp: loss {r['loss_first16']} -> {r['loss_last16']}")
    if not quick:
        if not r["val_mean_psnr_db"] >= r["constant_image_psnr_db"] + ROBOT_PSNR_MARGIN_DB:
            fail.append(f"wheel_ngp: val {r['val_mean_psnr_db']:.2f} dB, constant image "
                        f"{r['constant_image_psnr_db']:.2f} dB")
        if not r["val_mean_psnr_db"] >= ROBOT_NGP_FLOOR_DB:
            fail.append(f"wheel_ngp: val {r['val_mean_psnr_db']:.2f} dB under "
                        f"{ROBOT_NGP_FLOOR_DB}")
    if not (r["objective"] == "two-call" and all(rows[f"row {i}"] > 0 for i in (1, 2, 4, 7))
            and rows["row 5 inside rows 6-8, points"] > 0):
        fail.append(f"wheel_ngp: {r['objective']}, launches by row {rows}")
    r = report["wheel_robot_slide"]
    rows = r["launches_by_row"]
    if not (r["loss_last16"] < r["loss_first16"]
            and r["val_mean_psnr_db"] > r["constant_image_psnr_db"]):
        fail.append(f"wheel_robot: loss {r['loss_first16']} -> {r['loss_last16']}, val "
                    f"{r['val_mean_psnr_db']} dB, constant {r['constant_image_psnr_db']} dB")
    if not (r["route"] == "fused" and rows["row 9"] > 0 and rows["row 10"] > 0):
        fail.append(f"wheel_robot: route {r['route']}, launches by row {rows}")
    p = report["full_pipeline"]
    want = {"transforms.json", "transforms_val.json", "transforms_test.json",
            "transforms_test_video.json", "parallax.json", "report.json", "scene.ply",
            p["ring"]["video"]}
    if not (want <= set(p["ring"]["files"])
            and p["ring"]["ply_vertices_triangles"][0] > 0
            and not p["ring"]["low_parallax_warning"] and p["ring"]["report_matches_disk"]):
        fail.append(f"full_pipeline on the ring: {p['ring']}")
    if not (p["slide"]["low_parallax_warning"] and "scene.ply" not in p["slide"]["files"]):
        fail.append(f"full_pipeline on the slide: {p['slide']}")
    if fail:
        raise AssertionError(f"robot: {fail}")
    return total, all_points


# ---- the other pose sources: COLMAP import, SfM, photometric refinement ------

POSES_BA_CAMERAS = 49          # fox49's frames
POSES_BA_POINTS = 5000
POSES_BA_SEEN = (6, 10)        # cameras that see a point (consecutive on the orbit)
POSES_BA_SIZE = (1920, 1080)   # fox49's frames (W, H)
POSES_BA_FOCAL = 1400.0
POSES_BA_FOCAL_START = 1.03    # the focal-optimising run starts this far off
POSES_BA_ITERS = 3000          # cli/sfm2nerf.py's default --ba_iters
POSES_BA_CPU_ITERS = 600       # the focal call on the card against the CPU
POSES_BA_PX = 0.5              # mean reprojection error after BA, px
# the card's result against the same call on the CPU (the focal-optimising
# call, whose path holds the other's, at POSES_BA_CPU_ITERS on both sides: at
# 3000 the CPU took 56 s of the phase): f32 sums in another order (the
# gradient's index_add, whose order varies from run to run on the card)
# through the Adam steps. At 3000 steps three runs on an H100 read cameras 2.4e-6,
# 1.4e-6, 9.5e-7; points 2.3e-6, 1.5e-6, 1.7e-6; focal_rel 1.5e-6, 5.2e-7,
# 5.2e-7; px 1.1e-5, 2.6e-6, 2.2e-6 (PERF.md section 5): each limit is 3-5x
# the largest reading.
POSES_BA_CPU_TOL = {"cameras": 1e-5, "points": 1e-5, "focal_rel": 1e-5, "px": 3e-5}
POSES_COLMAP_TOL = 1e-5        # of the ring's radius, after one similarity
POSES_SFM_PX = 2.5             # tests/test_sfm.py's bounds
POSES_SFM_RMS = 0.05           # of the ring's radius
POSES_SPRITES = 300            # tests/test_sfm.py's textured point sprites
POSES_SPRITE_FOV = 60.0        # and its camera's field of view, degrees
# scripts/fox_pose_refine.py's settings; refine_poses as its stage 2 takes them
POSES_REFINE = {"n_rays": 8192, "n_samples": 64, "n_iters": 120, "lr": 1e-3}
POSES_MULTI = {"n_rays": 4096, "n_samples": 64, "n_iters": 200, "lr": 1e-3}
POSES_MULTI_PERTURBED = 5
POSES_QUICK_ITERS = {"ba": 600, "refine": 30, "multi": 40}
# tests/test_pose_refine.py:99, its translation scaled from that test's box
# (POSES_TEST_BOX) to the ring's (ROBOT_BOX)
POSES_D_TRUE = (0.03, -0.02, 0.025, 0.03, -0.02, 0.02)
POSES_TEST_BOX = 1.0


def rotmat_to_qvec(R) -> np.ndarray:
    """Rotation matrix -> COLMAP's (w, x, y, z) quaternion (Shepperd)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def world_to_colmap(c2w):
    """NeRF camera-to-world (OpenGL axes) -> COLMAP world-to-camera (qvec,
    tvec): the inverse of poses/colmap.py::colmap_pose_to_c2w."""
    m = np.array(c2w, np.float64)
    m[:3, 1:3] *= -1.0
    R = m[:3, :3].T
    return rotmat_to_qvec(R), -R @ m[:3, 3]


def write_colmap_text(model_dir: str, world, names, size, fl) -> None:
    """cameras.txt (one PINHOLE camera) and images.txt for known poses."""
    os.makedirs(model_dir, exist_ok=True)
    W, H = size
    with open(os.path.join(model_dir, "cameras.txt"), "w") as f:
        f.write("# Camera list\n")
        f.write(f"1 PINHOLE {W} {H} {fl[0]!r} {fl[1]!r} {W / 2!r} {H / 2!r}\n")
    with open(os.path.join(model_dir, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for k, (c2w, name) in enumerate(zip(world, names)):
            q, t = world_to_colmap(c2w)
            f.write(f"{k + 1} {' '.join(repr(float(v)) for v in (*q, *t))} 1 {name}\n\n")


def similarity(A, B):
    """Umeyama: (s, R, t) with s R A + t the least-squares fit of B."""
    muA, muB = A.mean(0), B.mean(0)
    A0, B0 = A - muA, B - muB
    U, S, Vt = np.linalg.svd(B0.T @ A0 / len(A))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / ((A0**2).sum() / len(A)))
    return s, R, muB - s * R @ muA


def ba_problem(seed: int = 0):
    """A fox49-sized bundle adjustment: POSES_BA_CAMERAS cameras on an orbit
    of radius 4 looking at the origin, POSES_BA_POINTS points in the unit
    cube, each seen by 6-10 consecutive cameras, their exact projections;
    the start perturbed as tests/test_sfm.py's (rotations 0.01, translations
    0.02, points 0.05; camera 0 exact, the gauge). -> (args, exact)."""
    from nerf_kinematics_tpu_torch.poses.colmap import qvec_to_rotmat
    from nerf_kinematics_tpu_torch.poses.orbit import generate_orbit_poses

    rng = np.random.default_rng(seed)
    W, H = POSES_BA_SIZE
    f, cx, cy = POSES_BA_FOCAL, W / 2.0, H / 2.0
    c2w = generate_orbit_poses(np.zeros(3), radius=4.0, n_poses=POSES_BA_CAMERAS,
                               height_wobble=1.0).numpy()
    qt = [world_to_colmap(m) for m in c2w]
    # axis-angle from the quaternion (w >= 0): 2 atan2(|v|, w) about v / |v|
    rv = []
    for q, _ in qt:
        q = q if q[0] >= 0 else -q
        n = float(np.linalg.norm(q[1:]))
        rv.append(q[1:] / n * 2.0 * math.atan2(n, q[0]) if n > 0 else np.zeros(3))
    rv, tv = np.array(rv), np.array([t for _, t in qt])
    Rs = np.stack([qvec_to_rotmat(q) for q, _ in qt])
    X = rng.uniform(-1.0, 1.0, (POSES_BA_POINTS, 3))
    lo, hi = POSES_BA_SEEN
    seen = [(rng.integers(0, POSES_BA_CAMERAS) + np.arange(rng.integers(lo, hi + 1)))
            % POSES_BA_CAMERAS for _ in range(POSES_BA_POINTS)]
    cam_idx = np.concatenate(seen)
    pt_idx = np.repeat(np.arange(POSES_BA_POINTS), [len(s) for s in seen])
    xc = np.einsum("kij,kj->ki", Rs[cam_idx], X[pt_idx]) + tv[cam_idx]
    uv = np.stack([f * xc[:, 0] / xc[:, 2] + cx, f * xc[:, 1] / xc[:, 2] + cy], -1)
    rv_n = rv + rng.normal(0, 0.01, rv.shape)
    rv_n[0] = rv[0]
    tv_n = tv + rng.normal(0, 0.02, tv.shape)
    tv_n[0] = tv[0]
    X_n = X + rng.normal(0, 0.05, X.shape)
    return (rv_n, tv_n, X_n, cam_idx, pt_idx, uv), {"rv": rv, "tv": tv, "X": X, "f": f}


def render_sprites(pts, patterns, c2w, H: int, W: int, focal: float) -> np.ndarray:
    """tests/test_sfm.py's point-sprite render through an exact pinhole:
    each point a unique random texture patch (distinct SIFT descriptors),
    painted far to near on white."""
    import cv2

    w2c = np.linalg.inv(c2w)
    xc = (w2c[:3, :3] @ pts.T).T + w2c[:3, 3]
    z = -xc[:, 2]
    u = focal * xc[:, 0] / z + W / 2.0
    v = focal * (-xc[:, 1]) / z + H / 2.0
    img = np.full((H, W, 3), 255, np.uint8)
    for i in np.argsort(-z):
        if not z[i] > 0.5:
            continue
        s = int(np.clip(focal * 0.22 / z[i], 8, 60))
        x0, y0 = int(round(u[i])) - s // 2, int(round(v[i])) - s // 2
        x1, y1 = x0 + s, y0 + s
        if x1 <= 0 or y1 <= 0 or x0 >= W or y0 >= H:
            continue
        patch = cv2.resize(patterns[i], (s, s), interpolation=cv2.INTER_LINEAR)
        cx0, cy0 = max(0, -x0), max(0, -y0)
        cx1, cy1 = s - max(0, x1 - W), s - max(0, y1 - H)
        img[max(0, y0):min(H, y1), max(0, x0):min(W, x1)] = patch[cy0:cy1, cx0:cx1]
    return img


def write_sprite_ring(root: str, world, size, focal: float) -> float:
    """The ring's poses and frame size over tests/test_sfm.py's scene (its
    300 sprites in the unit cube, its seed) through a pinhole of ``focal``
    with square pixels: frames ``000.png`` ... in capture order;
    -> seconds."""
    import cv2

    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, (POSES_SPRITES, 3))
    patterns = rng.integers(0, 255, (POSES_SPRITES, 8, 8, 3)).astype(np.uint8)
    os.makedirs(root)
    W, H = size
    for k, c2w in enumerate(world):
        cv2.imwrite(os.path.join(root, f"{k:03d}.png"),
                    render_sprites(pts, patterns, c2w, H, W, focal))
    return time.perf_counter() - t0


def pose_error(a, b) -> float:
    """The largest entry of |a - b| over two camera-to-world matrices."""
    return float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max())


def sfm_front_end(root: str, world, size, focal: float, dev) -> dict:
    """``cli/sfm2nerf.py`` (``--device``) on the sprite scene seen from the
    ring: registrations, its mean reprojection error, and the camera centres
    against the ring's after one similarity, as a share of its radius."""
    import contextlib as _ctx
    import io

    from nerf_kinematics_tpu_torch.cli import sfm2nerf

    render_s = write_sprite_ring(root, world, size, focal)
    out = root + ".json"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with _ctx.redirect_stdout(buf):
        sfm2nerf.main(["--images", root, "--out", out, "--device", str(dev)])
    seconds = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    summary = next(l for l in lines if l.startswith("registered "))
    meta = json.load(open(out))
    idx = [int(os.path.basename(fr["file_path"])[:3]) for fr in meta["frames"]]
    got = np.array([fr["transform_matrix"] for fr in meta["frames"]])[:, :3, 3]
    want = np.asarray(world)[idx, :3, 3]
    s, R, t = similarity(got, want)
    rms = float(np.sqrt(((s * got @ R.T + t - want) ** 2).sum(1).mean()))
    radius = float(np.linalg.norm(want - want.mean(0), axis=1).mean())
    return {"frames": len(world), "registered": int(summary.split()[1].split("/")[0]),
            "mean_reproj_px": float(summary.split("mean reprojection ")[1].rstrip("px")),
            "focal": meta["fl_x"], "focal_true": focal, "centre_rms_over_radius": rms / radius,
            "render_seconds": render_s, "seconds": seconds, "stdout": lines}


def phase_poses(dev, quick: bool, shared: dict):
    """The pose sources besides the robot on the card: a COLMAP text model of
    the ring's known poses through ``cli/colmap2nerf.py``; the bundle
    adjustment at a fox49-sized problem (3000 iterations, with and without
    the focal; the focal-optimising call also on the CPU, against which the
    card's result is held); the SfM front-end through ``cli/sfm2nerf.py``
    where cv2 imports, on the ring's poses and frame size over
    tests/test_sfm.py's sprite scene and camera (the reference's front-end
    reconstructs too few points on the ring's own frames to register them:
    their checkered table repeats, the field's object has little texture,
    and the D405's 87 degrees lie outside its focal candidates); photometric
    refinement (``poses/refine.py``) of a perturbed held-out pose and of
    five perturbed training poses against the ring's wheel_ngp field, its
    samples placed by the hull proposal (row 1). The ring's capture and
    field are the robot phase's (``shared``) where it ran, else made here as
    it makes them."""
    import subprocess

    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.poses.pipeline import convert_poses
    from nerf_kinematics_tpu_torch.poses.refine import apply_delta, refine_pose, refine_poses
    from nerf_kinematics_tpu_torch.poses.sfm import bundle_adjust
    from nerf_kinematics_tpu_torch.train.loop import eval_params

    report = {"phase": "poses", "quick": quick}
    seconds = {}
    total = collections.Counter()
    all_points = collections.Counter()
    world = robot_world_poses()["ring"]
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as root:
        # ---- the ring: the robot phase's, or written here as it writes it -----
        t0 = time.perf_counter()
        if "ring" in shared:
            ring, size, factor = shared["ring"], shared["size"], shared["factor"]
            report["ring_from"] = "robot phase"
        else:
            size, factor = (ROBOT_SIZE_QUICK, 2) if quick else (ROBOT_SIZE, 8)
            ring = os.path.join(root, "ring")
            write_fk_capture(ring, world, size, dev)
            report["ring_from"] = "written here"
        seconds["ring"] = time.perf_counter() - t0
        W, H = size
        fl = (0.5 * W / math.tan(math.radians(87.0) / 2),
              0.5 * H / math.tan(math.radians(58.0) / 2))
        # the frames under names a COLMAP text model can hold (no spaces)
        images = os.path.join(root, "frames")
        os.makedirs(images)
        names = [f"{k:03d}.png" for k in range(len(world))]
        for k, name in enumerate(names):
            os.symlink(os.path.join(ring, "images_robot", f"TestNERF {k}.png"),
                       os.path.join(images, name))

        # ---- COLMAP import: a text model of the known poses -------------------
        t0 = time.perf_counter()
        model = os.path.join(root, "colmap_text")
        write_colmap_text(model, world, names, size, fl)
        out_json = os.path.join(root, "colmap_transforms.json")
        cmd = [sys.executable, "-m", "nerf_kinematics_tpu_torch.cli.colmap2nerf",
               "--images", images, "--text", model, "--out", out_json]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"poses: colmap2nerf: {proc.stderr[-2000:]}")
        seconds["colmap2nerf"] = time.perf_counter() - t0
        meta = json.load(open(out_json))
        got = np.array([fr["transform_matrix"] for fr in meta["frames"]])
        s, R, t = similarity(world[:, :3, 3], got[:, :3, 3])
        radius = float(np.linalg.norm(got[:, :3, 3], axis=1).mean())
        pos_err = float(np.abs(s * world[:, :3, 3] @ R.T + t - got[:, :3, 3]).max())
        rot_err = float(np.abs(R @ world[:, :3, :3] - got[:, :3, :3]).max())
        conv = convert_poses(os.path.join(ring, "poses.txt"),
                             os.path.join(ring, "images_robot"), image_ext="png",
                             recenter=True, output=None)
        want_sharp = {int(fr["file_path"].rsplit(" ", 1)[1].split(".")[0]): fr["sharpness"]
                      for d in (conv.train, conv.val) for fr in d["frames"]}
        got_sharp = {int(os.path.basename(fr["file_path"])[:3]): fr.get("sharpness")
                     for fr in meta["frames"]}
        report["colmap"] = {
            "frames": len(meta["frames"]), "w_h": [meta["w"], meta["h"]],
            "fl": [meta["fl_x"], meta["fl_y"]], "similarity_scale": s,
            "radius": radius, "max_position_err": pos_err, "max_rotation_err": rot_err,
            "sharpness_equal": got_sharp == want_sharp,
            "stdout": proc.stdout.splitlines(), "seconds": seconds["colmap2nerf"]}

        # ---- bundle adjustment at a fox49-sized problem ------------------------
        args, exact = ba_problem()
        iters = POSES_QUICK_ITERS["ba"] if quick else POSES_BA_ITERS
        W_ba, H_ba = POSES_BA_SIZE
        ba = {"cameras": POSES_BA_CAMERAS, "points": POSES_BA_POINTS,
              "observations": len(args[3]), "iters": iters}
        for optimize_focal in (False, True):
            f0 = POSES_BA_FOCAL * (POSES_BA_FOCAL_START if optimize_focal else 1.0)
            kw = dict(iters=iters, optimize_focal=optimize_focal)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = bundle_adjust(*args, f0, W_ba / 2.0, H_ba / 2.0, device=dev, **kw)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            # the start's reprojection error: zero iterations
            start_px = bundle_adjust(*args, f0, W_ba / 2.0, H_ba / 2.0, iters=0,
                                     device=dev)[4]
            b = ba["focal" if optimize_focal else "fixed"] = {
                "focal_start": f0, "focal_end": g[3],
                "focal_err_start": abs(f0 - exact["f"]), "focal_err_end": abs(g[3] - exact["f"]),
                "mean_px_start": start_px, "mean_px": g[4], "seconds": card_s,
                "ms_per_iter": card_s / iters * 1e3}
            if optimize_focal:
                # the same call on the card and on the CPU, at fewer iterations
                kw["iters"] = min(iters, POSES_BA_CPU_ITERS)
                g = bundle_adjust(*args, f0, W_ba / 2.0, H_ba / 2.0, device=dev, **kw)
                t0 = time.perf_counter()
                c = bundle_adjust(*args, f0, W_ba / 2.0, H_ba / 2.0, device="cpu", **kw)
                b["cpu_seconds"] = time.perf_counter() - t0
                b["cpu_iters"] = kw["iters"]
                b["cpu_mean_px"] = c[4]
                b["vs_cpu"] = {"cameras": float(max(np.abs(g[0] - c[0]).max(),
                                                    np.abs(g[1] - c[1]).max())),
                               "points": float(np.abs(g[2] - c[2]).max()),
                               "focal_rel": abs(g[3] - c[3]) / c[3], "px": abs(g[4] - c[4])}
        report["bundle_adjust"] = ba
        seconds["bundle_adjust"] = sum(v["seconds"] + v.get("cpu_seconds", 0.0)
                                       for v in ba.values() if isinstance(v, dict))

        # ---- the SfM front-end, where cv2 imports -------------------------------
        try:
            import cv2  # noqa: F401
        except Exception as e:  # cv2 is an optional dependency of the front-end
            report["sfm_front_end"] = f"cv2 absent ({type(e).__name__})"
        else:
            if quick:
                report["sfm_front_end"] = "not run (--quick)"
            else:
                focal = 0.5 * W / math.tan(math.radians(POSES_SPRITE_FOV) / 2)
                report["sfm_front_end"] = sfm_front_end(
                    os.path.join(root, "sprite_ring"), world, size, focal, dev)
                seconds["sfm2nerf"] = report["sfm_front_end"]["seconds"]

        # ---- photometric refinement against the ring's wheel_ngp field --------
        t0 = time.perf_counter()
        if "trainer" in shared:
            trainer, state = shared["trainer"], shared["state"]
        else:
            cfg, _ = robot_ngp_config(root, ring, factor, quick)
            fit = {}
            _, counts, points = robot_fit(cfg, dev, keep=fit)
            total.update(counts)
            all_points.update(points)
            trainer, state = fit["trainer"], fit["state"]
        seconds["field"] = time.perf_counter() - t0
        engine, ds = trainer.engine, trainer.dataset
        wb = bool(trainer.cfg.nerf.validation.white_background)
        params = eval_params(state)
        d_true = torch.tensor(POSES_D_TRUE, device=dev)
        d_true[3:] *= ROBOT_BOX / POSES_TEST_BOX

        def image_mse(c2w):
            with torch.no_grad(), engine.bound(params):
                rgb = trainer._render(c2w, state.aux)["rgb"]
            return float(((rgb - torch.as_tensor(gt, device=dev)) ** 2).mean())

        vi = int(ds.val_idx[0])
        gt = ds.images[vi]
        pose0 = torch.as_tensor(ds.poses[vi], dtype=torch.float32, device=dev)
        pose_bad = apply_delta(pose0, d_true)
        one = dict(POSES_REFINE, n_iters=POSES_QUICK_ITERS["refine"]) if quick else POSES_REFINE
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        # ---- the main path: refine_pose, then refine_poses ---------------------
        t0 = time.perf_counter()
        refined, delta, losses = refine_pose(engine, params, state.aux, gt, pose_bad,
                                             ds.intrinsics, ds.near, ds.far,
                                             white_background=wb, **one)
        torch.cuda.synchronize()
        t_one = time.perf_counter() - t0
        launches_one = cuda_lib.LAUNCHES["occupancy_at_hull"]
        train_imgs, train_poses = ds.split("train")
        train_poses = torch.as_tensor(train_poses, dtype=torch.float32, device=dev)
        picked = np.linspace(0, len(train_poses) - 1, POSES_MULTI_PERTURBED).round().astype(int)
        bad = train_poses.clone()
        for i in picked:
            bad[i] = apply_delta(train_poses[i], d_true)
        many = dict(POSES_MULTI, n_iters=POSES_QUICK_ITERS["multi"]) if quick else POSES_MULTI
        t0 = time.perf_counter()
        refined_tr, deltas = refine_poses(engine, params, state.aux, train_imgs, bad,
                                          ds.intrinsics, ds.near, ds.far,
                                          white_background=wb, **many)
        torch.cuda.synchronize()
        t_many = time.perf_counter() - t0
        counts = dict(cuda_lib.LAUNCHES)
        points = collections.Counter(cuda_lib.POINTS)
        # -------------------------------------------------------------------------
        total.update(counts)
        all_points.update(points)
        err_before = [pose_error(bad[i], train_poses[i]) for i in picked]
        err_after = [pose_error(refined_tr[i], train_poses[i]) for i in picked]
        report["refine_pose"] = {
            "view": vi, "image": [ds.W, ds.H], "d_true": d_true.tolist(), **one,
            "image_mse_perturbed": image_mse(pose_bad), "image_mse_refined": image_mse(refined),
            "image_mse_true_pose": image_mse(pose0),
            "pose_err_perturbed": pose_error(pose_bad, pose0),
            "pose_err_refined": pose_error(refined, pose0),
            "loss_first_last": [losses[0], losses[-1]], "delta": delta.tolist(),
            "seconds": t_one, "ms_per_iter": t_one / one["n_iters"] * 1e3,
            "row1_launches": launches_one}
        report["refine_poses"] = {
            "poses": len(train_poses), "perturbed": picked.tolist(), **many,
            "mean_pose_err_before": float(np.mean(err_before)),
            "mean_pose_err_after": float(np.mean(err_after)),
            "unperturbed_mean_drift": float(np.mean([
                pose_error(refined_tr[i], train_poses[i])
                for i in range(len(train_poses)) if i not in set(picked.tolist())])),
            "seconds": t_many, "ms_per_iter": t_many / many["n_iters"] * 1e3,
            "row1_launches": counts["occupancy_at_hull"] - launches_one}
        report["launches_by_row"] = by_row(counts, points)
        seconds["refine"] = t_one + t_many
    report["seconds"] = seconds
    report["launches"] = dict(total)
    emit(report)

    # ---- pass criteria -----------------------------------------------------------
    fail = []
    c = report["colmap"]
    if not (c["frames"] == len(world) and c["max_position_err"] <= POSES_COLMAP_TOL * c["radius"]
            and c["max_rotation_err"] <= POSES_COLMAP_TOL and c["sharpness_equal"]):
        fail.append(f"colmap2nerf: {c}")
    for key in ("fixed", "focal"):
        b = ba[key]
        if not quick and not b["mean_px"] < POSES_BA_PX:
            fail.append(f"bundle_adjust ({key}): {b['mean_px']} px")
        if key == "focal" and not b["focal_err_end"] < b["focal_err_start"]:
            fail.append(f"bundle_adjust: focal error {b['focal_err_start']} -> "
                        f"{b['focal_err_end']}")
    bad_tol = {k: v for k, v in ba["focal"]["vs_cpu"].items() if not v <= POSES_BA_CPU_TOL[k]}
    if bad_tol:
        fail.append(f"bundle_adjust against the CPU: {bad_tol}")
    sf = report["sfm_front_end"]
    if isinstance(sf, dict) and not (
            sf["registered"] == sf["frames"] and sf["mean_reproj_px"] < POSES_SFM_PX
            and sf["centre_rms_over_radius"] < POSES_SFM_RMS):
        fail.append(f"sfm2nerf on the ring: {sf}")
    r = report["refine_pose"]
    if not (r["image_mse_refined"] < 0.5 * r["image_mse_perturbed"]
            and r["pose_err_refined"] < r["pose_err_perturbed"]):
        fail.append(f"refine_pose: {r}")
    m = report["refine_poses"]
    if not m["mean_pose_err_after"] < m["mean_pose_err_before"]:
        fail.append(f"refine_poses: {m}")
    if not (r["row1_launches"] >= r["n_iters"] and m["row1_launches"] >= m["n_iters"]):
        fail.append(f"row 1 not launched every refinement step: {r['row1_launches']}, "
                    f"{m['row1_launches']}")
    if fail:
        raise AssertionError(f"poses: {fail}")
    return total, all_points


# ---- the command lines and the bench ---------------------------------------
CLI_NGP_STEPS = 512
CLI_CLASSIC_STEPS = 200
# The YAML's seed 42 falls at once into the all-white state on machina400
# at half resolution and stays there to 2000 steps; seed 7 reads 19.82 dB at
# 200 steps (scripts/torch_classic_cli_curve.py, PERF.md section 6). The
# copy takes seed 7 so that the floor holds the route.
CLI_CLASSIC_SEED = 7
CLI_CLASSIC_FLOOR_DB = 17.0  # val view 0 after CLI_CLASSIC_STEPS (full size)
CLI_SHOTS = 4              # test frames the screenshot JSON holds
CLI_HASH_STEPS = 512       # ngp_run --encoder hash, the CLI's demo recipe
CLI_HASH_FLOOR_DB = 28.0   # its val mean PSNR after CLI_HASH_STEPS (full size; 29.49 measured)
CLI_MESH_RES = 256         # ngp_run --save_mesh --marching_cubes_res
CLI_SYNTHETIC_STEPS = 300  # run_nerf --config configs/synthetic_smoke.yml
SNAPSHOT_PSNR_TOL_DB = 1e-4  # reloaded snapshot against the trainer's state


def copy_config(name: str, dst_dir: str, dataset_cache=None, **lines) -> str:
    """``configs/<name>`` copied as text into ``dst_dir`` with the value of
    each ``key: value`` line named in ``lines`` replaced (``logdir`` under
    a temporary directory, never ``logs/``; the scene's ``basedir``), and a
    ``dataset.cachedir`` line when ``dataset_cache`` is given. The copy is
    read by the port's YAML reader like the shipped file."""
    import re

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                           name)) as f:
        text = f.read()
    for key, value in lines.items():
        text, n = re.subn(rf"^(\s*{key}:)[^\n#]*", rf"\g<1> {value}", text, count=1,
                          flags=re.M)
        if n != 1:
            raise AssertionError(f"{name}: no '{key}:' line")
    if dataset_cache is not None:
        text, n = re.subn(r"^dataset:\n", f"dataset:\n  cachedir: {dataset_cache}\n",
                          text, count=1, flags=re.M)
        if n != 1:
            raise AssertionError(f"{name}: no 'dataset:' section")
    path = os.path.join(dst_dir, name)
    with open(path, "w") as f:
        f.write(text)
    return path


def phase_cli(dev, quick: bool, basedir: str):
    """The command lines, in process, on the scene the ``scene`` phase made:
    ``ngp_run`` from configs/machina_ngp.yml (train, snapshot, reload,
    ``--test_transforms``, ``--screenshot_transforms``), ``run_nerf`` of
    configs/machina_classic.yml (train, ``--eval``, ``--render-video``) and
    of configs/machina_ngp.yml (``--render-video --fast`` from the
    ``ngp_run`` checkpoint), ``ngp_run --encoder hash`` (the demo recipe),
    ``ngp_run --save_mesh`` from the snapshot, and ``run_nerf`` of
    configs/synthetic_smoke.yml (the synthetic sphere, made on the card).
    The YAML copies are read by the port's reader: no PyYAML here."""
    import io
    from nerf_kinematics_tpu_torch.cli import ngp_run, run_nerf
    from nerf_kinematics_tpu_torch.export.mesh import load_ply
    from nerf_kinematics_tpu_torch.io.image import read_png
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    report = {"phase": "cli", "quick": quick}
    train_json = os.path.join(basedir, "transforms_train.json")
    val_json = os.path.join(basedir, "transforms_val.json")
    with tempfile.TemporaryDirectory() as root:
        logdir = os.path.join(root, "logs")
        ngp_yml = copy_config("machina_ngp.yml", root, logdir=logdir, basedir=basedir)
        # the three classic runs load the half-resolution views once: the
        # first writes the loader's cache, the others read it
        classic_yml = copy_config("machina_classic.yml", root, logdir=logdir,
                                  basedir=basedir, randomseed=CLI_CLASSIC_SEED,
                                  dataset_cache=os.path.join(root, "cache"))
        # run_nerf on the fast engine reads the run ngp_run trained
        os.makedirs(os.path.join(root, "fast"))
        ngp_run_yml = copy_config("machina_ngp.yml", os.path.join(root, "fast"),
                                  logdir=logdir, basedir=basedir,
                                  id="ngp-transforms_train")
        snap = os.path.join(root, "machina.nktsnap")
        ply = os.path.join(root, "machina.ply")
        synthetic_yml = copy_config("synthetic_smoke.yml", root, logdir=logdir)
        with open(os.path.join(basedir, "transforms_test.json")) as f:
            meta = json.load(f)
        meta["frames"] = meta["frames"][:CLI_SHOTS]
        shots_json = os.path.join(root, "shots.json")
        with open(shots_json, "w") as f:
            json.dump(meta, f)
        shots_dir = os.path.join(root, "shots")

        printed = report["printed"] = {}

        def run(label, fn, argv):
            """fn(argv), its last printed lines kept under ``label``;
            -> (result, seconds)."""
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = fn(argv)
            torch.cuda.synchronize()
            printed[label] = buf.getvalue().strip().splitlines()[-2:]
            return res, time.perf_counter() - t0

        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        # ---- the main path: the command lines ------------------------------
        trained, t_train = run("ngp_run train", ngp_run.main, [
            train_json, "--config", ngp_yml, "--n_steps", str(CLI_NGP_STEPS),
            "--save_snapshot", snap, "--test_transforms", val_json])
        reloaded, t_reload = run("ngp_run reload", ngp_run.main, [
            train_json, "--config", ngp_yml, "--load_snapshot", snap,
            "--test_transforms", val_json, "--screenshot_transforms", shots_json,
            "--screenshot_dir", shots_dir])
        classic, t_classic = run("run_nerf classic", run_nerf.main, [
            "--config", classic_yml, "--max-iters", str(CLI_CLASSIC_STEPS)])
        classic_eval, t_eval = run("run_nerf classic --eval", run_nerf.main,
                                   ["--config", classic_yml, "--eval"])
        classic_video, t_cvideo = run("run_nerf classic --render-video", run_nerf.main,
                                      ["--config", classic_yml, "--render-video"])
        fast_video, t_fvideo = run("run_nerf --fast", run_nerf.main, [
            "--config", ngp_run_yml, "--render-video", "--fast",
            "--load-checkpoint", str(CLI_NGP_STEPS)])
        meshed, t_mesh = run("ngp_run --save_mesh", ngp_run.main, [
            train_json, "--config", ngp_yml, "--load_snapshot", snap, "--save_mesh", ply,
            "--marching_cubes_res", str(CLI_MESH_RES)])
        with contextlib.chdir(root):  # the demo recipe logs under ./logs
            hashed, t_hash = run("ngp_run --encoder hash", ngp_run.main, [
                train_json, "--encoder", "hash", "--n_steps", str(CLI_HASH_STEPS),
                "--test_transforms", val_json])
        before = dict(cuda_lib.LAUNCHES)
        synthetic, t_synth = run("run_nerf synthetic_smoke", run_nerf.main, [
            "--config", synthetic_yml, "--max-iters", str(CLI_SYNTHETIC_STEPS)])
        counts = dict(cuda_lib.LAUNCHES)
        synth_rows = {k: counts[k] - before[k] for k in counts if counts[k] > before[k]}
        points = collections.Counter(cuda_lib.POINTS)
        # -------------------------------------------------------------------
        shots = [read_png(p) for p in reloaded["screenshots"]]
        ply_verts, ply_tris = load_ply(ply)
        frames = sorted(os.listdir(fast_video["outdir"]))
        report.update({
            "ngp_run": {
                "steps": CLI_NGP_STEPS, "seconds": t_train,
                "val_psnr_db_per_frame": trained["test_psnr"],
                "val_mean_psnr_db": trained["test_mean_psnr"],
                "reloaded_val_mean_psnr_db": reloaded["test_mean_psnr"],
                "snapshot_bytes": os.path.getsize(snap), "reload_seconds": t_reload,
                "screenshots": [list(a.shape) for a in shots]},
            "run_nerf_classic": {
                "steps": CLI_CLASSIC_STEPS, "seed": CLI_CLASSIC_SEED, "seconds": t_classic,
                "val_psnr_db": classic["val_psnr"], "eval_val_psnr_db": classic_eval["val_psnr"],
                "eval_seconds": t_eval, "video_frames": classic_video["frames"],
                "video_fps": classic_video["fps"], "video_seconds": t_cvideo},
            "run_nerf_fast_video": {
                "frames": fast_video["frames"], "fps": fast_video["fps"],
                "video": os.path.basename(fast_video["video"]),
                "video_bytes": os.path.getsize(fast_video["video"]),
                "seconds": t_fvideo, "files": len(frames)},
            "ngp_run_save_mesh": {
                "resolution": CLI_MESH_RES, "printed": list(meshed["mesh"]),
                "ply_vertices": len(ply_verts), "ply_triangles": len(ply_tris),
                "ply_bytes": os.path.getsize(ply), "seconds": t_mesh},
            "ngp_run_hash": {
                "steps": CLI_HASH_STEPS, "seconds": t_hash,
                "val_psnr_db_per_frame": hashed["test_psnr"],
                "val_mean_psnr_db": hashed["test_mean_psnr"], "floor_db": CLI_HASH_FLOOR_DB},
            "run_nerf_synthetic_smoke": {
                "steps": CLI_SYNTHETIC_STEPS, "seconds": t_synth,
                "val_psnr_db": synthetic["val_psnr"], "launches": synth_rows,
                "route": ("classic fused kernels (rows 9, 10)"
                          if synth_rows.get("classic_fused_apply_cf_bwd") else
                          "classic module (autograd)")},
            "launches": counts,
        })
        emit(report)
        diff = abs(reloaded["test_mean_psnr"] - trained["test_mean_psnr"])
        if not (np.isfinite(trained["test_mean_psnr"]) and diff <= SNAPSHOT_PSNR_TOL_DB):
            raise AssertionError(f"cli: the reloaded snapshot reads {diff} dB from the "
                                 f"trainer's state (limit {SNAPSHOT_PSNR_TOL_DB})")
        if len(shots) != len(meta["frames"]) or any(a.shape != shots[0].shape or a.std() == 0
                                          for a in shots):
            raise AssertionError(f"cli: screenshots {[a.shape for a in shots]}")
        if not (np.isfinite(classic["val_psnr"])
                and abs(classic_eval["val_psnr"] - classic["val_psnr"]) <= 1e-4):
            raise AssertionError(f"cli: classic val PSNR {classic['val_psnr']} after "
                                 f"training, {classic_eval['val_psnr']} from its checkpoint")
        if not quick and not classic["val_psnr"] >= CLI_CLASSIC_FLOOR_DB:
            raise AssertionError(f"cli: classic val PSNR {classic['val_psnr']:.2f} dB under "
                                 f"{CLI_CLASSIC_FLOOR_DB}")
        for what, v in (("classic", classic_video), ("fast", fast_video)):
            if not (v["frames"] > 0 and os.path.getsize(v["video"]) > 0 and v["fps"] > 0):
                raise AssertionError(f"cli: the {what} video: {v}")
        if counts["ngp_fused_train_cf"] != CLI_NGP_STEPS or \
                counts["classic_fused_apply_cf_bwd"] <= 0:
            raise AssertionError(f"cli: launches {counts}")
        if not (tuple(meshed["mesh"]) == (len(ply_verts), len(ply_tris)) and len(ply_tris) > 0
                and np.isfinite(ply_verts).all()):
            raise AssertionError(f"cli: the mesh printed {meshed['mesh']}, its PLY holds "
                                 f"{len(ply_verts)} vertices and {len(ply_tris)} triangles")
        floor = None if quick else CLI_HASH_FLOOR_DB
        if not (np.isfinite(hashed["test_mean_psnr"])
                and (floor is None or hashed["test_mean_psnr"] >= floor)):
            raise AssertionError(f"cli: ngp_run --encoder hash reads "
                                 f"{hashed['test_mean_psnr']} dB, floor {floor}")
        if not np.isfinite(synthetic["val_psnr"]):
            raise AssertionError(f"cli: synthetic_smoke val PSNR {synthetic['val_psnr']}")
    return counts, points


def phase_bench(dev, basedir: str):
    """``python -m nerf_kinematics_tpu_torch.bench`` in process on the scene
    the ``scene`` phase made; its JSON line passes through as this phase's."""
    import io

    from nerf_kinematics_tpu_torch import bench
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    # ---- the main path: the bench ------------------------------------------
    with contextlib.redirect_stdout(io.StringIO()):
        out = bench.main(["--data", basedir])
    torch.cuda.synchronize()
    counts = dict(cuda_lib.LAUNCHES)
    points = collections.Counter(cuda_lib.POINTS)
    # -------------------------------------------------------------------------
    emit({"phase": "bench", **out})
    missing = [k for k in ("value", "mfu_hw_pct", "time_to_25db_s", "device")
               if out.get(k) is None]
    if missing or not out["value"] > 0:
        raise AssertionError(f"bench: no {missing} (value {out.get('value')})")
    return counts, points


CLASSIC_STEPS = 1000
CLASSIC_SEED = 42           # the config's experiment.randomseed
CLASSIC_SIZE = 200          # half_res: the 400x400 scene at half resolution
# held-out PSNR after CLASSIC_STEPS: the first full-size run's 24.35 dB (view
# 0; 25.96 view 1) less 2 dB, rounded down; see PERF.md section 6
CLASSIC_VAL_FLOOR_DB = 22.0
CLASSIC_RENDER_MIN_DB = 60.0  # kernel render against plain-version render
# fused and module gradients, per leaf, over the leaf's largest entry. Both
# are f32; the two forwards differ in the last bits, and a sample whose sigma
# (or a hidden pre-activation) sits within them of a ReLU's kink switches its
# whole contribution on or off: 5.4e-4 measured with the density noise,
# 1.1e-3 without (PERF.md section 6). Kernel against plain version from one
# cotangent is row 10's check (2e-4).
CLASSIC_ROUTE_TOL = 2e-3


def phase_classic(fx, dev, quick: bool, engine, aux, profile: bool):
    """The classic engine of machina_classic at full width: Trainer.fit,
    held-out PSNR, renders through the kernel and its plain version, the two
    gradient routes, a checkpoint and a legacy round trip."""
    import dataclasses
    from nerf_kinematics_tpu_torch.cameras.rays import pixel_dirs
    from nerf_kinematics_tpu_torch.io.torch_compat import import_legacy_checkpoint
    from nerf_kinematics_tpu_torch.metrics.psnr import psnr
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.config import config_from_dict
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf, build_objective
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    size = 100 if quick else CLASSIC_SIZE
    steps = 100 if quick else CLASSIC_STEPS
    t0 = time.perf_counter()
    with torch.no_grad():
        dataset = build_dataset(fx, engine, aux, dev, quick, size=size)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    base = config_from_dict(CLASSIC_CONFIG)
    report = {"phase": "classic", "quick": quick, "steps": steps,
              "size": [size, size], "views": [len(dataset.train_idx),
                                              len(dataset.val_idx)],
              "dataset_seconds": data_s}
    with tempfile.TemporaryDirectory() as logdir:
        exp = dataclasses.replace(
            base.experiment, logdir=logdir, id="chip_smoke_classic",
            print_every=steps // 4, validate_every=0, save_every=0,
            train_iters=steps, randomseed=CLASSIC_SEED)
        cfg = base.replace(experiment=exp)
        trainer = Trainer(cfg, dataset, export_legacy=True)  # device=None: the card
        state = trainer.init_or_resume()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launch_counts()
        # ---- the main path: training --------------------------------------
        t1 = time.perf_counter()
        res = trainer.fit(state=state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        counts_fit = dict(cuda_lib.LAUNCHES)
        points_fit = collections.Counter(cuda_lib.POINTS)
        # ---- the main path: serving the held-out views --------------------
        eng = trainer.engine
        ds = dataset
        render = eng.make_render_fn(ds.intrinsics, ds.near, ds.far, False)
        val_poses = [torch.tensor(ds.poses[int(i)], device=dev) for i in ds.val_idx]
        with eng.bound(res.state.params):
            render(val_poses[0])  # warm-up
            cuda_lib.reset_launch_counts()
            frames, ms_frames = timed(lambda: [render(p) for p in val_poses])
            counts_serve = dict(cuda_lib.LAUNCHES)
            points_serve = collections.Counter(cuda_lib.POINTS)
            # the same views through the plain version of row 9
            kernel_fn = cfc.classic_fused_apply_cf
            cfc.classic_fused_apply_cf = lambda p, x, v, c: \
                cfc.classic_fused_apply_cf_ref(p, x, v, c)
            try:
                plain_render = eng.make_render_fn(ds.intrinsics, ds.near, ds.far, False)
            finally:
                cfc.classic_fused_apply_cf = kernel_fn
            plain, ms_plain = timed(lambda: [plain_render(p) for p in val_poses])
        # -------------------------------------------------------------------
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        for f in frames:
            check_maps(f, "classic render")
        render_db = [psnr(a["rgb"].cpu().numpy(), b["rgb"].cpu().numpy())
                     for a, b in zip(frames, plain)]
        val_db = [psnr(f["rgb"].cpu().numpy(), ds.images[int(i)])
                  for f, i in zip(frames, ds.val_idx)]
        # checkpoints: the trainer's own and the reference's legacy file
        trainer.save_checkpoint(res.state, steps, res.last_metrics, val_db[0])
        fresh = eng.init_state(seed=99)
        back, at = trainer.ckpt.restore(fresh, layout=eng.layout)
        same = at == steps and all(torch.equal(a, b) for a, b in (
            (back.params, res.state.params), (back.opt_state.mu, res.state.opt_state.mu),
            (back.opt_state.nu, res.state.opt_state.nu), (back.step, res.state.step)))
        legacy = import_legacy_checkpoint(
            os.path.join(trainer.rundir, f"checkpoint{steps}.ckpt"))
        with eng.bound(res.state.params):
            want = {**{f"coarse.{k}": v for k, v in eng.model.coarse.state_dict().items()},
                    **{f"fine.{k}": v for k, v in eng.model.fine.state_dict().items()}}
            got = {**{f"coarse.{k}": v for k, v in legacy["state_coarse"].items()},
                   **{f"fine.{k}": v for k, v in legacy["state_fine"].items()}}
            legacy_same = legacy["step"] == steps and set(got) == set(want) and all(
                torch.equal(got[k], want[k].cpu()) for k in want)
        prof = profile_steps(trainer, res.state, groups=CLASSIC_PARTS) \
            if profile else None
        if prof is not None:
            prof["row_10_ms_per_step"] = sum(
                v for k, v in prof["ms_per_step_by_group"].items() if "row 10" in k)
        trainer.close()

    # ---- the two gradient routes from one state and one set of draws ------
    routes = {}
    n_rays = base.nerf.num_random_rays
    t = base.nerf.train
    gen = torch.Generator(device=dev).manual_seed(21)
    imgs, poses = ds.split("train")
    pix = (torch.randint(0, len(imgs), (n_rays,), generator=gen, device=dev),
           torch.randint(0, size, (n_rays,), generator=gen, device=dev),
           torch.randint(0, size, (n_rays,), generator=gen, device=dev))
    u_c = torch.rand((n_rays, t.num_coarse), generator=gen, device=dev)
    u_f = torch.rand((n_rays, t.num_fine), generator=gen, device=dev)
    nz_c = torch.randn((n_rays, t.num_coarse), generator=gen, device=dev)
    nz_f = torch.randn((n_rays, t.num_coarse + t.num_fine), generator=gen, device=dev)
    images = torch.as_tensor(imgs, device=dev)
    poses_t = torch.as_tensor(poses, device=dev)
    img, row, col = pix
    intr = ds.intrinsics
    c2w = poses_t[img]
    dirs = pixel_dirs(col.float(), row.float(), intr.fl_x, intr.fl_y, intr.cx, intr.cy)
    rays_d = torch.einsum("nij,nj->ni", c2w[:, :3, :3], dirs)
    batch = (c2w[:, :3, 3], rays_d,
             rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True),
             images[img, row, col])
    for name, mode in (("fused", "on"), ("module", "off")):
        c = base.replace(
            model_coarse=dataclasses.replace(base.model_coarse, fused=mode),
            model_fine=dataclasses.replace(base.model_fine, fused=mode))
        e = ClassicNerf(c)
        e.init_state(seed=CLASSIC_SEED)  # the same fresh weights on both routes
        cuda_lib.reset_launch_counts()
        objective = build_objective(e, ds.near, ds.far)
        (loss, _), grads = objective(batch, None, None, u_coarse=u_c, u_fine=u_f,
                                     noise_coarse=nz_c, noise_fine=nz_f)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.LAUNCHES)
        # the same without density noise
        (_, _), grads0 = objective(batch, None, None, u_coarse=u_c, u_fine=u_f,
                                   noise_coarse=torch.zeros_like(nz_c),
                                   noise_fine=torch.zeros_like(nz_f))
        routes[name] = (float(loss), grads, launches, grads0)

    def route_errors(i):
        per_leaf, zero, finite = {}, [], True
        for k, g in routes["module"][i].items():
            fused_g = routes["fused"][i][k]
            finite = finite and bool(torch.isfinite(fused_g).all())
            scale = g.abs().max().item()
            if scale == 0.0:  # a leaf no ray reached: zero on both routes
                zero.append(k)
                per_leaf[k] = float("inf") if fused_g.abs().max().item() else 0.0
                continue
            per_leaf[k] = (fused_g - g).abs().max().item() / scale
        return per_leaf, zero, finite

    per_leaf, zero_leaves, finite = route_errors(1)
    per_leaf0, _, finite0 = route_errors(3)
    finite = finite and finite0
    worst, worst0 = max(per_leaf.values()), max(per_leaf0.values())
    loss_rel = abs(routes["fused"][0] - routes["module"][0]) / abs(routes["module"][0])

    losses = np.asarray(res.losses)
    first, last = float(losses[:16].mean()), float(losses[-64:].mean())
    ms_per_step = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
    report.update({
        "loss_first16": first, "loss_last64": last,
        "train_psnr_last64": float(-10 * np.log10(max(last, 1e-12))),
        "val_psnr_db": val_db, "val_mean_psnr_db": float(np.mean(val_db)),
        "val_psnr_floor_db": CLASSIC_VAL_FLOOR_DB,
        "ms_per_step": ms_per_step, "rays_per_s": n_rays / ms_per_step * 1e3,
        "fit_seconds": fit_s, "chunks": [[k, s] for k, s in res.chunk_seconds],
        "eval_ms_per_frame": ms_frames / len(frames),
        "plain_eval_ms_per_frame": ms_plain / len(plain),
        "kernel_vs_plain_render_psnr_db": render_db,
        "launches_fit": counts_fit, "launches_serve": counts_serve,
        "routes": {k: {"loss": v[0], "launches": v[2]} for k, v in routes.items()},
        "routes_grad_max_rel": worst, "routes_loss_rel": loss_rel,
        "routes_zero_leaves": zero_leaves,
        "routes_worst_leaves": sorted(per_leaf.items(), key=lambda kv: -kv[1])[:6],
        "routes_grad_max_rel_without_noise": worst0,
        "routes_tolerance": CLASSIC_ROUTE_TOL,
        "checkpoint_round_trip": same, "legacy_round_trip": legacy_same,
        "peak_memory_gib": peak_gb,
    })
    if prof is not None:
        report["profile"] = prof
    emit(report)
    if not np.isfinite(losses).all():
        raise AssertionError("classic: non-finite loss")
    evals = counts_fit["classic_fused_apply_cf"] - 2 * steps
    if counts_fit["classic_fused_apply_cf_bwd"] != 2 * steps or evals < 0:
        raise AssertionError(f"classic: launches {counts_fit} for {steps} steps")
    if counts_serve["classic_fused_apply_cf"] <= 0:
        raise AssertionError("classic: the render did not go through row 9")
    if routes["fused"][2]["classic_fused_apply_cf_bwd"] != 2 or \
            routes["module"][2]["classic_fused_apply_cf"] != 0:
        raise AssertionError(f"classic: routes took other paths: {routes['fused'][2]}, "
                             f"{routes['module'][2]}")
    # the loss sums the coarse and the fine MSE, and the density noise keeps
    # it up: the held-out PSNR floor below is the quality check
    if not last < (1.0 if quick else 0.75) * first:
        raise AssertionError(f"classic: loss {first} -> {last}")
    if not quick and CLASSIC_VAL_FLOOR_DB is not None and \
            not min(val_db) >= CLASSIC_VAL_FLOOR_DB:
        raise AssertionError(f"classic: held-out PSNR {val_db} under the floor "
                             f"{CLASSIC_VAL_FLOOR_DB} dB")
    if not min(render_db) >= CLASSIC_RENDER_MIN_DB:
        raise AssertionError(f"classic: kernel and plain renders at {render_db} dB")
    if not (finite and max(worst, worst0) <= CLASSIC_ROUTE_TOL and loss_rel <= 1e-5):
        raise AssertionError(f"classic: routes differ: grads {worst}, loss {loss_rel}")
    if not (same and legacy_same):
        raise AssertionError("classic: a checkpoint round trip failed")
    return ({k: counts_fit[k] + counts_serve[k] for k in counts_fit},
            points_fit + points_serve)


# ---- the grid / projected occupancy proposals --------------------------------

PROPOSAL_STEPS = 512           # each mode, from the train phase's start
PROPOSAL_MARGIN_DB = ROBOT_PSNR_MARGIN_DB  # val mean over a constant image's
PROPOSAL_POINTS = 524288       # the two-call step's proposal points
PROPOSAL_TRILINEAR_TOL = 1e-6  # card against CPU, relative to max(1, |value|)


def constant_image_psnr(ds) -> float:
    """The held-out views' mean PSNR of a constant image of the training
    views' mean colour."""
    mean_rgb = ds.images[ds.train_idx].reshape(-1, 3).mean(0)
    return float(np.mean([-10.0 * np.log10(np.mean((ds.images[int(i)] - mean_rgb) ** 2))
                          for i in ds.val_idx]))


def lookup_points(n: int, bound: float, gen) -> torch.Tensor:
    """(n, 3) world points over [-1.1, 1.1]^3 * bound on the CPU, the first
    twelve with a NaN on each axis and on pairs of axes, or +-inf."""
    pts = (torch.rand((n, 3), generator=gen) * 2.2 - 1.1) * bound
    nan, inf = float("nan"), float("inf")
    for i, axes in enumerate([(0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]):
        pts[i, list(axes)] = nan
    pts[7, 0], pts[8, 1], pts[9, 2] = inf, -inf, inf
    pts[10] = torch.tensor([-inf, inf, -inf])
    pts[11, 0], pts[11, 2] = nan, inf
    return pts


def grid_lookups_on_card(grid, dev) -> dict:
    """occupancy_at, occupancy_at_nearest and occupancy_at_projected on the
    card at PROPOSAL_POINTS points against the same calls on the CPU: exact
    for nearest and projected, PROPOSAL_TRILINEAR_TOL for trilinear, and
    the same NaN, +inf and -inf masks for all three."""
    from nerf_kinematics_tpu_torch.ops import occupancy as occ

    gen = torch.Generator().manual_seed(11)
    cpu_grid = occ.OccupancyGrid(grid.density.cpu(), grid.bound.cpu())
    pts = lookup_points(PROPOSAL_POINTS, float(grid.bound), gen)
    fns = {
        "occupancy_at": lambda g, x: occ.occupancy_at(g, x),
        "occupancy_at_nearest": lambda g, x: occ.occupancy_at_nearest(g, x),
        "occupancy_at_projected": lambda g, x: occ.occupancy_at_projected(
            occ.axis_projections(g), x, occ._linear_to_unit(g)),
    }
    out = {}
    for name, fn in fns.items():
        want = fn(cpu_grid, pts)
        xd = pts.to(dev)
        got, ms = timed(lambda: fn(grid, xd))
        got = got.cpu()
        # raises where a NaN, +inf or -inf mask differs
        nonfinite = same_masks(name, [("card against the CPU", got, want)])
        fin = torch.isfinite(want)
        err = float(((got[fin] - want[fin]).abs()
                     / want[fin].abs().clamp(min=1.0)).max())
        out[name] = {"ms": ms, "max_rel_err": err, "nonfinite_values": nonfinite,
                     "exact": bool(torch.equal(got[fin], want[fin]))}
    return out


def phase_proposals(fx, dev, quick: bool, dataset):
    """machina_ngp.yml with ``ngp.occ_proposal`` hull, grid and projected,
    PROPOSAL_STEPS steps each from the train phase's start on its views (the
    two-call step: rows 2 and 7; the hull's row 1 only for hull), each
    against a constant image; then the three grid lookups on the card
    against the CPU on the grid-proposal run's trained grid."""
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    report = {"phase": "proposals", "quick": quick}
    total = collections.Counter()
    all_points = collections.Counter()
    const = constant_image_psnr(dataset)
    report["constant_image_psnr_db"] = const
    fail = []
    grid = None
    with tempfile.TemporaryDirectory() as logdir:
        for mode in ("hull", "grid", "projected"):
            cfg, steps = _train_config(fx, logdir, quick, steps=PROPOSAL_STEPS,
                                       occ_proposal=mode)
            trainer = Trainer(cfg, dataset, device=dev)
            state = trainer.engine.init_state()
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            # ---- the main path: training and the held-out renders -----------
            t0 = time.perf_counter()
            res = trainer.fit(state=state)
            split = trainer.evaluate_split(res.state, "val")
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = dict(cuda_lib.LAUNCHES)
            points = collections.Counter(cuda_lib.POINTS)
            # -----------------------------------------------------------------
            total.update(counts)
            all_points.update(points)
            losses = np.asarray(res.losses)
            ms = statistics.median(s / k * 1e3 for k, s in res.chunk_seconds)
            r = report[mode] = {
                "steps": steps, "ms_per_step": ms, "fit_seconds": fit_s,
                "loss_first16": float(losses[:16].mean()),
                "loss_last16": float(losses[-16:].mean()),
                "val_psnr_db": split["per_frame"][0], "val_mean_psnr_db": split["mean_psnr"],
                "refreshes": [[i, k] for i, k, _ in res.occupancy_refreshes],
                "launches_by_row": by_row(counts, points)}
            if not (np.isfinite(losses).all()
                    and split["mean_psnr"] >= const + (0.0 if quick else PROPOSAL_MARGIN_DB)):
                fail.append(f"{mode}: val mean {split['mean_psnr']:.2f} dB, constant "
                            f"image {const:.2f} dB")
            hull_launches = counts["occupancy_at_hull"]
            if (hull_launches > 0) != (mode == "hull") or counts["ngp_fused_train_cf"] != steps:
                fail.append(f"{mode}: launches {counts}")
            if mode == "grid":
                grid = res.state.aux
            trainer.close()
            del trainer, res, state
    report["lookups"] = grid_lookups_on_card(grid, dev)
    for name, r in report["lookups"].items():
        exact = name != "occupancy_at"
        if (exact and not r["exact"]) or r["max_rel_err"] > PROPOSAL_TRILINEAR_TOL:
            fail.append(f"{name} on the card: {r}")
    emit(report)
    if fail:
        raise AssertionError(f"proposals: {fail}")
    return total, all_points


# ---- data parallelism: parallel/ on one card -----------------------------------

MESH_STEPS = 512               # machina_ngp.yml: a full refresh at 256, incremental at 512
MESH_CLASSIC_STEPS = 100
MESH_FRAMES = 8
MESH_GRAD_TOL = 1e-5           # step 1's rank-mean gradient, of each leaf's largest |g|
MESH_G_LIVE = 2e-6             # parameters compared where |g| exceeds this
MESH_STEP1_LOSS_RTOL = 1e-5    # step 1's loss: one batch, the same weights
MESH_PARAM_TOL = 1e-6          # step 1's parameters where |g| > MESH_G_LIVE
# Beyond step 1: the refresh at MESH_STEPS // 2, run in one process from the
# ranks' state before it, gives the ranks' grid bit for bit; the step after
# it, taken in one process from the ranks' state, is held as step 1 is; the
# generator ends in the same state. The loss curve: MESH_CONTROLS runs of
# one process from weights nudged by one ulp (a random half, seeds 1..)
# part from the unnudged run as rounding alone parts it; the ranks' first
# MESH_FIRST_LOSSES losses are held within MESH_LOSS_RTOL and the mean of
# their last MESH_LAST_LOSSES within MESH_LAST_RTOL, or within the largest
# parting of a control where that is wider (their readings: PERF.md
# section 6).
MESH_CONTROLS = 5
MESH_LOCKSTEP = 8              # steps one process takes from the ranks' state after the refresh
MESH_FIRST_LOSSES = 32
MESH_LOSS_RTOL = 1e-3
MESH_LAST_LOSSES = 100
MESH_LAST_RTOL = 0.02
MESH_WINDOW = 64               # steps a window of the printed curve gaps
MESH_VAL_DB = 0.2
MESH_RANK_TIMEOUT = 420        # seconds a rank (or a torchrun command) may take
MESH_TORCHRUN_STEPS = 512


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fixture_engine(fx, dev, mesh=None):
    """The fixture's trained fast engine and grid on ``dev``."""
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    engine = NGPEngine(fx.config, scene_bound=1.0, device=dev, mesh=mesh)
    engine.load_flax_params(fx.params)
    return engine, grid_from_numpy(fx.grid_density, fx.grid_bound, device=dev)


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


def mesh_views(fx, dev, quick: bool) -> tuple:
    """The train phase's views and the classic phase's views of the
    fixture's model, as build_dataset renders them."""
    engine, aux = fixture_engine(fx, dev)
    with torch.no_grad():
        return (build_dataset(fx, engine, aux, dev, quick),
                build_dataset(fx, engine, aux, dev, quick,
                              size=100 if quick else CLASSIC_SIZE))


def save_views(path: str, views) -> None:
    from nerf_kinematics_tpu_torch.io.fixture import _intrinsics_row

    arrays = {}
    for k, ds in enumerate(views):
        arrays.update({f"images{k}": ds.images, f"poses{k}": ds.poses,
                       f"intrinsics{k}": _intrinsics_row(ds.intrinsics),
                       f"near_far{k}": np.asarray([ds.near, ds.far])})
    np.save(path, arrays, allow_pickle=True)


def load_views(path: str) -> tuple:
    """:func:`save_views`'s file -> the datasets (two views held out)."""
    from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays
    from nerf_kinematics_tpu_torch.io.fixture import intrinsics_from_row

    a = np.load(path, allow_pickle=True).item()
    return tuple(dataset_from_arrays(a[f"images{k}"], a[f"poses{k}"],
                                     intrinsics_from_row(a[f"intrinsics{k}"]),
                                     *a[f"near_far{k}"], n_val=2) for k in range(2))


SNAP_KEYS = ("params", "mu", "nu", "count", "step", "grid", "gen")


def snapshot(state) -> dict:
    """A fast-engine train state as arrays (:data:`SNAP_KEYS`: its grid and
    its generator's state included)."""
    return {"params": state.params.cpu().numpy(), "mu": state.opt_state.mu.cpu().numpy(),
            "nu": state.opt_state.nu.cpu().numpy(),
            "count": np.int64(int(state.opt_state.count)), "step": np.int64(int(state.step)),
            "grid": state.aux.density.cpu().numpy(),
            "gen": state.generator.get_state().numpy()}


def state_from(trainer, snap: dict):
    """:func:`snapshot`'s arrays -> a train state of ``trainer``'s engine."""
    st = trainer.engine.init_state()
    dev = st.params.device
    for t, k in ((st.params, "params"), (st.opt_state.mu, "mu"), (st.opt_state.nu, "nu"),
                 (st.opt_state.count, "count"), (st.step, "step")):
        t.copy_(torch.as_tensor(snap[k], device=dev))
    st.aux = st.aux._replace(density=torch.as_tensor(snap["grid"], device=dev))
    st.generator.set_state(torch.from_numpy(np.ascontiguousarray(snap["gen"])))
    return st


def snapshot_first_refresh(engine, snaps: dict) -> None:
    """Have ``engine``'s first refresh of a train state keep the state's
    :func:`snapshot` before it (``snaps["before"]``) and after it
    (``snaps["after"]``). ``del engine.update_occupancy`` undoes it."""
    refresh = engine.update_occupancy

    def hooked(aux, *args, **kw):
        if "before" in snaps or not hasattr(aux, "params"):
            return refresh(aux, *args, **kw)
        snaps["before"] = snapshot(aux)
        aux = refresh(aux, *args, **kw)
        snaps["after"] = snapshot(aux)
        return aux

    engine.update_occupancy = hooked


def steps_from(trainer, snap: dict, n: int) -> tuple:
    """``n`` train steps of ``trainer`` from :func:`snapshot`'s state ->
    (the gradient Adam saw in the first, the parameters after it, every
    step's loss)."""
    st = state_from(trainer, snap)
    b1 = trainer.engine.adam.b1
    mu0 = st.opt_state.mu.clone()
    losses = []
    for k in range(n):
        st, m = trainer._train_step(st, trainer.images, trainer.poses, trainer.ray_buf)
        losses.append(float(m["loss"]))
        if k == 0:
            g = ((st.opt_state.mu - b1 * mu0) / (1.0 - b1)).cpu().numpy()
            p = st.params.cpu().numpy()
    return g, p, np.asarray(losses)


def mesh_controls(trainer, start: dict) -> np.ndarray:
    """MESH_CONTROLS runs of ``trainer.fit`` from :func:`snapshot`'s state
    ``start``, each with one ulp added to or taken from a random half of its
    weights (seeds 1..) -> their losses, one row each."""
    rows = []
    for seed in range(1, MESH_CONTROLS + 1):
        rows.append(trainer.fit(state=nudged(state_from(trainer, start), seed)).losses)
    return np.asarray(rows)


def mesh_runs(fx, dev, quick: bool, mesh, views, rank0=None) -> tuple:
    """What the mesh phase runs on every rank (``mesh``) and in one process
    (None): machina_ngp.yml from the train phase's start for MESH_STEPS
    steps, its first step alone as well (the rank-mean gradient Adam saw is
    its first moment over 1 - b1), its state before and after the first
    refresh, and the step after that refresh again; machina_classic.yml
    MESH_CLASSIC_STEPS steps on the classic phase's views, its first step
    alone as well; the frame-batch renderer on MESH_FRAMES frames of the
    fixture's model. ``views``: :func:`mesh_views`'s datasets.
    ``rank0`` (one process only): rank 0's arrays. From its states around
    the refresh this process runs the refresh and MESH_LOCKSTEP steps; then
    the controls (:func:`mesh_controls`).
    -> (arrays, report, launches, points)."""
    from nerf_kinematics_tpu_torch.data.machina import orbit_poses
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.config import config_from_dict
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    import dataclasses

    arrays, report = {}, {}
    launches = dict.fromkeys(cuda_lib.LAUNCHES, 0)
    points = collections.Counter()

    def count():
        for k, v in cuda_lib.LAUNCHES.items():
            launches[k] += v
        points.update(cuda_lib.POINTS)

    views, views_c = views
    base_c = config_from_dict(CLASSIC_CONFIG)
    with tempfile.TemporaryDirectory() as logdir:
        cfg_n, steps_n = _train_config(fx, logdir, quick, steps=MESH_STEPS)
        cfg_c = base_c.replace(experiment=dataclasses.replace(
            base_c.experiment, logdir=logdir, id="mesh_classic", print_every=0,
            validate_every=0, save_every=0,
            train_iters=20 if quick else MESH_CLASSIC_STEPS, randomseed=CLASSIC_SEED))
        for tag, cfg, ds in (("ngp", cfg_n, views), ("classic", cfg_c, views_c)):
            trainer = Trainer(cfg, ds, device=dev, use_mesh=mesh is not None)
            state = trainer.init_or_resume()
            one = state.clone()
            snaps = {}
            if tag == "ngp":
                snaps["start"] = snapshot(state)
                snapshot_first_refresh(trainer.engine, snaps)
            torch.cuda.synchronize()
            cuda_lib.reset_launch_counts()
            # ---- the main path -------------------------------------------
            one, _ = trainer._train_step(one, trainer.images, trainer.poses,
                                          trainer.ray_buf)
            res = trainer.fit(state=state)
            torch.cuda.synchronize()
            count()
            # ----------------------------------------------------------------
            b1 = trainer.engine.adam.b1
            arrays[f"{tag}_g1"] = (one.opt_state.mu / (1.0 - b1)).cpu().numpy()
            arrays[f"{tag}_p1"] = one.params.cpu().numpy()
            arrays[f"{tag}_losses"] = np.asarray(res.losses)
            r = report[tag] = {
                "steps": len(res.losses),
                "ms_per_step": statistics.median(s / k * 1e3 for k, s in res.chunk_seconds),
                "params_sha256": _digest(res.state.params)}
            if res.state.aux is not None:
                r["grid_sha256"] = _digest(res.state.aux.density)
                r["refreshes"] = [[i, k] for i, k, _ in res.occupancy_refreshes]
            if trainer.is_main:
                r["val_psnr_db"] = trainer.validate(res.state)["val_psnr"]
            if tag == "ngp":
                del trainer.engine.update_occupancy
                r["generator_sha256"] = _digest(res.state.generator.get_state())
                for k in ("before", "after"):
                    arrays.update({f"ngp_{k}_{n}": v for n, v in snaps[k].items()})
                ranks_at = (None if rank0 is None else
                            {k: {n: rank0[f"ngp_{k}_{n}"] for n in SNAP_KEYS}
                             for k in ("before", "after")})
                g, p, lk = steps_from(trainer, snaps["after"] if rank0 is None
                                      else ranks_at["after"],
                                      1 if rank0 is None else MESH_LOCKSTEP)
                arrays.update(ngp_g_mid=g, ngp_p_mid=p, ngp_lockstep_losses=lk)
                if rank0 is not None:
                    st = trainer.engine.update_occupancy(
                        state_from(trainer, ranks_at["before"]), full=True)
                    arrays["ngp_grid_from_ranks"] = st.aux.density.cpu().numpy()
                    arrays["control_losses"] = mesh_controls(trainer, snaps["start"])
            trainer.close()
            del trainer, res, state, one
    # ---- serving: the frame batch over the ranks ------------------------------
    engine, aux = fixture_engine(fx, dev, mesh=mesh)
    poses = torch.tensor(orbit_poses(MESH_FRAMES), device=dev)
    batch = engine.make_fast_render_batch(fx.intrinsics, fx.config.dataset.near,
                                          fx.config.dataset.far, False)
    cuda_lib.reset_launch_counts()
    out, ms = timed(lambda: batch(poses, aux))
    count()
    report["serve"] = {"frames": MESH_FRAMES, "ms": ms,
                       "sha256": {k: _digest(v) for k, v in sorted(out.items())}}
    return arrays, report, launches, points


def mesh_rank_main(args) -> int:
    """One rank of the mesh phase's two (``--mesh-rank``): joins the gloo
    group on cuda:0, runs :func:`mesh_runs` and writes its results."""
    import torch.distributed as dist

    from nerf_kinematics_tpu_torch.io.fixture import read_fixture
    from nerf_kinematics_tpu_torch.parallel.mesh import make_mesh
    from nerf_kinematics_tpu_torch.parallel.multihost import initialize_multihost

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"127.0.0.1:{args.mesh_port}", args.mesh_world, args.mesh_rank,
                         backend="gloo", device=dev)
    mesh = make_mesh(dev)
    views = load_views(os.path.join(args.mesh_out, "views.npy"))
    arrays, report, launches, points = mesh_runs(read_fixture(), dev, args.quick, mesh,
                                                 views)
    report.update(rank=mesh.rank, world=mesh.world, backend=mesh.backend,
                  launches=launches,
                  points=[[k, b, v] for (k, b), v in points.items()])
    np.savez(os.path.join(args.mesh_out, f"rank{mesh.rank}.npz"), **arrays)
    with open(os.path.join(args.mesh_out, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def run_ranks(argvs, timeout: float, env=None) -> list:
    """Start every command at once and wait for all: any failure or a
    command past ``timeout`` seconds kills the others and raises. Each
    command leads a process group of its own, and what is left of a group
    is killed whole (a launcher's workers with it). -> their (stdout,
    stderr)."""
    import signal
    import subprocess

    procs = [subprocess.Popen(a, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, start_new_session=True)
             for a in argvs]
    deadline = time.monotonic() + timeout
    outs, bad = [], None
    for k, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            bad = f"command {k} passed {timeout} s"
            break
        outs.append((out, err))
        if p.returncode != 0:
            bad = f"command {k} exited {p.returncode}:\n{err[-3000:]}"
            break
    for p in procs:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(p.pid, signal.SIGKILL)
        if p.poll() is None:
            p.communicate()
    if bad is not None:
        raise AssertionError(f"mesh: {bad}")
    return outs


def leafwise_gap(got, want, layout) -> dict:
    """Each leaf's largest |got - want| over its largest |want|."""
    gaps = {}
    for name, _, off, n in layout.entries:
        w = want[off:off + n]
        gaps[name] = float(np.abs(got[off:off + n] - w).max() / max(np.abs(w).max(), 1e-30))
    return gaps


def step_against(got: dict, want: dict, tag: str, which: str, layout, loss, want_loss) -> dict:
    """One step of the ranks (``got``'s ``{tag}_g{which}`` gradient, ``{tag}_p{which}``
    parameters) against the same step in one process (``want``'s): each
    leaf's gradient gap, the parameters where |g| > MESH_G_LIVE, the loss,
    the gradient's signs."""
    g, want_g = got[f"{tag}_g{which}"], want[f"{tag}_g{which}"]
    live = np.abs(want_g) > MESH_G_LIVE
    flipped = np.sign(g) != np.sign(want_g)
    gap = np.abs(got[f"{tag}_p{which}"] - want[f"{tag}_p{which}"])
    return {"grad_gap_by_leaf_max": max(leafwise_gap(g, want_g, layout).values()),
            "loss_rel": float(abs(loss - want_loss) / abs(want_loss)),
            "params_gap_where_live": float(gap[live].max()), "live_share": float(live.mean()),
            "grad_signs_differ": int(flipped.sum()),
            "grad_signs_differ_where_live": int((flipped & live).sum())}


def step_ok(c: dict) -> bool:
    """:func:`step_against`'s reading within the step-1 tolerances."""
    return (c["grad_gap_by_leaf_max"] <= MESH_GRAD_TOL
            and c["params_gap_where_live"] <= MESH_PARAM_TOL
            and c["loss_rel"] <= MESH_STEP1_LOSS_RTOL
            and not c["grad_signs_differ_where_live"])


def phase_mesh(fx, dev, quick: bool, basedir: str):
    """Data parallelism (parallel/) on the card: (a) one step of
    machina_ngp.yml through an NCCL group of world 1, bit for bit the step
    without a group; (b) two ranks over gloo, both on cuda:0, against one
    process: machina_ngp.yml from the train phase's start, MESH_STEPS steps;
    machina_classic.yml, MESH_CLASSIC_STEPS steps (rows 9, 10); the frame
    batch of the fixture's model split over the ranks; (c) ``torchrun
    --nproc_per_node 2 ... cli.run_nerf --mesh`` on machina400:
    MESH_TORCHRUN_STEPS steps, then the ``--fast`` video, against one
    process's render of the same checkpoint. Two ranks time-slice one card:
    their ms a step is no speed result."""
    import torch.distributed as dist

    from nerf_kinematics_tpu_torch.io.image import read_png
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.parallel.mesh import Mesh
    from nerf_kinematics_tpu_torch.train.loop import build_shuffled_ray_buffer
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    report = {"phase": "mesh", "quick": quick}
    seconds = {}
    total = collections.Counter()
    all_points = collections.Counter()
    fail = []
    here = os.path.abspath(__file__)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    # ---- (a) NCCL at world 1: the step without a group, bit for bit ----------
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    mesh1 = Mesh(rank=0, world=1, device=dev, backend=str(dist.get_backend()))
    both = mesh_views(fx, dev, quick)
    views = both[0]
    with tempfile.TemporaryDirectory() as logdir:
        cfg, _ = _train_config(fx, logdir, quick)
    imgs, poses = views.split("train")
    buf = build_shuffled_ray_buffer(torch.as_tensor(imgs, device=dev),
                                    torch.as_tensor(poses, device=dev), views.intrinsics,
                                    seed=cfg.experiment.randomseed)
    stepped = {}
    for tag, m in (("alone", None), ("nccl", mesh1)):
        eng = NGPEngine(cfg, 1.0, device=dev, mesh=m)
        st = eng.init_state()
        step = eng.make_train_step(views.intrinsics, views.near, views.far, False)
        cuda_lib.reset_launch_counts()
        st, met = step(st, None, None, buf)
        torch.cuda.synchronize()
        total.update(cuda_lib.LAUNCHES)
        all_points.update(cuda_lib.POINTS)
        stepped[tag] = (st, float(met["loss"]))
    (a, la), (b, lb) = stepped["alone"], stepped["nccl"]
    same = (torch.equal(a.opt_state.mu, b.opt_state.mu) and torch.equal(a.params, b.params)
            and la == lb)
    report["nccl_world1"] = {"backend": mesh1.backend, "world": mesh1.world,
                             "gradient_and_step_bit_equal": same, "loss": la}
    if not same:
        fail.append("the NCCL world-1 step differs from the step without a group")
    dist.destroy_process_group()
    del stepped, a, b, buf
    seconds["nccl_world1"] = time.perf_counter() - t0

    # ---- (b) two ranks over gloo on cuda:0 against one process -----------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as out_dir:
        save_views(os.path.join(out_dir, "views.npy"), both)
        port = free_port()
        argvs = [[sys.executable, here, "--mesh-rank", str(r), "--mesh-world", "2",
                  "--mesh-port", str(port), "--mesh-out", out_dir]
                 + (["--quick"] if quick else []) for r in range(2)]
        run_ranks(argvs, MESH_RANK_TIMEOUT, env=env)
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                rep = json.load(f)
            ranks.append((dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))), rep))
    seconds["two_ranks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays, single, launches, points = mesh_runs(fx, dev, quick, None, both,
                                                 rank0=ranks[0][0])
    seconds["one_process"] = time.perf_counter() - t0
    total.update(launches)
    all_points.update(points)
    for _, rep in ranks:
        total.update(rep["launches"])
        all_points.update({(k, b): v for k, b, v in rep["points"]})
    (a0, r0), (a1, r1) = ranks
    from nerf_kinematics_tpu_torch.train.config import config_from_dict
    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    layouts = {"ngp": NGPEngine(fx.config, 1.0, device="cpu").layout,
               "classic": ClassicNerf(config_from_dict(CLASSIC_CONFIG), device="cpu").layout}
    cmp = report["two_ranks"] = {"ranks": [[r0["rank"], r0["world"], r0["backend"]],
                                           [r1["rank"], r1["world"], r1["backend"]]]}
    for tag in ("ngp", "classic"):
        c = cmp[tag] = {
            "step1": step_against(a0, arrays, tag, "1", layouts[tag],
                                  a0[f"{tag}_losses"][0], arrays[f"{tag}_losses"][0]),
            "ranks_step1_equal": bool(np.array_equal(a0[f"{tag}_g1"], a1[f"{tag}_g1"])),
            "ms_per_step_one_process": single[tag]["ms_per_step"],
            "ms_per_step_two_ranks": [r0[tag]["ms_per_step"], r1[tag]["ms_per_step"]],
            "ranks_final_params_equal": r0[tag]["params_sha256"] == r1[tag]["params_sha256"]}
        if not step_ok(c["step1"]):
            fail.append(f"{tag}: step 1 against one process: {c['step1']}")
        if not (c["ranks_step1_equal"] and c["ranks_final_params_equal"]):
            fail.append(f"{tag}: the ranks' states differ")
        if "grid_sha256" in r0[tag] and r0[tag]["grid_sha256"] != r1[tag]["grid_sha256"]:
            fail.append(f"{tag}: the ranks' grids differ")
    # the NGP run past step 1: the refresh, the step after it, the draws
    c = cmp["ngp"]
    half = int(a0["ngp_after_step"])
    lock = arrays["ngp_lockstep_losses"]
    c.update(
        refresh_at=half,
        refresh_from_ranks_state_bit_equal=bool(np.array_equal(
            arrays["ngp_grid_from_ranks"], a0["ngp_after_grid"])),
        grid_cells_differ_at_refresh=int((arrays["ngp_after_grid"]
                                          != a0["ngp_after_grid"]).sum()),
        grid_max_gap_at_refresh=float(np.abs(arrays["ngp_after_grid"]
                                             - a0["ngp_after_grid"]).max()),
        after_refresh=step_against(a0, arrays, "ngp", "_mid", layouts["ngp"],
                                   a0["ngp_lockstep_losses"][0], lock[0]),
        lockstep_losses_rel=(np.abs(lock / a0["ngp_losses"][half:half + len(lock)] - 1)
                             .tolist()),
        draws_equal=bool(r0["ngp"]["generator_sha256"] == r1["ngp"]["generator_sha256"]
                         == single["ngp"]["generator_sha256"]
                         and np.array_equal(a0["ngp_before_gen"], arrays["ngp_before_gen"])))
    if not (c["refresh_from_ranks_state_bit_equal"] and step_ok(c["after_refresh"])
            and c["draws_equal"]):
        fail.append(f"ngp: past step 1 against one process: {c}")

    # the NGP run's curve and its validation, beside the controls' curves
    def parted(lm, l1):
        k = MESH_FIRST_LOSSES
        return (float(np.max(np.abs(lm[:k] - l1[:k]) / np.abs(l1[:k]))),
                float(abs(lm[-MESH_LAST_LOSSES:].mean() / l1[-MESH_LAST_LOSSES:].mean() - 1)))

    def windows(lm, l1):
        rel = np.abs(lm / l1 - 1)
        return [float(rel[k:k + MESH_WINDOW].mean()) for k in range(0, len(rel), MESH_WINDOW)]

    l1 = arrays["ngp_losses"]
    first_rel, last_rel = parted(a0["ngp_losses"], l1)
    ctrl = [parted(lc, l1) for lc in arrays["control_losses"]]
    ctrl_first, ctrl_last = [f for f, _ in ctrl], [l for _, l in ctrl]
    win = windows(a0["ngp_losses"], l1)
    win_ctrl = [windows(lc, l1) for lc in arrays["control_losses"]]
    envelope = np.max(win_ctrl, axis=0)
    above = [k * MESH_WINDOW for k, (x, e) in enumerate(zip(win, envelope)) if x > e]
    val_gap = abs(r0["ngp"]["val_psnr_db"] - single["ngp"]["val_psnr_db"])
    c.update(first_losses_max_rel=first_rel, last_mean_rel=last_rel,
             controls_first_losses_max_rel=ctrl_first, controls_last_mean_rel=ctrl_last,
             window_mean_rel=win, controls_window_mean_rel_max=envelope.tolist(),
             windows_above_controls=above,
             val_psnr_db=[r0["ngp"]["val_psnr_db"], single["ngp"]["val_psnr_db"]],
             refreshes=r0["ngp"]["refreshes"])
    first_ok = first_rel <= max(MESH_LOSS_RTOL, max(ctrl_first))
    last_ok = last_rel <= max(MESH_LAST_RTOL, max(ctrl_last))
    if not first_ok or (not quick and (not last_ok or val_gap > MESH_VAL_DB)):
        fail.append(f"ngp: two ranks against one process: first {first_rel} (controls "
                    f"{ctrl_first}), last {last_rel} (controls {ctrl_last}), val "
                    f"{val_gap} dB")
    serve_equal = r0["serve"]["sha256"] == single["serve"]["sha256"] == r1["serve"]["sha256"]
    cmp["serve"] = {"frames": MESH_FRAMES, "bit_equal": serve_equal,
                    "ms_two_ranks": [r0["serve"]["ms"], r1["serve"]["ms"]],
                    "ms_one_process": single["serve"]["ms"]}
    if not serve_equal:
        fail.append("serve: the frame batch over two ranks differs from one process's")

    # ---- (c) torchrun --nproc_per_node 2 ... run_nerf --mesh ------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    steps = 64 if quick else MESH_TORCHRUN_STEPS
    with tempfile.TemporaryDirectory() as root:
        logdir = os.path.join(root, "logs")
        yml = copy_config("machina_ngp.yml", root, logdir=logdir, basedir=basedir,
                          randomseed=TRAIN_SEED, train_iters=steps, save_every=steps,
                          print_every=steps // 2, validate_every=steps)
        launcher = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                    "--nproc_per_node", "2", "--master_addr", "127.0.0.1"]
        cli = ["-m", "nerf_kinematics_tpu_torch.cli.run_nerf", "--config", yml, "--mesh"]
        trained = run_ranks([launcher + ["--master_port", str(free_port())] + cli],
                            MESH_RANK_TIMEOUT, env=env)[0]
        video = run_ranks([launcher + ["--master_port", str(free_port())] + cli
                           + ["--render-video", "--fast", "--load-checkpoint",
                              str(steps)]], MESH_RANK_TIMEOUT, env=env)[0]
        rundir = os.path.join(logdir, "machina-ngp")
        with open(os.path.join(rundir, "metrics.jsonl")) as f:
            recs = [json.loads(l) for l in f]
        keys = [(r["tag"], r["step"]) for r in recs]
        frames = sorted(n for n in os.listdir(os.path.join(rundir, "video"))
                        if n.startswith("frame_"))
        ckpts = sorted(os.listdir(os.path.join(rundir, "checkpoints")))
        # one process's render of the same checkpoint, as the video writes it
        from nerf_kinematics_tpu_torch.cli.run_nerf import load_state
        from nerf_kinematics_tpu_torch.rendering.fast_render import FastRenderSettings
        from nerf_kinematics_tpu_torch.train.config import load_config
        from nerf_kinematics_tpu_torch.train.loop import eval_params
        from nerf_kinematics_tpu_torch.train.trainer import Trainer

        tr = Trainer(load_config(yml), device=dev)
        st = load_state(tr, str(steps))
        val = tr.cfg.nerf.validation
        ds = tr.dataset
        render = tr.engine.make_fast_render_fn(
            ds.intrinsics, ds.near, ds.far, ds.use_ndc, settings=FastRenderSettings(
                num_coarse=val.num_coarse, num_fine=64, fg_fraction=0.35,
                white_background=val.white_background))
        mismatched = 0
        with torch.no_grad(), tr.engine.bound(eval_params(st)):
            for i, p in enumerate(ds.render_poses):
                rgb = render(torch.as_tensor(p, dtype=torch.float32, device=dev),
                             st.aux)["rgb"].float().cpu().numpy()
                u8 = np.clip(rgb * 255, 0, 255).astype(np.uint8)
                mismatched += not np.array_equal(
                    u8, read_png(os.path.join(rundir, "video", f"frame_{i:04d}.png")))
        tr.close()
        n_frames = len(ds.render_poses)
    seconds["torchrun"] = time.perf_counter() - t0
    report["torchrun"] = {
        "steps": steps, "frames": len(frames), "render_poses": n_frames,
        "checkpoints": ckpts, "metrics_records": len(recs),
        "records_written_once": len(keys) == len(set(keys)),
        "frames_unequal_to_one_process": mismatched,
        "train_printed": trained[0].strip().splitlines()[-2:],
        "video_printed": video[0].strip().splitlines()[-1:]}
    if not (len(keys) == len(set(keys)) and recs and ckpts == [f"ckpt_{steps:08d}.pt"]):
        fail.append(f"torchrun: logs {report['torchrun']}")
    if mismatched or len(frames) != n_frames:
        fail.append(f"torchrun: {mismatched} of {n_frames} frames differ from one "
                    f"process's ({len(frames)} written)")
    report["seconds"] = seconds
    report["launches"] = dict(total)
    report["launches_by_row"] = by_row(total, all_points)
    emit(report)
    if fail:
        raise AssertionError(f"mesh: {fail}")
    return total, all_points


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
    # one rank of the mesh phase's two, started by the phase itself
    ap.add_argument("--mesh-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--mesh-out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh_rank is not None:
        return mesh_rank_main(args)
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
    # The plain versions and the cuBLAS yardsticks are full f32: no TF32 in
    # matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    points = collections.Counter()  # by (kernel, body)

    def add(phase_counts):
        launched, taken = phase_counts
        for k in counts:
            counts[k] += launched[k]
        points.update(taken)

    engine = aux = dataset = None
    if {"serve", "golden", "train", "train_autodiff", "classic"} & set(phases):
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
    if "classic" in phases:
        add(phase_classic(fx, dev, args.quick, engine, aux, args.profile))
    if "halo" in phases:
        add(phase_halo(dev, args.quick))
    with tempfile.TemporaryDirectory() as work:
        # the robot phase's ring capture and its trained field, which the
        # poses phase takes where the robot phase ran
        ring = {}
        if "robot" in phases:
            os.makedirs(os.path.join(work, "robot"))
            add(phase_robot(dev, args.quick, root=os.path.join(work, "robot"), keep=ring))
        if "poses" in phases:
            add(phase_poses(dev, args.quick, ring))
        ring.clear()
        # machina400, generated in the scene phase (or here, for a subset
        # without it) and used by the cli and bench phases
        scene_dir = os.path.join(work, "machina400")
        if "scene" in phases:
            add(phase_scene(fx, dev, args.quick, args.profile, scene_dir))
        elif {"cli", "bench", "mesh"} & set(phases):
            from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset

            write_machina_dataset(scene_dir, **(SCENE_QUICK if args.quick else SCENE))
        if "cli" in phases:
            add(phase_cli(dev, args.quick, scene_dir))
        if "bench" in phases:
            add(phase_bench(dev, scene_dir))
        if "proposals" in phases:
            if dataset is None:
                engine, aux = fixture_engine(fx, dev)
                with torch.no_grad():
                    dataset = build_dataset(fx, engine, aux, dev, args.quick)
            add(phase_proposals(fx, dev, args.quick, dataset))
        dataset = engine = aux = None
        if "mesh" in phases:
            add(phase_mesh(fx, dev, args.quick, scene_dir))
    if phases != PHASES:
        emit({"phase": "total", "seconds": time.perf_counter() - t_start,
              "partial": list(phases)})
        return 3

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "main_path_points", "bound_ns_per_point", "main_path_by_body",
            "main_path_ms", "main_path_gap_ms", "ms_at_other_sizes", "nonfinite")
    for r in rows:
        r["launches"] = counts[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']}: not launched on the main path")
        main_path_time(r, points)
    row5 = next(r for r in rows if r["name"] == "cp_encode_bwd")
    row5["in_fused_bwd"] = fused_dlines_time(row5, points)
    keys += ("in_fused_bwd",)
    emit({"kernels": [{k: r.get(k) for k in keys} for r in rows]})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
