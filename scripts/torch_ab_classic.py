#!/usr/bin/env python3
"""A/B of two trees of the port on one card, in one call: rows 9 and 10 (the
classic engine's fused kernels, f32), the classic train step, rows 4 and 5
(the CP encoder's forward at the occupancy sweep's 96^3 points and its
line-table gradient at the flagship step's 393 216 points; bf16, and in
turns f32 too), row 1 (the hull lookup at 2.56 M points and at the two-call
step's 524 288), rows 2 and 3 (the fused forwards at a 400^2 frame's
10.24 M and 20.48 M points), rows 6 and 7 (the fused gradients at the step's
393 216 points; rows 2, 3, 6 and 7 in f32 mode too, the FMA bodies),
row 8 (the fast engine's whole-step kernel), the
``fused_train: full`` train step and the two-call train step (rows 7 and 2).

    git archive <rev> nerf_kinematics_tpu_torch | tar -x -C build/ab_parent
    python3 scripts/torch_ab_classic.py --parent build/ab_parent

The change is this checkout's ``nerf_kinematics_tpu_torch``; the parent is
the one under ``--parent`` (a directory that ``.gitignore`` lists). Each
run is a process of its own that imports one tree and builds its kernels
into a build directory of its own; the runs go in the order ``--order``
(parent, change, change, parent by default), so that drift of the card
over the call shows. Prints the card's ``nvidia-smi`` line, one JSON object
per run and a summary with each tree's medians. The summary also holds
rows 1-10 timed in one process, the parent's rows and this tree's (each
tree's package imported on its own, with its own kernel library) in turns
for ``--turns`` rounds (20 by default; free of the spread between
processes). Kernel times are CUDA-event medians with the L2 cache overwritten
between launches; step times are the host clock over steps that end in a
synchronise, and the device ms a step comes from ``torch.profiler`` over
other steps of the same state.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSIC_N = 1024 * 128   # row 9 / 10 at the classic step's fine pass
STEPS = 40               # timed steps a route, after WARM
WARM = 5
PROFILED = 10


def _worker(tree: str, build: str) -> dict:
    """Measure the tree whose package lies under ``tree``."""
    os.environ["NKT_TORCH_BUILD_DIR"] = build
    sys.path.insert(0, tree)
    sys.path.append(ROOT)  # chip_smoke's shapes and config (no package import)
    import torch

    import chip_smoke as cs
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    pkg = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(cuda_lib.__file__))))
    if os.path.abspath(pkg) != os.path.abspath(tree):
        raise RuntimeError(f"imported {pkg}, expected the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_lib.load_library()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    out = {"tree": tree, "build_seconds": cuda_lib.BUILD_INFO["seconds"]}

    _kernels(out, cs, dev, flush)
    del flush
    _classic(out, cs, dev)
    _fast(out, cs, dev)
    return out


def _dataset(dev, size, views, rng):
    import numpy as np
    import torch

    from nerf_kinematics_tpu_torch.data.machina import machina_intrinsics, orbit_poses
    from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays

    poses = np.concatenate([orbit_poses(views // 2, elev_deg=e) for e in (15.0, 40.0)]
                           + [orbit_poses(4, elev_deg=25.0)[:2]])
    images = torch.tensor(rng.uniform(size=(len(poses), size, size, 3)).astype(np.float32),
                          device=dev)
    return dataset_from_arrays(images, poses, machina_intrinsics(size), 2.0, 6.0, n_val=2)


QUIET = dict(print_every=0, validate_every=0, save_every=0)


def _kernel_rows(cs, dev) -> dict:
    """Each kernel row's call on seeded inputs at its A/B shape: rows 9 and
    10 at the classic step's fine pass (f32); rows 4 and 5 at the occupancy
    sweep's 96^3 and the flagship step's 393 216 points, rows 6-8 at the
    step's shapes, row 1 at 2.56 M points and at the two-call step's 524 288,
    rows 3 and 2 at a 400^2 frame's 20.48 M and 10.24 M points (bf16); rows
    2, 3, 6 and 7 in f32 mode too (rows 2 and 3 at 10.24 M points)."""
    import dataclasses

    import torch

    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.io.fixture import read_fixture
    from nerf_kinematics_tpu_torch.ops import classic_fused_cuda as cfc
    from nerf_kinematics_tpu_torch.ops.cp_grid_cuda import cp_encode_cuda, cp_encode_cuda_bwd
    from nerf_kinematics_tpu_torch.ops.ngp_fused_cuda import (
        ngp_fused_apply_cf, ngp_fused_apply_cf_bwd, ngp_fused_sigma_cf,
        ngp_fused_train_cf, ngp_fused_train_full_cf)
    from nerf_kinematics_tpu_torch.ops.occupancy import pair_projections
    from nerf_kinematics_tpu_torch.ops.occupancy_cuda import occupancy_at_hull_cuda
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    eng = cs.classic_engines(dev, modes=("f32",))["f32"]
    mcfg = eng.cfg.model_coarse
    prm = {k: [t.detach() for t in v]
           for k, v in eng._fused_params(eng.model_coarse).items()}
    gen = torch.Generator(device=dev).manual_seed(99)
    xt, vd = cs.classic_points(CLASSIC_N, gen, dev)
    g4 = torch.randn((4, CLASSIC_N), generator=gen, device=dev)

    fx = read_fixture()
    ngp, t = fx.config.ngp, fx.config.nerf.train
    R = fx.config.nerf.num_random_rays
    S, Sc, NB = t.num_fine, t.num_coarse, ngp.occ_bins
    near, far = fx.config.dataset.near, fx.config.dataset.far
    proj2 = pair_projections(grid_from_numpy(fx.grid_density, fx.grid_bound,
                                             device=dev)).contiguous()
    e = NGPEngine(fx.config, 1.0, device=dev)
    e.load_flax_params(fx.params)
    p8, c8 = e._fused_params(detach=True), e.ngp_config.cp
    c32 = dataclasses.replace(c8, use_bf16=False)  # the f32 instances and bodies
    gen = torch.Generator(device=dev).manual_seed(4321)
    x4 = cs.random_points(ngp.occ_resolution ** 3, gen, dev)[0].T.contiguous()
    x5 = cs.random_points(R * S, gen, dev)[0].T.contiguous()
    g5 = torch.randn((R * S, c8.out_dim), generator=gen, device=dev)
    rays = cs.full_step_inputs(R, S, Sc, torch.Generator(device=dev).manual_seed(8888), dev)
    x1 = cs.random_points(200 * 200 * 64, gen, dev)[0]
    x1s = x1[:, : R * 64].contiguous()
    xf, vf = cs.random_points(160000 * 128, gen, dev)
    xf2 = xf[:, : 160000 * 64].contiguous()
    vf2 = vf[:, : 160000 * 64].contiguous()
    x6, v6 = cs.random_points(R * S, gen, dev)
    g6 = torch.randn((4, R * S), generator=gen, device=dev)
    g6[3] *= 1e-3
    z = 2.0 + 4.0 * torch.sort(torch.rand((R, S), generator=gen, device=dev), -1).values
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10, device=dev)], -1)
    dists = dists.reshape(1, R * S).contiguous()
    tgt = torch.rand((3, R), generator=gen, device=dev)
    inv = 1.0 / (3.0 * R)
    return {
        "row9_ms": lambda: cfc.classic_fused_apply_cf(prm, xt, vd, mcfg),
        "row10_ms": lambda: cfc.classic_fused_apply_cf_bwd(prm, xt, vd, g4, mcfg),
        "row4_ms": lambda: cp_encode_cuda(p8["lines"], x4, c8),
        "row5_ms": lambda: cp_encode_cuda_bwd(p8["lines"], x5, g5, c8),
        "row4_f32_ms": lambda: cp_encode_cuda(p8["lines"], x4, c32),
        "row5_f32_ms": lambda: cp_encode_cuda_bwd(p8["lines"], x5, g5, c32),
        "row8_ms": lambda: ngp_fused_train_full_cf(
            p8, *rays, proj2, c8, S, Sc, NB, True, inv, near, far, 1.0, ngp.occ_floor),
        "row1_ms": lambda: occupancy_at_hull_cuda(proj2, x1),
        "row1_step_ms": lambda: occupancy_at_hull_cuda(proj2, x1s),
        "row3_ms": lambda: ngp_fused_apply_cf(p8, xf, vf, c8),
        "row2_ms": lambda: ngp_fused_sigma_cf(p8, xf2, c8),
        "row6_ms": lambda: ngp_fused_apply_cf_bwd(p8, x6, v6, g6, c8),
        "row7_ms": lambda: ngp_fused_train_cf(p8, x6, v6, dists, tgt, c8, S, True, inv),
        # f32 mode: the FMA bodies (W0 staged level by level), row 3 at 10.24 M
        "row2_f32_ms": lambda: ngp_fused_sigma_cf(p8, xf2, c32),
        "row3_f32_ms": lambda: ngp_fused_apply_cf(p8, xf2, vf2, c32),
        "row6_f32_ms": lambda: ngp_fused_apply_cf_bwd(p8, x6, v6, g6, c32),
        "row7_f32_ms": lambda: ngp_fused_train_cf(p8, x6, v6, dists, tgt, c32, S, True, inv),
        # not timed in turns: the plain version, and the parts by kernel
        "row10_plain": lambda: cfc.classic_fused_apply_cf_bwd_ref(prm, xt, vd, g4, mcfg),
    }


def _kernels(out, cs, dev, flush) -> None:
    import torch

    rows = _kernel_rows(cs, dev)
    with torch.no_grad():
        for key, fn in rows.items():
            if key.endswith("_ms"):
                out[key] = cs.time_ms(fn, 9, 2, flush)
        for key in ("row1_ms", "row1_step_ms"):
            out[key.replace("_ms", "_clean_ms")] = cs.time_ms(rows[key], 9, 2, flush,
                                                              clean=True)
        out["row10_plain_ms"] = cs.time_ms(rows["row10_plain"], 3, 1, flush)
        out["row10_parts_ms"] = cs.profile_parts(rows["row10_ms"], cs.ROW10_PARTS)


def _tree_rows(tree: str, build: str, cs, dev) -> dict:
    """The kernel rows of one tree: its package imported afresh from
    ``tree`` (its own wrappers, ctypes mirrors and kernel library, built
    into ``build``). The rows' closures keep that tree's modules."""
    pkg = "nerf_kinematics_tpu_torch"
    for name in [m for m in sys.modules if m == pkg or m.startswith(pkg + ".")]:
        del sys.modules[name]
    os.environ["NKT_TORCH_BUILD_DIR"] = build
    sys.path.insert(0, tree)
    try:
        from nerf_kinematics_tpu_torch.ops import cuda_lib

        cuda_lib.load_library()
        return {k: fn for k, fn in _kernel_rows(cs, dev).items() if k.endswith("_ms")}
    finally:
        sys.path.remove(tree)


def _interleaved(parent: str, rounds: int) -> dict:
    """Rows 1-10 in one process: the parent's and this tree's rows (each
    tree's own wrappers over its own kernel library) in turns (each round
    in the other order), ``rounds`` rounds of 7 timed launches a row."""
    sys.path.append(ROOT)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    trees = {"parent": _tree_rows(parent, os.path.join(ROOT, "build", "ab_turns_parent"),
                                  cs, dev),
             "change": _tree_rows(ROOT, os.path.join(ROOT, "build", "ab_turns_change"),
                                  cs, dev)}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    times = {k: {"parent": [], "change": []} for k in trees["change"]}
    with torch.no_grad():
        for i in range(rounds):
            for label in ("parent", "change")[:: 1 if i % 2 == 0 else -1]:
                for k, fn in trees[label].items():
                    times[k][label].append(cs.time_ms(fn, 7, 2, flush))
    def quartiles(xs):
        q = statistics.quantiles(xs, n=4)
        return [q[0], q[2]]

    return {k: {"parent": statistics.median(v["parent"]),
                "change": statistics.median(v["change"]),
                "change_over_parent": statistics.median(v["change"])
                / statistics.median(v["parent"]),
                "parent_quartiles": quartiles(v["parent"]),
                "change_quartiles": quartiles(v["change"])}
            for k, v in times.items()}


def _fast(out, cs, dev) -> None:
    import dataclasses
    import tempfile

    import numpy as np

    # ---- the full and the two-call step (machina_ngp) -------------------
    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.io.fixture import read_fixture
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    fx = read_fixture()
    data = _dataset(dev, 400, 40, np.random.default_rng(5))
    for key, route, groups in (("full_step", "full", cs.ROW8_PARTS),
                               ("two_call_step", "auto", None)):
        with tempfile.TemporaryDirectory() as logdir:
            c = fx.config
            cfg = c.replace(
                ngp=dataclasses.replace(c.ngp, fused_train=route),
                experiment=dataclasses.replace(c.experiment, logdir=logdir,
                                               id=f"ab_{route}", **QUIET))
            trainer = Trainer(cfg, data)
            trainer.engine.load_flax_params(fx.params)
            state = trainer.engine.init_state(keep_weights=True)
            state.aux = grid_from_numpy(fx.grid_density, fx.grid_bound, device=dev)
            out[key] = _time_steps(trainer, state, cs, groups)
            trainer.close()


def _classic(out, cs, dev) -> None:
    import dataclasses
    import tempfile

    import numpy as np

    # ---- the classic train step (machina_classic, 1024 rays x 64 + 64) ---
    from nerf_kinematics_tpu_torch.train.config import config_from_dict
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as logdir:
        base = config_from_dict(cs.CLASSIC_CONFIG)
        cfg = base.replace(experiment=dataclasses.replace(
            base.experiment, logdir=logdir, id="ab_classic", **QUIET))
        trainer = Trainer(cfg, _dataset(dev, 200, 40, np.random.default_rng(5)))
        out["classic_step"] = _time_steps(trainer, trainer.init_or_resume(), cs,
                                          cs.CLASSIC_PARTS)
        trainer.close()


def _time_steps(trainer, state, cs, groups) -> dict:
    """ms a step on the host clock over STEPS steps (after WARM), and the
    profile of PROFILED more (chip_smoke.profile_steps: device ms a step by
    kernel group, idle share against these same steps unprofiled)."""
    import torch

    step = trainer._train_step
    args = (trainer.images, trainer.poses, trainer.ray_buf)
    for _ in range(WARM):
        state, _ = step(state, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, _ = step(state, *args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / STEPS
    prof = cs.profile_steps(trainer, state, n_steps=PROFILED, groups=groups)
    return {"ms_per_step": ms, "device_ms_per_step": prof["device_busy_ms"] / PROFILED,
            "device_idle_share": prof["device_idle_share"],
            "ms_per_step_by_group": prof["ms_per_step_by_group"],
            "nonfinite_kernels": prof["nonfinite_kernels"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="directory holding the parent's nerf_kinematics_tpu_torch")
    ap.add_argument("--order", default="parent,change,change,parent",
                    help="the runs in processes of their own ('': none)")
    ap.add_argument("--turns", type=int, default=20,
                    help="rounds of rows 1-10 in one process, the two trees' kernels "
                         "in turns (0: none)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--worker-turns", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(_worker(args.worker, args.build)), flush=True)
        return 0
    if args.worker_turns:
        print(json.dumps(_interleaved(os.path.abspath(args.worker_turns), args.turns)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_classic: no CUDA device available", file=sys.stderr)
        return 2
    if not args.parent or not os.path.isdir(
            os.path.join(args.parent, "nerf_kinematics_tpu_torch")):
        print("torch_ab_classic: --parent must hold nerf_kinematics_tpu_torch",
              file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    runs = []
    for label in filter(None, args.order.split(",")):
        tree = trees[label]
        build = os.path.join(ROOT, "build", f"ab_{label}")
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                               "--build", build], stdout=subprocess.PIPE, text=True)
        if done.returncode != 0:
            print(f"torch_ab_classic: the {label} run failed", file=sys.stderr)
            return 1
        rec = {"run": label, **json.loads(done.stdout.strip().splitlines()[-1])}
        runs.append(rec)
        print(json.dumps(rec), flush=True)

    def med(label, get):
        return statistics.median(get(r) for r in runs if r["run"] == label)

    keys = {"row9_ms": lambda r: r["row9_ms"], "row10_ms": lambda r: r["row10_ms"],
            "row10_plain_ms": lambda r: r["row10_plain_ms"],
            "classic_step_ms": lambda r: r["classic_step"]["ms_per_step"],
            "classic_step_device_ms": lambda r: r["classic_step"]["device_ms_per_step"],
            "row4_ms": lambda r: r["row4_ms"], "row5_ms": lambda r: r["row5_ms"],
            "row8_ms": lambda r: r["row8_ms"],
            **{k: (lambda r, k=k: r[k]) for k in (
                "row1_ms", "row1_clean_ms", "row1_step_ms", "row1_step_clean_ms",
                "row2_ms", "row3_ms", "row6_ms", "row7_ms")},
            "full_step_ms": lambda r: r["full_step"]["ms_per_step"],
            "full_step_device_ms": lambda r: r["full_step"]["device_ms_per_step"],
            "two_call_step_ms": lambda r: r["two_call_step"]["ms_per_step"],
            "two_call_step_device_ms": lambda r: r["two_call_step"]["device_ms_per_step"]}
    summary = {label: {k: med(label, f) for k, f in keys.items()} for label in trees
               if any(r["run"] == label for r in runs)}
    result = {"nvidia_smi": smi, "medians": summary}
    if args.turns:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker-turns",
                               trees["parent"], "--turns", str(args.turns)],
                              stdout=subprocess.PIPE, text=True)
        if done.returncode != 0:
            print("torch_ab_classic: the run in turns failed", file=sys.stderr)
            return 1
        result["in_turns"] = json.loads(done.stdout.strip().splitlines()[-1])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
