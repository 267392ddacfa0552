#!/usr/bin/env python3
"""How ``configs/fox_ngp.yml`` trains on the halo scene (the stand-in for
fox49 that ``chip_smoke.py``'s ``halo`` phase uses), by route and encoder:
the shipped fused module route (rows 3 and 6), the same route with rows 3
and 6 through their plain versions on the card (``plain``), the unfused
module (the CP encoder's rows 4 and 5 under autograd), f32 operands, the
hash fold, the hash encoder, and an all-black prediction for scale; and by
seed.

    python3 scripts/torch_halo_probe.py                       # the GPU
    python3 scripts/torch_halo_probe.py --steps 300 --variants shipped,unfused
    python3 scripts/torch_halo_probe.py --variants shipped --seeds 0,1,2,3,7,42
    python3 scripts/torch_halo_probe.py --variants shipped,plain --lockstep 40

``--lockstep K`` first takes the shipped route's first K steps from one
fresh state through the kernels, through their plain versions and through
the kernels with the density cotangent dropped (a stand-in for a fault in
row 6's density branch), with the same draws, as ``chip_smoke.py`` does:
how far the losses of a right and of a faulty route move from the plain
versions'.

For each variant and seed (default: the YAML's, 42): ``Trainer.fit`` from
a fresh state for ``--steps`` steps (occupancy refreshes as the trainer
makes them), the mean train loss
of every ``--every`` steps, ms a step, val PSNR (view 0, and the mean of
both held-out views) and the PSNR of two training views rendered the same
way, and the share of a 64^3 density grid over the scene box above 2.5.
A variant whose kernels refuse the configuration is reported with the
error. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from nerf_kinematics_tpu_torch.metrics.psnr import psnr  # noqa: E402
from nerf_kinematics_tpu_torch.train.config import load_config  # noqa: E402
from nerf_kinematics_tpu_torch.train.loop import eval_params  # noqa: E402
from nerf_kinematics_tpu_torch.train.trainer import Trainer  # noqa: E402
from chip_smoke import plain_fused_rows  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def variant(cfg, name: str):
    ngp = cfg.ngp
    if name in ("shipped", "plain"):
        return cfg
    if name == "unfused":
        return cfg.replace(ngp=dataclasses.replace(ngp, fused="off"))
    if name == "f32":
        return cfg.replace(ngp=dataclasses.replace(
            ngp, compute_dtype="float32", cp=dataclasses.replace(ngp.cp, use_bf16=False)))
    if name == "hash_fold":
        return cfg.replace(ngp=dataclasses.replace(
            ngp, cp=dataclasses.replace(ngp.cp, fold="hash")))
    if name == "hash":
        return cfg.replace(ngp=dataclasses.replace(ngp, encoder="hash"))
    raise ValueError(f"unknown variant {name!r}")


@contextlib.contextmanager
def no_density_gradient():
    """Row 6 with the density row of its cotangent zeroed."""
    from nerf_kinematics_tpu_torch.ops import ngp_fused_cuda as nf

    bwd = nf.ngp_fused_apply_cf_bwd

    def dropped(params, xt, vdt, g, cfg):
        g = g.clone()
        g[3] = 0.0
        return bwd(params, xt, vdt, g, cfg)

    nf.ngp_fused_apply_cf_bwd = dropped
    try:
        yield
    finally:
        nf.ngp_fused_apply_cf_bwd = bwd


def lockstep(cfg, ds, dev, steps: int) -> dict:
    from chip_smoke import halo_lockstep

    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(experiment=dataclasses.replace(
            cfg.experiment, logdir=tmp, print_every=0, validate_every=0, save_every=0))
        trainer = Trainer(cfg, ds, device=dev)
        rep, _ = halo_lockstep(trainer, trainer.engine.init_state(), steps,
                               {"kernels, no density gradient": no_density_gradient})
        trainer.close()
    return rep


def run(cfg, ds, dev, steps: int, every: int, seed: int) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.replace(experiment=dataclasses.replace(
            cfg.experiment, logdir=tmp, print_every=0, validate_every=0, save_every=0,
            train_iters=steps, randomseed=seed))
        trainer = Trainer(cfg, ds, device=dev)
        res = trainer.fit(state=trainer.engine.init_state())
        torch.cuda.synchronize()
        losses = np.asarray(res.losses)
        st = res.state
        views = {}
        for i in (0, 20, int(ds.val_idx[0]), int(ds.val_idx[1])):
            pred = trainer._render_view(st, i)["rgb"].cpu().numpy()
            views[f"{'val' if i in ds.val_idx else 'train'} {i}"] = psnr(pred, ds.images[i])
        with trainer.engine.bound(eval_params(st)):
            grid = trainer.engine.density_grid(resolution=64)
        out = {
            "ms_per_step": statistics.median(s / k * 1e3 for k, s in res.chunk_seconds),
            "loss_by_window": [float(losses[i:i + every].mean())
                               for i in range(0, len(losses), every)],
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "psnr_by_view": views,
            "val_mean_psnr_db": float(np.mean([v for k, v in views.items()
                                               if k.startswith("val")])),
            "density_grid_share_above_2.5": float((grid > 2.5).float().mean()),
        }
        trainer.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--views", type=int, default=49)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--variants", default="shipped,unfused,f32,hash_fold,hash")
    ap.add_argument("--seeds", default="42")
    ap.add_argument("--lockstep", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    from nerf_kinematics_tpu_torch.bench import nvidia_smi_line

    cfg = load_config(os.path.join(ROOT, "configs", "fox_ngp.yml"))
    ds = make_synthetic_scene(variant="halo", n_views=args.views, resolution=args.size,
                              device=dev)
    report = {"device": nvidia_smi_line(), "steps": args.steps,
              "all_black_loss": float((ds.images[ds.train_idx] ** 2).mean())}
    print(json.dumps(report), file=sys.stderr, flush=True)
    if args.lockstep:
        report["lockstep"] = lockstep(cfg, ds, dev, args.lockstep)
        print(json.dumps({"lockstep": report["lockstep"]}), file=sys.stderr, flush=True)
    for name in args.variants.split(","):
        for seed in map(int, args.seeds.split(",")):
            key = name if args.seeds == "42" else f"{name} seed {seed}"
            t0 = time.perf_counter()
            try:
                with plain_fused_rows() if name == "plain" else contextlib.nullcontext():
                    report[key] = run(variant(cfg, name), ds, dev, args.steps, args.every, seed)
            except ValueError as e:  # a kernel's launcher refused the shape
                report[key] = {"refused": str(e)}
            report[key]["seconds"] = time.perf_counter() - t0
            print(json.dumps({key: report[key]}), file=sys.stderr, flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
