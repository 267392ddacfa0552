#!/usr/bin/env python3
"""The canonical fast-engine run through the PyTorch port, from the images on
disk: generate machina400 with the port's scene generator, then
``Trainer(cfg)`` on ``configs/machina_ngp.yml`` (the fixture's copy of it:
the card has no PyYAML) from the JAX package's seed-42 initial weights, with
validation every 1000 steps (it falls on the multiples of 1024, as in the
canonical run's ``logs/machina-ngp/metrics.jsonl``) and the mean over the 8
held-out views at the end. Prints one JSON object per validation and a
summary beside the canonical figures.

    python3 scripts/torch_machina_run.py --out cache/machina_run  # the card
    python3 scripts/torch_machina_run.py --fused-train on               # the two-call route
    python3 scripts/torch_machina_run.py --device cpu --resolution 32 --views 4 \\
        --val 2 --test 1 --samples 64 --steps 64 --rays 512              # a CPU rehearsal

``--out`` keeps the dataset (``<out>/machina400``, reused when its marker
matches) and the run directory (``<out>/machina-ngp``: ``metrics.jsonl``,
the last checkpoint).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset  # noqa: E402
from nerf_kinematics_tpu_torch.io.convert import params_from_npz  # noqa: E402
from nerf_kinematics_tpu_torch.io.fixture import (  # noqa: E402
    MACHINA_NGP_INIT42, read_fixture)
from nerf_kinematics_tpu_torch.train.trainer import Trainer  # noqa: E402

# logs/machina-ngp/metrics.jsonl (the JAX package's canonical run)
CANONICAL = {"val_psnr_db": {1024: 31.36460424471172, 2048: 33.59586248188184,
                             10000: 38.10945153928263},
             "val_mean_psnr_db_10000": 36.70229395907228}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="cache/machina_run")
    ap.add_argument("--steps", type=int, default=None, help="default: the config's 10000")
    ap.add_argument("--fused-train", default="full", choices=["full", "on", "auto", "off"])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--resolution", type=int, default=400)
    ap.add_argument("--views", type=int, default=100)
    ap.add_argument("--val", type=int, default=8)
    ap.add_argument("--test", type=int, default=16)
    ap.add_argument("--samples", type=int, default=1024)
    ap.add_argument("--rays", type=int, default=None, help="default: the config's 8192")
    args = ap.parse_args(argv)

    fx = read_fixture()
    cfg = fx.config
    basedir = os.path.join(args.out, "machina400")
    t0 = time.perf_counter()
    write_machina_dataset(basedir, resolution=args.resolution, n_train=args.views,
                          n_val=args.val, n_test=args.test, seed=7,
                          n_samples=args.samples, device=args.device)
    gen_s = time.perf_counter() - t0
    exp = dataclasses.replace(cfg.experiment, logdir=args.out, id="machina-ngp",
                              train_iters=args.steps or cfg.experiment.train_iters,
                              save_every=0)
    nerf = cfg.nerf if args.rays is None else dataclasses.replace(
        cfg.nerf, num_random_rays=args.rays)
    cfg = cfg.replace(dataset=dataclasses.replace(cfg.dataset, basedir=basedir),
                      experiment=exp, nerf=nerf,
                      ngp=dataclasses.replace(cfg.ngp, fused_train=args.fused_train))
    metrics_path = os.path.join(args.out, exp.id, "metrics.jsonl")
    if os.path.exists(metrics_path):
        os.remove(metrics_path)  # a fresh run: the writer appends
    trainer = Trainer(cfg, device=args.device)
    eng = trainer.engine
    eng.load_flax_params(params_from_npz(MACHINA_NGP_INIT42))
    state = eng.init_state(keep_weights=True)  # the step's generator: seed 42
    t0 = time.perf_counter()
    res = trainer.fit(state=state)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    split = trainer.evaluate_split(res.state, "val")
    trainer.save_checkpoint(res.state, int(res.state.step), res.last_metrics, res.val_psnr)
    trainer.close()
    with open(metrics_path) as f:
        recs = [json.loads(line) for line in f]
    val = {r["step"]: r["value"] for r in recs if r["tag"] == "val/psnr"}
    for step, db in sorted(val.items()):
        print(json.dumps({"step": step, "val_psnr_db": db,
                          "canonical_val_psnr_db": CANONICAL["val_psnr_db"].get(step)}))
    device = {"name": torch.cuda.get_device_name(0)} if eng.device.type == "cuda" else {
        "name": "cpu"}
    if eng.device.type == "cuda":
        device["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            stdout=subprocess.PIPE, text=True, timeout=60).stdout.strip()
    ms = [s / k * 1e3 for k, s in res.chunk_seconds]
    print(json.dumps({
        "summary": True, "device": device, "fused_train": args.fused_train,
        "steps": int(res.state.step), "rays_per_step": cfg.nerf.num_random_rays,
        "scene": {"resolution": args.resolution, "views": [args.views, args.val, args.test],
                  "samples": args.samples},
        "generate_seconds": gen_s, "fit_seconds": fit_s,
        "ms_per_step_median": float(np.median(ms)),
        "loss_last64": float(np.mean(res.losses[-64:])),
        "val_psnr_db_by_step": val, "val_psnr_per_view_db": split["per_frame"],
        "val_mean_psnr_db": split["mean_psnr"], "canonical": CANONICAL,
    }), flush=True)


if __name__ == "__main__":
    main()
