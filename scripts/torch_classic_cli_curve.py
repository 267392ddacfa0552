#!/usr/bin/env python3
"""The classic engine's early curve through the port's command line, on
machina400 from disk at half resolution, as ``chip_smoke.py``'s ``cli``
phase runs it: ``run_nerf --config configs/machina_classic.yml`` (a copy with
its ``logdir``, ``basedir``, seed and validation cadence replaced) for each
seed, the validation PSNR of val view 0 every ``--every`` steps from the
run's ``metrics.jsonl``; then the same copy of the first seed through the
Python API (``Trainer(load_config(...)).fit``) to the first validation,
whose PSNR must equal the command line's at that step. Prints one JSON
object per run and the all-white image's PSNR on that view (the plateau a
run that has not started to fit sits on).

``--fused off`` sets both networks' ``fused`` mode in the copy, so the
point pipeline runs through the module in place of the fused kernel.
``--draw_seeds`` adds, for each, a run through the Python API from the
first seed's weights with the step's generator seeded anew: the same
start, other pixels, depth jitter and density noise.

    python3 scripts/torch_classic_cli_curve.py                 # the card
    python3 scripts/torch_classic_cli_curve.py --seeds 42 --fused off --draw_seeds 1,2
    python3 scripts/torch_classic_cli_curve.py --device cpu --resolution 16 \\
        --samples 32 --steps 4 --every 2 --rays 64              # a CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (SCENE, copy_config)
from nerf_kinematics_tpu_torch.cli import run_nerf  # noqa: E402
from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset  # noqa: E402
from nerf_kinematics_tpu_torch.metrics.psnr import psnr  # noqa: E402
from nerf_kinematics_tpu_torch.train.config import load_config  # noqa: E402
from nerf_kinematics_tpu_torch.train.trainer import Trainer  # noqa: E402


def val_curve(rundir: str) -> dict:
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {r["step"]: r["value"] for r in recs if r["tag"] == "val/psnr"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="42,7", help="the first is the YAML's")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--every", type=int, default=200)
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--resolution", type=int, default=chip_smoke.SCENE["resolution"])
    ap.add_argument("--samples", type=int, default=chip_smoke.SCENE["n_samples"])
    ap.add_argument("--rays", type=int, default=None, help="default: the YAML's 1024")
    ap.add_argument("--fused", choices=("auto", "on", "off"), default=None,
                    help="both networks' fused mode; default: the YAML's")
    ap.add_argument("--draw_seeds", default="",
                    help="API runs from the first seed's weights with these draws")
    args = ap.parse_args(argv)
    device = "cuda" if args.device is None else args.device
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for a rehearsal")
    seeds = [int(s) for s in args.seeds.split(",")]

    with tempfile.TemporaryDirectory() as root:
        scene = dict(chip_smoke.SCENE, resolution=args.resolution, n_samples=args.samples)
        basedir = os.path.join(root, "machina400")
        t0 = time.perf_counter()
        write_machina_dataset(basedir, device=device, **scene)
        print(json.dumps({"scene": scene, "seconds": time.perf_counter() - t0}), flush=True)

        def copy(tag, seed):
            d = os.path.join(root, tag)
            os.makedirs(d)
            lines = {"logdir": os.path.join(d, "logs"), "basedir": basedir,
                     "randomseed": seed, "validate_every": args.every,
                     "print_every": args.every}
            if args.rays is not None:
                lines["num_random_rays"] = args.rays
            path = chip_smoke.copy_config("machina_classic.yml", d,
                                          dataset_cache=os.path.join(root, "cache"),
                                          **lines)
            if args.fused is not None:
                with open(path) as f:
                    text = f.read()
                text, n = re.subn(r"^(    hidden_size:[^\n]*)$",
                                  rf"\1\n    fused: {args.fused}", text, flags=re.M)
                if n != 2:
                    raise AssertionError("machina_classic.yml: not two models")
                with open(path, "w") as f:
                    f.write(text)
            return path

        cli = {}
        for seed in seeds:
            yml = copy(f"cli{seed}", seed)
            t0 = time.perf_counter()
            out = run_nerf.main(["--config", yml, "--max-iters", str(args.steps),
                                 "--device", device])
            cfg = load_config(yml)
            curve = val_curve(os.path.join(cfg.experiment.logdir, cfg.experiment.id))
            cli[seed] = curve
            print(json.dumps({"route": "run_nerf", "seed": seed, "steps": args.steps,
                              "seconds": time.perf_counter() - t0,
                              "rays_per_sec": out["rays_per_sec"],
                              "val_psnr_db": curve}), flush=True)

        seed = seeds[0]
        cfg = load_config(copy(f"api{seed}", seed))
        trainer = Trainer(cfg, device=device)
        try:
            result = trainer.fit(max_iters=args.every)
            ds = trainer.dataset
            gt = ds.images[int(ds.val_idx[0])]
            white = psnr(np.ones_like(gt), gt)
        finally:
            trainer.close()
        equal = result.val_psnr == cli[seed][args.every]
        print(json.dumps({"route": "Trainer.fit", "seed": seed, "steps": args.every,
                          "val_psnr_db": result.val_psnr,
                          "run_nerf_val_psnr_db": cli[seed][args.every],
                          "equal": equal, "all_white_val_psnr_db": white}), flush=True)

        for draw in [int(s) for s in args.draw_seeds.split(",") if s]:
            cfg = load_config(copy(f"draw{draw}", seed))
            trainer = Trainer(cfg, device=device)
            try:
                state = trainer.engine.init_state()
                state.generator.manual_seed(draw)
                t0 = time.perf_counter()
                trainer.fit(max_iters=args.steps, state=state)
            finally:
                trainer.close()
            print(json.dumps({"route": "Trainer.fit", "seed": seed, "draw_seed": draw,
                              "steps": args.steps, "seconds": time.perf_counter() - t0,
                              "val_psnr_db": val_curve(trainer.rundir)}), flush=True)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
