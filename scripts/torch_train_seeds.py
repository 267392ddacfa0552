#!/usr/bin/env python3
"""How often does a fresh fast-engine model train, and how often does it fall
into the all-white state, on views rendered from the fixture's trained model?

    python3 scripts/torch_train_seeds.py                      # the GPU, full size
    python3 scripts/torch_train_seeds.py --device cpu --size 48 --rays 512 \\
        --views 6 --rings 2 --steps 48                        # 1/16 size on the CPU
    JAX_PLATFORMS=cpu python3 scripts/torch_train_seeds.py --reference ...   # the JAX trainer

Renders ``rings`` orbits of ``views`` training views each (or ``--hemisphere
N`` random upper-hemisphere views, as the reference scene's cameras) with the
port's evaluation renderer, then runs ``Trainer.fit`` from a fresh state for
every seed and prints the mean train loss of every ``--every`` steps and the
held-out PSNR. A run counts as stuck when the mean of its last two windows is above 0.9
of the loss of an all-white image. ``--reference`` runs the JAX package's
trainer (XLA route: ``encoder: cp``, ``fused: off``) on the same views
instead; it needs JAX and is meant for the CPU at a small size.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerf_kinematics_tpu_torch.data.machina import (  # noqa: E402
    RADIUS, _look_at_poses, machina_intrinsics, orbit_poses)
from nerf_kinematics_tpu_torch.data.types import dataset_from_arrays  # noqa: E402
from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy  # noqa: E402
from nerf_kinematics_tpu_torch.io.fixture import read_fixture  # noqa: E402
from nerf_kinematics_tpu_torch.train.config import config_to_json  # noqa: E402
from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine  # noqa: E402
from nerf_kinematics_tpu_torch.train.trainer import Trainer  # noqa: E402


def training_poses(args) -> np.ndarray:
    if args.hemisphere:
        rng = np.random.default_rng(0)
        elev = np.radians(rng.uniform(3.0, 62.0, args.hemisphere))
        azim = rng.uniform(0.0, 2 * np.pi, args.hemisphere)
        pos = RADIUS * np.stack([np.cos(elev) * np.cos(azim),
                                 np.cos(elev) * np.sin(azim), np.sin(elev)], 1)
        return _look_at_poses(pos, np.zeros(3)).astype(np.float32)
    elevs = [30.0, 10.0][: args.rings] if args.rings <= 2 else \
        np.linspace(5, 60, args.rings)
    return np.concatenate([orbit_poses(args.views, elev_deg=float(e)) for e in elevs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--rays", type=int, default=8192)
    ap.add_argument("--views", type=int, default=16, help="views per orbit")
    ap.add_argument("--rings", type=int, default=5)
    ap.add_argument("--hemisphere", type=int, default=0)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--every", type=int, default=0, help="default: steps / 4")
    ap.add_argument("--seeds", default="7,1,2,3,11,12,13,14")
    ap.add_argument("--reference", action="store_true")
    args = ap.parse_args(argv)
    every = args.every or max(args.steps // 4, 1)

    fx = read_fixture()
    engine = NGPEngine(fx.config, 1.0, device=args.device)
    engine.load_flax_params(fx.params)
    dev = engine.device
    aux = grid_from_numpy(fx.grid_density, fx.grid_bound, device=dev)
    intr = machina_intrinsics(args.size)
    near, far = fx.config.dataset.near, fx.config.dataset.far
    poses = np.concatenate([training_poses(args),
                            orbit_poses(5, elev_deg=20.0)[1:3]])
    render = engine.make_render_fn(intr, near, far, False)
    with torch.no_grad():
        images = torch.stack([render(torch.tensor(p, device=dev), aux)["rgb"]
                              for p in poses])
    ds = dataset_from_arrays(images, poses, intr, near, far, n_val=2)
    white = float(((1.0 - ds.images[ds.train_idx]) ** 2).mean())
    print(json.dumps({"views": [len(ds.train_idx), len(ds.val_idx)],
                      "size": args.size, "rays": args.rays, "steps": args.steps,
                      "all_white_loss": white, "device": str(dev),
                      "trainer": "jax" if args.reference else "port"}), flush=True)

    stuck = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as logdir:
            cfg = fx.config.replace(
                experiment=dataclasses.replace(
                    fx.config.experiment, logdir=logdir, id="seeds",
                    print_every=every if args.reference else 0,
                    validate_every=0, save_every=0, train_iters=args.steps,
                    randomseed=seed),
                nerf=dataclasses.replace(fx.config.nerf, num_random_rays=args.rays))
            if args.reference:
                curve, psnr = fit_reference(cfg, ds, logdir)
            else:
                trainer = Trainer(cfg, ds, device=args.device)
                res = trainer.fit()
                losses = np.asarray(res.losses)
                curve = [float(losses[i : i + every].mean())
                         for i in range(0, len(losses), every)]
                psnr = trainer.evaluate_split(res.state, "val")["mean_psnr"]
                trainer.close()
        is_stuck = float(np.mean(curve[-2:])) > 0.9 * white
        stuck += is_stuck
        print(json.dumps({"seed": seed, "loss": [round(v, 4) for v in curve],
                          "val_mean_psnr_db": psnr, "stuck": bool(is_stuck)}),
              flush=True)
    n = len(args.seeds.split(","))
    print(json.dumps({"stuck": int(stuck), "of": n}))
    return 0


def fit_reference(cfg, ds, logdir):
    """The same run through the JAX package's trainer, XLA route; the curve
    is its train loss at every print."""
    import logging

    from nerf_kinematics_tpu.data.types import Intrinsics, NerfDataset
    from nerf_kinematics_tpu.train import config as jcfg
    from nerf_kinematics_tpu.train.trainer import Trainer as JTrainer

    logging.disable(logging.CRITICAL)
    raw = json.loads(config_to_json(cfg))
    raw["ngp"].update(encoder="cp", fused="off")
    i = ds.intrinsics
    jds = NerfDataset(
        images=ds.images, poses=ds.poses,
        intrinsics=Intrinsics(fl_x=i.fl_x, fl_y=i.fl_y, cx=i.cx, cy=i.cy,
                              width=i.width, height=i.height),
        near=ds.near, far=ds.far, train_idx=ds.train_idx, val_idx=ds.val_idx)
    trainer = JTrainer(jcfg.config_from_dict(raw), jds)
    trainer.fit()
    trainer.close()
    with open(os.path.join(logdir, "seeds", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    curve = [r["value"] for r in recs if r["tag"] == "train/loss"]
    psnr = [r["value"] for r in recs if r["tag"] == "val/psnr_mean"]
    return curve, (psnr[-1] if psnr else float("nan"))


if __name__ == "__main__":
    sys.exit(main())
