#!/usr/bin/env python3
"""The classic engine from ``configs/machina_classic.yml``'s own seed 42 on
machina400, the JAX package beside the port, both on the CPU: the witness
for the port's seed-42 run that stays on the all-white image (ROADMAP C.2).

The port writes machina400 at a reduced size (``data/machina.py``, on the
CPU); both frameworks read it from disk through their own blender loader
(``half_res: true`` as the YAML has it), from a copy of the YAML as
``chip_smoke.py``'s ``cli`` phase makes it (``logdir``, ``basedir``,
``randomseed: 42``, validation every ``--every`` steps). Both start from
the JAX engine's ``init_state(42)`` weights (the port takes them through
``load_flax_params``), draw their own rays, depth jitter and density noise,
and train with their ``Trainer.fit``; the port also trains from its own
``init_state()`` of seed 42 (torch's draws, what its command line starts
from). For each run it prints the
validation PSNR of val view 0 every ``--every`` steps (the trainers'
``val/psnr``), the all-white image's PSNR on that view, and whether the run
sits on it: within 0.05 dB of it at a validation. With ``--lockstep`` it
also runs the two engines' train steps side by side from the JAX weights,
the port given JAX's draws at every step (``lockstep()``), so that the two
runs differ by rounding alone. Prints one JSON object.

    JAX_PLATFORMS=cpu python3 scripts/torch_classic_seed_witness.py
    JAX_PLATFORMS=cpu python3 scripts/torch_classic_seed_witness.py --resolution 400 \
        --rays 1024 --steps 400 --lockstep

Cuts against the card's run (``scripts/torch_classic_cli_curve.py``: 400^2
images, 100 / 8 / 16 views, 1024 samples a pixel, 1024 rays a step, 2000
steps): ``--resolution``, ``--views``, ``--samples`` (the generator's),
``--rays``, ``--steps``. The widths are the YAML's (two 8-layer,
128-wide ``FlexibleNeRF``s, 64 + 64 samples a ray).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 42
SITS_DB = 0.05  # a validation within this of the all-white image's PSNR sits on it


def _curve(rundir: str) -> dict:
    with open(os.path.join(rundir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {int(r["step"]): float(r["value"]) for r in recs if r["tag"] == "val/psnr"}


def _verdict(curve: dict, white: float) -> dict:
    sits = {s: bool(abs(v - white) <= SITS_DB) for s, v in sorted(curve.items())}
    return {"val_psnr_db": curve, "sits_on_white": sits,
            "sits_at_end": sits[max(sits)] if sits else None}


def write_scene(root: str, resolution: int, views: tuple, samples: int) -> str:
    from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset

    basedir = os.path.join(root, "machina400")
    n_train, n_val, n_test = views
    write_machina_dataset(basedir, resolution=resolution, n_train=n_train, n_val=n_val,
                          n_test=n_test, n_samples=samples, device="cpu")
    return basedir


def config_copy(root: str, basedir: str, tag: str, every: int, rays: int,
                **every_line) -> str:
    """The YAML copy of the ``cli`` phase, with seed 42 and the cuts; each
    key of ``every_line`` (``hidden_size``, ``num_coarse``, ...) is set on
    every line that has it (both models, both render settings)."""
    import re

    import chip_smoke

    d = os.path.join(root, tag)
    os.makedirs(d)
    lines = {"logdir": os.path.join(d, "logs"), "basedir": basedir, "randomseed": SEED,
             "validate_every": every, "print_every": every, "num_random_rays": rays}
    path = chip_smoke.copy_config("machina_classic.yml", d, **lines)
    with open(path) as f:
        text = f.read()
    for key, value in every_line.items():
        text, n = re.subn(rf"^(\s*{key}:)[^\n#]*", rf"\g<1> {value}", text, flags=re.M)
        if not n:
            raise ValueError(f"machina_classic.yml: no '{key}:' line")
    with open(path, "w") as f:
        f.write(text)
    return path


def run_jax(yml: str, steps: int):
    """JAX ``Trainer.fit`` from ``init_state(42)``; returns (curve, white
    PSNR of val view 0, the initial weights)."""
    import jax

    from nerf_kinematics_tpu.metrics.psnr import psnr
    from nerf_kinematics_tpu.train.config import load_config
    from nerf_kinematics_tpu.train.trainer import Trainer

    cfg = load_config(yml)
    trainer = Trainer(cfg)
    state = trainer.engine.init_state(SEED)
    weights = jax.tree_util.tree_map(np.array, state.params)
    trainer.fit(max_iters=steps, state=state)
    ds = trainer.dataset
    gt = ds.images[int(ds.val_idx[0])]
    white = psnr(np.ones_like(gt), gt)
    trainer.close()
    return _curve(trainer.rundir), white, weights


def run_port(yml: str, steps: int, weights=None) -> dict:
    """The port's ``Trainer.fit`` from the JAX weights, or with ``weights``
    None from its own ``init_state()`` of the YAML's seed (torch's draws:
    what the command line starts from)."""
    from nerf_kinematics_tpu_torch.train.config import load_config
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    trainer = Trainer(load_config(yml), device="cpu")
    if weights is None:
        state = trainer.engine.init_state()
    else:
        trainer.engine.load_flax_params(weights)
        state = trainer.engine.init_state(keep_weights=True)
    trainer.fit(max_iters=steps, state=state)
    trainer.close()
    return _curve(trainer.rundir)


def witness(root: str, basedir: str, steps: int, every: int, rays: int,
            own_init: bool = True, **every_line) -> dict:
    """Both frameworks from the JAX weights, one YAML copy each, and with
    ``own_init`` the port from its own seed-42 weights too; ``gap_db`` is
    JAX's last validation PSNR less the port's from the same weights."""
    t0 = time.perf_counter()
    jcurve, white, weights = run_jax(
        config_copy(root, basedir, "jax", every, rays, **every_line), steps)
    t1 = time.perf_counter()
    tcurve = run_port(config_copy(root, basedir, "port", every, rays, **every_line),
                      steps, weights)
    t2 = time.perf_counter()
    last = max(jcurve)
    out = {"all_white_val_psnr_db": white,
           "jax": dict(_verdict(jcurve, white), seconds=t1 - t0),
           "port": dict(_verdict(tcurve, white), seconds=t2 - t1),
           "gap_db": jcurve[last] - tcurve[last]}
    if own_init:
        ocurve = run_port(config_copy(root, basedir, "port_own_init", every, rays,
                                      **every_line), steps)
        out["port_own_init"] = dict(_verdict(ocurve, white),
                                    seconds=time.perf_counter() - t2)
    return out


def jax_draws(key, n_rays: int, n_img: int, H: int, W: int, n_coarse: int,
              n_fine: int) -> dict:
    """The draws the JAX classic train step makes from its state's ``key``
    (pixels, depth jitter, density noise; ``train/loop.py`` and
    ``rendering/renderer.py`` of the JAX package split the key so), as the
    port's train step takes them."""
    import jax

    _, k_batch, k_render = jax.random.split(key, 3)
    k_img, k_row, k_col = jax.random.split(k_batch, 3)
    k_strat, k_noise_c, k_pdf, k_noise_f = jax.random.split(k_render, 4)
    ints = [(k_img, n_img), (k_row, H), (k_col, W)]
    return {
        "pixels": [np.array(jax.random.randint(k, (n_rays,), 0, hi)) for k, hi in ints],
        "u_coarse": np.array(jax.random.uniform(k_strat, (n_rays, n_coarse))),
        "noise_coarse": np.array(jax.random.normal(k_noise_c, (n_rays, n_coarse))),
        "u_fine": np.array(jax.random.uniform(k_pdf, (n_rays, n_fine))),
        "noise_fine": np.array(jax.random.normal(k_noise_f, (n_rays, n_coarse + n_fine))),
    }


def lockstep(root: str, basedir: str, steps: int, every: int, rays: int,
             **every_line) -> dict:
    """Both engines' train steps from the JAX ``init_state(42)`` weights on
    the port's loaded images, the port given JAX's draws at every step (the
    same ray batches, depth jitter and density noise): each one's losses by
    window and validation PSNR of val view 0 every ``every`` steps, rendered
    by its own renderer. ``gap_db`` is JAX's last validation less the
    port's; ``first_loss_rel`` the two first losses' relative distance (the
    draws reproduced)."""
    import jax
    import jax.numpy as jnp
    import torch

    from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
    from nerf_kinematics_tpu.train.config import load_config as jload_config
    from nerf_kinematics_tpu.train.loop import ClassicNerf as JClassic
    from nerf_kinematics_tpu_torch.metrics.psnr import psnr
    from nerf_kinematics_tpu_torch.train.config import load_config
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    yml = config_copy(root, basedir, "lockstep", every, rays, **every_line)
    trainer = Trainer(load_config(yml), device="cpu")
    te, ds = trainer.engine, trainer.dataset
    je = JClassic(jload_config(yml))
    jstate = je.init_state(SEED)
    te.load_flax_params(jax.tree_util.tree_map(np.array, jstate.params))
    tstate = te.init_state(keep_weights=True)
    ti = ds.intrinsics
    jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy, width=ti.width,
                        height=ti.height)
    jstep = je.make_train_step(jintr, ds.near, ds.far, ds.use_ndc, donate=False)
    tstep = te.make_train_step(ti, ds.near, ds.far, ds.use_ndc)
    jrender = je.make_render_fn(jintr, ds.near, ds.far, ds.use_ndc)
    trender = te.make_render_fn(ti, ds.near, ds.far, ds.use_ndc)
    jimgs, jposes = jnp.asarray(trainer.images.numpy()), jnp.asarray(trainer.poses.numpy())
    tr = te.cfg.nerf.train
    n_img, H, W = trainer.images.shape[:3]
    i_val = int(ds.val_idx[0])
    gt = ds.images[i_val]
    pose = ds.poses[i_val].astype(np.float32)
    white = psnr(np.ones_like(gt), gt)
    losses = {"jax": [], "port": []}
    curves = {"jax": {}, "port": {}}
    for it in range(1, steps + 1):
        d = jax_draws(jstate.key, te.cfg.nerf.num_random_rays, n_img, H, W, tr.num_coarse,
                      tr.num_fine)
        jstate, jm = jstep(jstate, jimgs, jposes)
        tstate, tm = tstep(tstate, trainer.images, trainer.poses,
                           pixels=[torch.as_tensor(p) for p in d.pop("pixels")],
                           **{k: torch.as_tensor(v) for k, v in d.items()})
        losses["jax"].append(float(jm["loss"]))
        losses["port"].append(float(tm["loss"]))
        if it % every == 0:
            curves["jax"][it] = psnr(np.asarray(jrender(jstate.params, jnp.asarray(pose))["rgb"]),
                                     gt)
            with torch.no_grad(), te.bound(tstate.params):
                curves["port"][it] = psnr(trender(torch.as_tensor(pose))["rgb"].numpy(), gt)
    trainer.close()
    last = max(curves["jax"])
    out = {"all_white_val_psnr_db": white,
           "gap_db": curves["jax"][last] - curves["port"][last],
           "first_loss_rel": abs(losses["port"][0] - losses["jax"][0]) / losses["jax"][0],
           "seconds": time.perf_counter() - t0}
    for fw in ("jax", "port"):
        win = [float(np.mean(losses[fw][k:k + every])) for k in range(0, steps, every)]
        out[fw] = dict(_verdict(curves[fw], white), loss_by_window=win)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--resolution", type=int, default=200)
    ap.add_argument("--views", default="40,4,2", help="train,val,test")
    ap.add_argument("--samples", type=int, default=256)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--every", type=int, default=100)
    ap.add_argument("--lockstep", action="store_true",
                    help="also run both train steps with JAX's draws (lockstep())")
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    views = tuple(int(v) for v in args.views.split(","))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        basedir = write_scene(root, args.resolution, views, args.samples)
        scene_s = time.perf_counter() - t0
        report = {"cuts": {"resolution": args.resolution, "loaded_at": args.resolution // 2,
                           "views": views, "samples": args.samples, "rays": args.rays,
                           "steps": args.steps,
                           "card": "400^2 (200^2 loaded), 100/8/16 views, 1024 samples, "
                                   "1024 rays, 2000 steps"},
                  "seed": SEED, "scene_seconds": scene_s}
        report.update(witness(root, basedir, args.steps, args.every, args.rays))
        if args.lockstep:
            report["lockstep"] = lockstep(root, basedir, args.steps, args.every, args.rays)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
