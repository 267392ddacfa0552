#!/usr/bin/env python3
"""Witness of the ``scene`` phase's trained quality: does the tile kernel of
rows 7 and 8 train ``configs/machina_ngp.yml`` as their plain versions do?

    python3 scripts/torch_scene_witness.py --out witness.json   # the GPU, ~8 min
    python3 scripts/torch_scene_witness.py --controls 3 --adam-controls 2
    python3 scripts/torch_scene_witness.py --device cpu --quick --rays 256 \\
        --steps 4 --checks 2,4 --controls 1 --adam-controls 1   # a rehearsal

The ``scene`` phase's recipe (``chip_smoke.py``): machina400 generated by the
port, ``scene_config(..., fused_train="full")`` (one row-8 call a step), the
JAX package's seed-42 initial weights, ``--steps`` steps, val PSNR of view 0
at each of ``--checks``. Three routes with the same draws (the step's
generator is part of the start state):

  * ``kernel``: the route as shipped;
  * ``control <k>``: the kernel route from the start weights nudged by one
    ulp on a random half (numpy seeds 1..``--controls``), as the ``mesh``
    phase's controls are; their spread is the yardstick;
  * ``plain``: rows 7 and 8 through their plain PyTorch versions on the card
    (``chip_smoke.py::plain_fused_train_rows``).

Then, at the plain route's state after each check, one step's gradients as
Adam takes them (``chip_smoke.py::adam_step_of``, ``adam_compare``), leaf
by leaf: the kernel's against the plain version's, and beside them the
kernel's from the same state nudged by one ulp (seeds 1..``--adam-controls``)
against the kernel's, and the plain version's likewise: entries exactly 0
in one gradient only, entries whose signs disagree, and the relative
distance of the two updates under the run's own moments.

Prints one JSON object (the readings, the card's ``nvidia-smi`` line and
``verdict``: whether the plain route's PSNR lies within the controls' spread
at every check), and writes it to ``--out`` if given. Without a CUDA device
it exits 2, unless ``--device cpu`` asks for a rehearsal with the plain
versions (every route then takes them).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    SCENE, SCENE_QUICK, adam_compare, adam_step_of, nudged, plain_fused_train_rows,
    scene_config)


def summary(rows: list) -> dict:
    """Per leaf, the min and max of each reading over ``rows``."""
    out = {}
    for leaf in rows[0]:
        out[leaf] = {k: [min(r[leaf][k] for r in rows), max(r[leaf][k] for r in rows)]
                     for k in ("zero_mismatch", "sign_disagree", "update_rel")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--checks", default="1024,2048",
                    help="steps at which val PSNR is read (the last is --steps)")
    ap.add_argument("--controls", type=int, default=5)
    ap.add_argument("--adam-controls", type=int, default=5)
    ap.add_argument("--quick", action="store_true",
                    help="the scene at chip_smoke.py --quick's size")
    ap.add_argument("--rays", type=int, default=None,
                    help="rays a step (default: the config's 8192)")
    ap.add_argument("--device", default=None, help="default: the GPU")
    ap.add_argument("--out", default=None, help="also write the JSON object there")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print("no CUDA device (--device cpu for a rehearsal)", file=sys.stderr)
        return 2
    dev = torch.device(args.device or "cuda")
    checks = [int(c) for c in args.checks.split(",")]
    if checks[-1] != args.steps or checks != sorted(checks):
        ap.error("--checks must rise to --steps")

    from nerf_kinematics_tpu_torch.bench import nvidia_smi_line
    from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset
    from nerf_kinematics_tpu_torch.io.convert import params_from_npz
    from nerf_kinematics_tpu_torch.io.fixture import MACHINA_NGP_INIT42, read_fixture
    from nerf_kinematics_tpu_torch.ops import cuda_lib
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": nvidia_smi_line() if dev.type == "cuda" else "cpu",
              "steps": args.steps, "checks": checks}
    if dev.type == "cuda":
        cuda_lib.load_library()
        report["build_seconds"] = cuda_lib.BUILD_INFO["seconds"]
    fx = read_fixture()
    with tempfile.TemporaryDirectory() as root:
        basedir = os.path.join(root, "machina400")
        t0 = time.perf_counter()
        write_machina_dataset(basedir, device=dev, **(SCENE_QUICK if args.quick else SCENE))
        sync()
        report["generate_seconds"] = time.perf_counter() - t0
        cfg = scene_config(fx, basedir, root, args.steps, args.quick)
        cfg = cfg.replace(experiment=dataclasses.replace(cfg.experiment, validate_every=0))
        if args.rays:
            cfg = cfg.replace(nerf=dataclasses.replace(cfg.nerf, num_random_rays=args.rays))
        trainer = Trainer(cfg, device=dev)
        eng = trainer.engine
        eng.load_flax_params(params_from_npz(MACHINA_NGP_INIT42))
        origin = eng.init_state(keep_weights=True)  # the step's generator: seed 42
        report["fused_train"] = cfg.ngp.fused_train
        print(json.dumps(report), file=sys.stderr, flush=True)

        plan = [("kernel", 0), *((f"control {k}", k) for k in range(1, args.controls + 1)),
                ("plain", 0)]
        states = {}
        for name, seed in plan:
            st = nudged(origin, seed) if seed else origin.clone()
            ctx = plain_fused_train_rows if name == "plain" else contextlib.nullcontext
            rec = {"val_psnr_db": {}, "loss_last64": {}}
            cuda_lib.reset_launch_counts()
            t0 = time.perf_counter()
            with ctx():
                for c in checks:
                    res = trainer.fit(max_iters=c, state=st)
                    st = res.state
                    rec["val_psnr_db"][c] = trainer.validate(st)["val_psnr"]
                    rec["loss_last64"][c] = float(np.mean(res.losses[-64:]))
                    if name == "plain":
                        states[c] = st.clone()
            sync()
            rec["seconds"] = time.perf_counter() - t0
            rec["launches"] = {k: v for k, v in cuda_lib.LAUNCHES.items()
                               if k.startswith("ngp_fused_train")}
            report[name] = rec
            print(json.dumps({name: rec}), file=sys.stderr, flush=True)

        # ---- the gradients as Adam takes them, at the plain route's states
        layout = eng.layout
        adam = {}
        for c, s in states.items():
            t0 = time.perf_counter()
            k = adam_step_of(trainer, s)
            p = adam_step_of(trainer, s, plain_fused_train_rows)
            seeds = range(1, args.adam_controls + 1)
            kc = [adam_compare(layout, adam_step_of(trainer, nudged(s, i)), k)
                  for i in seeds]
            pc = [adam_compare(layout, adam_step_of(trainer, nudged(s, i),
                                                    plain_fused_train_rows), p)
                  for i in seeds]
            adam[c] = {"kernel_vs_plain": adam_compare(layout, k, p),
                       "kernel_controls": summary(kc) if kc else None,
                       "plain_controls": summary(pc) if pc else None,
                       "seconds": time.perf_counter() - t0}
            print(json.dumps({f"adam at {c}": adam[c]["kernel_vs_plain"]["all"]}),
                  file=sys.stderr, flush=True)
        report["adam"] = adam
        trainer.close()

    ctrl = [report[n] for n, s in plan if s]
    if ctrl:
        spread = {c: [min(r["val_psnr_db"][c] for r in ctrl),
                      max(r["val_psnr_db"][c] for r in ctrl)] for c in checks}
        report["controls_spread_db"] = spread
        report["verdict"] = {
            f"{route}_inside_controls": all(
                lo <= report[route]["val_psnr_db"][c] <= hi for c, (lo, hi) in spread.items())
            for route in ("plain", "kernel")}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
