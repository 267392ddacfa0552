"""Where the host waits for the device inside a training cell's steps.

    python3 scripts/torch_host_waits.py --cells fox_ngp.train,machina_ngp.train \\
        --out build/host_waits.json

On a machine with a CUDA device, from the root of a checkout. Each cell's
trainer is built as ``benchmark/harness/cells.py::run_train`` builds it (the
configuration, scene and start state of the benchmark), warmed up for 24
steps, then runs 8 steps twice:

* under ``torch.cuda.set_sync_debug_mode("warn")``: each synchronising call's
  Python stack (the last frames outside site-packages), counted;
* under ``torch.profiler`` with host operators: each host synchronisation
  or blocking copy (``cudaStreamSynchronize``, ``cudaMemcpy*``, ...) with
  the operators that enclose it and its host milliseconds over the 8 steps.

A synchronisation inside a step makes the host wait for the device, which
then idles while the host enqueues the rest of the step: the program's spans
(``utils/profiling.py``) show where, this names the call.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WAITS = ("Synchronize", "cudaMemcpy", "cudaStreamWaitEvent")


def trainer_for(cell: str, device, seed: int):
    """The cell's trainer and start state, as its benchmark run builds them."""
    import numpy as np
    import torch

    from benchmark.harness import cells, manifest
    from benchmark.harness import scene as scenes
    from benchmark.reference import fixture as ref_fixture
    from benchmark.reference import ngp as ref
    from nerf_kinematics_tpu_torch.data.types import Intrinsics, NerfDataset
    from nerf_kinematics_tpu_torch.ops.occupancy import OccupancyGrid
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    cfgf = manifest.config(manifest.workload(cell)["config"])
    cfg, _ = cells._port_config(cfgf, seed, tempfile.mkdtemp())
    sc = scenes.load_scene(cfgf["scene"], device)
    fl_x, fl_y, cx, cy, W, H = sc["intrinsics"]
    n = sc["images"].shape[0]
    ds = NerfDataset(images=sc["images"], poses=sc["poses"],
                     intrinsics=Intrinsics(fl_x, fl_y, cx, cy, int(W), int(H)),
                     near=sc["near"], far=sc["far"], train_idx=np.arange(n),
                     val_idx=np.zeros(0, np.int64), aabb_scale=sc["aabb_scale"])
    trainer = Trainer(cfg, dataset=ds, device=device)
    leaves, grid, bound = ref_fixture.read_start(cells._path(cfgf["start"]["train"]),
                                                 ref.model_spec(cfgf["sizes"]))
    cells._load_leaves(trainer.engine, leaves)
    grid, bound = cells.start_grid(cfgf, sc, grid, bound)
    state = trainer.engine.init_state(keep_weights=True)
    state.aux = OccupancyGrid(torch.as_tensor(grid, device=device),
                              torch.tensor(bound, device=device))
    return trainer, state


def sync_stacks(fit) -> dict:
    """Python stacks of the synchronising calls ``fit()`` makes."""
    import torch

    found = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "site-packages" not in f.filename and "warnings.py" not in f.filename]
        key = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}:{f.name}"
                          for f in reversed(frames[-4:]))
        found[key or f"(no Python frame) {message}"[:160]] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return dict(found.most_common())


def host_waits(fit) -> list:
    """[call in its enclosing operators, count, host ms] of each kind of host
    wait ``fit()`` makes, most time first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    waits = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type.name != "CPU" or not any(w in e.name for w in WAITS):
            continue
        chain, parent = [], e.cpu_parent
        while parent is not None and len(chain) < 3:
            chain.append(parent.name)
            parent = parent.cpu_parent
        key = f"{e.name} in {' < '.join(chain) or '(no operator)'}"
        waits[key][0] += 1
        waits[key][1] += e.cpu_time_total / 1e3
    return sorted(([k, n, ms] for k, (n, ms) in waits.items()), key=lambda t: -t[2])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="fox_ngp.train,machina_ngp.train")
    p.add_argument("--seed", type=int, default=4190003001)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = {}
    for cell in args.cells.split(","):
        trainer, state = trainer_for(cell, device, args.seed)
        for k in (8, 16, 24):      # warm-up: every shape built
            trainer.fit(max_iters=k, state=state)
        torch.cuda.synchronize()
        out[cell] = {
            "sync_stacks_over_8_steps": sync_stacks(
                lambda: trainer.fit(max_iters=32, state=state)),
            "host_waits_over_8_steps": host_waits(
                lambda: trainer.fit(max_iters=40, state=state)),
        }
        print(cell, json.dumps(out[cell], indent=1), flush=True)
        del trainer, state
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
