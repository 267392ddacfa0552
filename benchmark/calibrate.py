"""The readings the limits of ``correct`` are set from, on the GPU, for one
cell, in one process:

  * ``program``: the numbers a run compares, the program against the f32
    reference, on each seed given;
  * ``control``: the reference computed in float8 (e4m3) operands put in the
    program's place, against the f32 reference, on each control seed;
  * ``fault:<name>``: the program with a fault planted underneath, against
    the f32 reference (training: ``half``; serving: ``altered``,
    ``half_frame``; a training state left ``unchanged`` reads 1 and needs
    no run).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--faults half] [--seconds 4] [--out file.jsonl]

Each reading is one JSON line (also appended to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import cells, manifest

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    wl = manifest.workload(args.workload)
    cfgf = manifest.config(wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    runner = cells.RUNNERS[traffic["kind"]]
    dev = torch.device("cuda:0")

    def emit(rec):
        rec["cell"] = args.workload
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    def program(seed, fault=None):
        t = time.perf_counter()
        run = runner(args.workload, wl, cfgf, traffic, seed, args.seconds, False, dev,
                     time.perf_counter(), fault=fault)
        emit({"kind": "fault:" + fault if fault else "program", "seed": seed,
              "numbers": {k: v for k, (v, _) in run.checks.items()},
              "e2e": run.e2e, "seconds": time.perf_counter() - t,
              "readings": run.readings})

    for seed in args.seeds:
        program(seed)
    for name in [f for f in args.faults.split(",") if f]:
        for seed in args.fault_seeds or args.seeds[:3]:
            program(seed, name)

    saved = cells._reference_precision(dev)
    for seed in args.control_seeds:
        t = time.perf_counter()
        if traffic["kind"] == "train":
            nums, readings = cells.control_train(cfgf, traffic, seed, dev)
        else:
            gaps = cells.control_serve(cfgf, traffic, seed, dev)
            nums = {k: max(g[k] for g in gaps.values()) for k in wl["limits"]}
            readings = {"frames": {str(k): v for k, v in gaps.items()}}
        emit({"kind": "control", "seed": seed, "numbers": nums, "readings": readings,
              "seconds": time.perf_counter() - t})
    cells._restore_precision(saved)
    return 0


if __name__ == "__main__":
    sys.exit(main())
