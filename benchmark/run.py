"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the GPUs the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result; if JAX or
the JAX package was loaded into this process, it exits 3 and prints none.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
# Kernel and build caches at fixed paths inside the checkout.
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(BENCH_DIR, "cache", _sub)
os.environ["USE_FLAX"] = "0"
if REPO_DIR not in sys.path:
    sys.path.insert(0, REPO_DIR)

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_kinematics_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must never load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(run, cell: str, trace: bool, device_info: dict) -> dict:
    from benchmark.harness import manifest

    metrics = {}
    if trace:
        for name, unit in manifest.cell_metrics(cell, True):
            value = manifest.metric_reader(name).read(run.ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": unit}
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for name, unit in manifest.cell_metrics(cell, False):
            metrics[name] = {"value": float(values[name]), "unit": unit}
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_info}
    if trace:
        line["device"]["busy_s"] = run.ctx.trace.busy_s()
        line["device"]["window_s"] = run.ctx.trace.window_s
        line["breakdown"] = {"device_ops": run.ctx.trace.top_ops(10),
                             "idle_gaps": run.ctx.trace.idle_gaps(10)}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from benchmark.harness import manifest
    from benchmark.harness.cells import RUNNERS

    wl = manifest.workload(args.workload)
    chips = int(wl.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload}: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cfgf = manifest.config(wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    run = RUNNERS[traffic["kind"]](args.workload, wl, cfgf, traffic, args.seed,
                                   args.seconds, bool(args.trace), "cuda:0", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process, and never to be: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": chips, "memory_peak_bytes": run.memory_peak_bytes}
    line = result_line(run, args.workload, bool(args.trace), device_info)
    print(json.dumps({"counters": run.counters, "window_s": run.window_s}), flush=True)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
