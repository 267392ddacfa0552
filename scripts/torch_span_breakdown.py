"""Where the host's time and the device's idle time go, by the program's
spans (``nerf_kinematics_tpu_torch/utils/profiling.py``), in a benchmark
cell's traced window.

    python3 scripts/torch_span_breakdown.py \\
        --cells machina_ngp.train,fox_ngp.train,machina_ngp.serve_800 \\
        --seed 4190000001 --out build/span_breakdown.json

On a machine with a CUDA device, from the root of a checkout. Each cell runs
as ``benchmark/run.py --trace 1`` runs it (set-up, the traced window of 2
chunks or 24 frames, the comparison with the reference), with the window
recorded by ``utils/profiling.device_trace``: the device's operations and
the program's spans, no host operators, into
``--trace-dir/<cell>/trace.json`` (Perfetto). Printed and written per cell:

* ``metrics``: the cell's per-layer metrics as its traced run reads them;
* ``idle_ms``: device idle milliseconds a step (or frame) by the innermost
  span open at the time (``idle_by_span``), and ``idle_in_spans``, the share
  of the idle time that falls inside some span;
* ``host_ms``: milliseconds a step (or frame) of each span name, and
  ``self_ms`` the part of it that no child span covers;
* ``cover``: the share of ``step`` (``frame``) time its children cover;
* ``clock``: for each of the program's kernels (``nkt_``, ``nkc_``,
  ``nkf_``), its device start less the start of the ``launch.call`` span that
  launched it (matched in order through the profiler's launch records); the
  least of them in microseconds, how many started more than 2 us before it,
  and each second's least device start less host launch (a kernel cannot
  start before its launch: a negative value is the two clocks apart).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LAUNCH_CALLS = ("cudaLaunch", "cuLaunch")   # the host's launch records


def _device_ops(prof):
    """(name, start_ns, end_ns) of the device's operations, and the start
    (ns) of each of the host's kernel launch records, from the profile."""
    ops, launches = [], []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" in str(e.device_type()):
            ops.append((e.name(), e.start_ns(), e.end_ns()))
        elif e.name().startswith(LAUNCH_CALLS):
            launches.append(e.start_ns())
    return ops, sorted(launches)


def traced_runner(trace_dir: str, holder: dict):
    """The harness's ``device_trace`` (``benchmark/harness/trace.py``) swapped
    for the port's exporter, filling the harness's ``Trace`` alike."""
    from nerf_kinematics_tpu_torch.utils import profiling

    @contextlib.contextmanager
    def device_trace(out, enabled=True):
        if not enabled:
            yield out
            return
        with profiling.device_trace(trace_dir) as prof:
            yield out
        ops, launches = _device_ops(prof)
        out.ops = [(n, s * 1e-9, e * 1e-9) for n, s, e in ops]
        holder.update(ops=ops, launches=launches)

    return device_trace


def clock_check(ops, launches, recs) -> dict:
    """Each port kernel's device start less the start of the launch.call
    span that launched it (us). The library launches its kernels on one
    stream from inside ``launch.call`` spans and nothing else there, so the
    host's launch records inside those spans, in order, are the port
    kernels' launches in device order; ``launched`` counts them (equal to
    ``kernels`` when the match holds)."""
    from benchmark.harness.trace import is_port_kernel

    calls = sorted((s.start_ns, s.end_ns) for s in recs if s.name == "launch.call" and s.end_ns)
    starts = [c[0] for c in calls]
    owner = []          # the call span of each port launch, in host order
    for h in launches:
        j = bisect.bisect_right(starts, h) - 1
        if j >= 0 and h <= calls[j][1]:
            owner.append((j, h))
    kernels = sorted(s for name, s, _ in ops if is_port_kernel(name))
    lead = [(s - calls[j][0]) * 1e-3 for s, (j, _) in zip(kernels, owner)]
    after = [(h, s - h) for s, (_, h) in zip(kernels, owner)]
    by_s = {}
    for h, d in after:
        k = int((h - after[0][0]) // 1_000_000_000)
        by_s[k] = min(by_s.get(k, d), d)
    return {"kernels": len(kernels), "launched": len(owner),
            "least_us": min(lead) if lead else None,
            "before_2us": sum(d < -2.0 for d in lead),
            "device_after_launch_least_us_by_s": [round(by_s[k] * 1e-3, 3)
                                                  for k in sorted(by_s)]}


def breakdown(recs, per: int, idle: dict) -> dict:
    """Host ms a unit by span name (whole and self), the children's cover
    of ``step`` / ``frame``, idle ms a unit by innermost span."""
    from nerf_kinematics_tpu_torch.utils import profiling

    closed = [(i, s) for i, s in enumerate(recs) if s.end_ns]
    whole, child = {}, {}
    for i, s in closed:
        d = s.end_ns - s.start_ns
        whole[s.name] = whole.get(s.name, 0) + d
        if s.parent >= 0:
            child[s.parent] = child.get(s.parent, 0) + d
    self_ns = {}
    for i, s in closed:
        self_ns[s.name] = self_ns.get(s.name, 0) + (s.end_ns - s.start_ns) - child.get(i, 0)
    cover = {}
    for top in ("step", "frame"):
        tot = sum(s.end_ns - s.start_ns for _, s in closed if s.name == top)
        kids = sum(child.get(i, 0) for i, s in closed if s.name == top)
        if tot:
            cover[top] = kids / tot
    idle_total = sum(idle.values())
    return {
        "host_ms": {k: v * 1e-6 / per for k, v in sorted(whole.items())},
        "self_ms": {k: v * 1e-6 / per for k, v in sorted(self_ns.items())},
        "cover": cover,
        "idle_ms": {k: v * 1e3 / per for k, v in sorted(idle.items(), key=lambda t: -t[1])},
        "idle_in_spans": 1 - idle.get(profiling.NO_SPAN, 0.0) / idle_total if idle_total else None,
        "dropped": profiling.dropped(),
    }


def run_cell(cell: str, seed: int, trace_dir: str, device: str = "cuda:0") -> dict:
    import torch

    from benchmark.harness import cells, manifest
    from nerf_kinematics_tpu_torch.utils import profiling

    wl = manifest.workload(cell)
    cfgf, traffic = manifest.config(wl["config"]), manifest.traffic(wl["traffic"])
    holder = {}
    saved = cells.device_trace
    cells.device_trace = traced_runner(os.path.join(trace_dir, cell), holder)
    try:
        run = cells.RUNNERS[traffic["kind"]](cell, wl, cfgf, traffic, seed, 0.0, True,
                                             device, time.perf_counter())
    finally:
        cells.device_trace = saved
    metrics = {}
    for name, _ in manifest.cell_metrics(cell, True):
        v = manifest.metric_reader(name).read(run.ctx)
        if v is not None:
            metrics[name] = float(v)
    per = run.ctx.steps or run.ctx.frames
    recs = profiling.spans()
    out = {"cell": cell, "seed": seed, "units": per, "correct": run.correct,
           "checks": {k: list(v) for k, v in run.checks.items()},
           "window_s": run.window_s, "busy_s": run.ctx.trace.busy_s(),
           "device": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
           "metrics": metrics}
    out.update(breakdown(recs, per, profiling.idle_by_span()))
    out["clock"] = clock_check(holder["ops"], holder["launches"], recs)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default="machina_ngp.train,fox_ngp.train,machina_ngp.serve_800")
    p.add_argument("--seed", type=int, default=4190000001)
    p.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "span_traces"))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    results = []
    for i, cell in enumerate(args.cells.split(",")):
        r = run_cell(cell, args.seed + i, args.trace_dir)
        results.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
