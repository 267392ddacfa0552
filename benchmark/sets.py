"""The sets that the end-to-end bounds are set from, and the arithmetic.

Runs one cell as two (or more) sets of runs, the same seeds in each set, each
run a process of its own (``benchmark/run.py``), one after the other, and
keeps each run's output in ``--out``. Then, for every end-to-end metric of
the cell, it gives each set's values, median and spread (the distance
between the first and the third quartile, ``statistics.quantiles(values,
n=4)``, over the median), and the bound these suggest: five times the widest
set's spread, at least 1 % and at most 25 %. It also gives the two readings
by which a check judges a bound: the mean over the sets of each set's spread
with its run farthest from the median left out (too tight where it passes
half the bound), and the spread of all runs together (too loose where the
bound passes eight times it).

    python3 benchmark/sets.py --workload <cell> --seeds 11,12,13,14,15,16 \\
        [--sets 2] [--seconds <run_seconds>] [--trace-seeds 17,18,19] [--out DIR]
    python3 benchmark/sets.py --summarize DIR [DIR ...]

The summary is printed and written to ``DIR/summary.json``. With several
directories (of one cell), ``--summarize`` pools their runs by set name.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import subprocess
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
SETS = "ABCDEFGH"


def spread(values) -> float:
    """Interquartile range over the median."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def spread_without_farthest(values) -> float:
    """:func:`spread` with the run farthest from the median left out."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def suggested_bound(widest: float) -> float:
    return min(0.25, max(0.01, 5.0 * widest))


def summarize_metric(sets: dict) -> dict:
    """{set name: [values]} -> the readings of one metric."""
    out = {"sets": {}}
    for name, values in sorted(sets.items()):
        out["sets"][name] = {"values": values, "median": statistics.median(values),
                             "spread": spread(values) if len(values) >= 2 else None}
    spreads = [s["spread"] for s in out["sets"].values() if s["spread"] is not None]
    if spreads:
        out["widest_spread"] = max(spreads)
        out["bound"] = suggested_bound(out["widest_spread"])
        tight = [spread_without_farthest(v) for v in sets.values() if len(v) >= 3]
        out["tightness_spread"] = statistics.mean(tight) if tight else None
        everything = [v for vs in sets.values() for v in vs]
        out["pooled_spread"] = spread(everything)
    medians = [s["median"] for s in out["sets"].values()]
    if len(medians) >= 2:
        out["median_shift"] = (medians[-1] - medians[0]) / medians[0]
    return out


def read_runs(dirs) -> list:
    """Every run's result line in ``dirs``: (set, seed, trace, line)."""
    runs = []
    for d in dirs:
        for path in sorted(glob.glob(os.path.join(d, "*.out"))):
            stem = os.path.basename(path)[:-4]            # <set><i>-<seed>[-trace]
            tag, seed = stem.split("-")[:2]
            last = None
            with open(path) as f:
                for line in f:
                    if line.startswith("{"):
                        last = json.loads(line)
            if last is not None and "correct" in last:
                runs.append((tag.rstrip("0123456789"), int(seed), stem.endswith("-trace"),
                             last))
    return runs


def summarize(dirs) -> dict:
    runs = read_runs(dirs)
    timed = [r for r in runs if not r[2]]
    by_metric = {}
    for set_name, _, _, line in timed:
        for name, m in line["metrics"].items():
            by_metric.setdefault(name, {}).setdefault(set_name, []).append(m["value"])
    checks = {}
    for _, _, _, line in runs:
        for name, c in line.get("checks", {}).items():
            cur = checks.setdefault(name, {"limit": c["limit"], "max": c["value"]})
            cur["max"] = max(cur["max"], c["value"])
    return {"runs": len(runs), "correct": sum(bool(r[3]["correct"]) for r in runs),
            "seeds": sorted({r[1] for r in runs}),
            "metrics": {k: summarize_metric(v) for k, v in sorted(by_metric.items())},
            "checks": checks,
            "memory_peak_bytes": max((r[3]["device"].get("memory_peak_bytes", 0)
                                      for r in runs), default=0),
            "traced": [{"seed": r[1], "metrics": r[3]["metrics"],
                        "busy_s": r[3]["device"].get("busy_s"),
                        "window_s": r[3]["device"].get("window_s")}
                       for r in runs if r[2]]}


def run_one(cell: str, seed: int, seconds: float, trace: bool, stem: str, out: str) -> int:
    cmd = [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace))]
    with open(os.path.join(out, stem + ".out"), "w") as fo, \
            open(os.path.join(out, stem + ".err"), "w") as fe:
        return subprocess.run(cmd, cwd=REPO_DIR, stdout=fo, stderr=fe).returncode


def _ints(text: str):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload")
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace-seeds", type=_ints, default=[])
    p.add_argument("--out", default=None)
    p.add_argument("--summarize", nargs="+", default=None)
    args = p.parse_args(argv)
    if args.summarize:
        dirs = args.summarize
    else:
        if not args.workload or not args.seeds:
            p.error("--workload and --seeds are needed to run sets")
        with open(os.path.join(REPO_DIR, "BENCHMARK.json")) as f:
            seconds = args.seconds or json.load(f)["run_seconds"]
        out = args.out or os.path.join(BENCH_DIR, "cache", "sets", args.workload)
        os.makedirs(out, exist_ok=True)
        for s in SETS[:args.sets]:
            for i, seed in enumerate(args.seeds, 1):
                t = time.perf_counter()
                rc = run_one(args.workload, seed, seconds, False, f"{s}{i}-{seed}", out)
                print(f"{args.workload} {s}{i} seed {seed}: rc {rc}, "
                      f"{time.perf_counter() - t:.1f} s", flush=True)
        for i, seed in enumerate(args.trace_seeds, 1):
            rc = run_one(args.workload, seed, seconds, True, f"T{i}-{seed}-trace", out)
            print(f"{args.workload} T{i} seed {seed}: rc {rc}", flush=True)
        dirs = [out]
    summary = summarize(dirs)
    text = json.dumps(summary, indent=1)
    print(text)
    with open(os.path.join(dirs[0], "summary.json"), "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
