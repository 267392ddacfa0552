"""Where the benchmark's parts live, found by name.

    benchmark/workloads/<cell>.json    a cell: its configuration, traffic, limits
    benchmark/configs/<config>.json    a configuration as it is run
    benchmark/traffic/<traffic>.json   a traffic mix's parameters
    benchmark/metrics/<metric>.py      a per-layer metric's reader
    BENCHMARK.json                     which metrics each cell reports

A cell, a configuration, a traffic mix or a metric is added by adding its
file (and its entry in ``BENCHMARK.json``); no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _json(kind: str, name: str, root: str) -> dict:
    path = os.path.join(root, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                                f"named {name!r}: {path} is missing")
    with open(path) as f:
        return json.load(f)


def workload(name: str, root: str = BENCH_DIR) -> dict:
    return _json("workloads", name, root)


def config(name: str, root: str = BENCH_DIR) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: str = BENCH_DIR) -> dict:
    return _json("traffic", name, root)


def metric_reader(name: str, root: str = BENCH_DIR):
    """The module of ``metrics/<name>.py``; its ``read(ctx)`` returns the
    metric's value or None where the trace holds nothing to read."""
    path = os.path.join(root, "metrics", name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(repo: str = REPO_DIR) -> dict:
    with open(os.path.join(repo, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(cell: str, trace: bool, repo: str = REPO_DIR):
    """The metrics a run of ``cell`` reports: its end-to-end ones without
    ``--trace``, its per-layer ones with it, each (name, unit)."""
    m = manifest(repo)
    group = m["per_layer"] if trace else m["end_to_end"]
    return [(e["name"], e["unit"]) for e in group
            if "workloads" not in e or cell in e["workloads"]]
