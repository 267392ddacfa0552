"""On the GPU: the command as the check runs it, one short run of each cell
with and without its trace, correct and with the result line's shape.
Marked ``card``: without a CUDA device they skip. Without one, the command
itself must exit non-zero and print no result."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import manifest

CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_is_correct(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "4000000001",
         "--seconds", "3", "--trace", str(trace)],
        cwd=manifest.REPO_DIR, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    want = {n for n, _ in manifest.cell_metrics(cell, bool(trace))}
    assert set(line["metrics"]) <= want and line["metrics"]
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]


def test_without_a_gpu_the_command_prints_no_result():
    if os.environ.get("CUDA_VISIBLE_DEVICES") is None and _has_cuda():
        pytest.skip("a GPU is here")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=manifest.REPO_DIR, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _has_cuda():
    import torch

    return torch.cuda.is_available()
