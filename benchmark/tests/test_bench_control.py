"""The lower-precision control: the reference computed with float8 (e4m3)
operands where the program rounds to bf16, put in the program's place,
reads not correct under each cell's limits. At a tiny size on the CPU;
the readings at the cells' own sizes on the GPU are in PERF.md."""

import pytest

from benchmark.harness import cells, manifest

from . import _tiny


@pytest.mark.parametrize("cell", ["machina_ngp.train", "fox_ngp.train"])
def test_training_control_fails(cell, scenes_dir):
    wl = manifest.workload(cell)
    for seed in (11, 12, 13):
        nums, _ = cells.control_train(_tiny.config(wl["config"]), _tiny.traffic(wl["traffic"]),
                                      seed, "cpu")
        assert any(nums[k] > lim for k, lim in wl["limits"].items()), (seed, nums)


def test_serving_control_fails():
    wl = manifest.workload("machina_ngp.serve_800")
    for seed in (11, 12, 13):
        gaps = cells.control_serve(_tiny.config(wl["config"]), _tiny.traffic(wl["traffic"]),
                                   seed, "cpu")
        assert any(max(g[k] for g in gaps.values()) > lim
                   for k, lim in wl["limits"].items()), gaps
