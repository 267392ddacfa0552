"""Tiny versions of the benchmark's cells, for the CPU: the configurations'
widths as they are, fewer rays and samples, a small occupancy grid, and
small scenes."""

import copy
import time

from benchmark.harness import cells, manifest

SEED = 12345678901


def config(name: str) -> dict:
    c = copy.deepcopy(manifest.config(name))
    tr = c["yaml"]["nerf"]["train"]
    tr["num_random_rays"] = 256
    if tr.get("num_fine", 0):
        tr["num_coarse"], tr["num_fine"] = 8, 8
    else:
        tr["num_coarse"] = 16
    c["yaml"]["ngp"]["occ_resolution"] = 16
    c["yaml"]["ngp"]["occ_update_every"] = 4
    if c["scene"]["generator"] == "machina":
        c["scene"]["params"] = {"resolution": 24, "n_train": 4, "seed": 7, "n_samples": 64}
    else:
        c["scene"]["params"] = {"n_views": 6, "resolution": 24}
    c["scene"]["name"] += "-tiny"
    return c


def traffic(name: str) -> dict:
    t = dict(manifest.traffic(name))
    if t["kind"] == "viewer":
        t.update(resolution=32, num_coarse=8, num_fine=8, trace_frames=3,
                 frames_drawn_from=4, warmup_frames=1)
    return t


def run(cell: str, fault=None, trace: bool = False, seed: int = SEED, seconds=0.5):
    wl = manifest.workload(cell)
    tr = traffic(wl["traffic"])
    return cells.RUNNERS[tr["kind"]](cell, wl, config(wl["config"]), tr, seed, seconds,
                                     trace, "cpu", time.perf_counter(), fault=fault)
