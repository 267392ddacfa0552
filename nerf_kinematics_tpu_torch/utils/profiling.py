"""Profiling and throughput: ``device_trace``, a ``torch.profiler`` trace of
the host and the GPU written as a Chrome trace into a directory, and
``ThroughputMeter``, a sliding-window rays/s and steps/s counter.

Counterpart of ``nerf_kinematics_tpu/utils/profiling.py`` (``jax.profiler``
there).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the block with ``torch.profiler`` (CPU, and CUDA when a GPU is
    there) into ``logdir/trace.json`` (open in Perfetto or
    chrome://tracing). Yields the profiler, whose ``key_averages()`` holds
    the per-kernel times."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class ThroughputMeter:
    """Sliding-window rays/s (and steps/s) counter."""

    window: int = 50
    _times: List[float] = field(default_factory=list)
    _rays: List[int] = field(default_factory=list)

    def tick(self, n_rays: int) -> None:
        self._times.append(time.perf_counter())
        self._rays.append(n_rays)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._rays.pop(0)

    @property
    def rays_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return sum(self._rays[1:]) / max(dt, 1e-9)

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / max(dt, 1e-9)
