"""The one generator of the benchmark's traffic, driven by a traffic file.

Two kinds:

  * ``train``: the training loop fed by the program's own ray sampler, whose
    draws come from ``--seed`` (the pixel buffer's permutation and the step
    generator); the file gives how many first steps are checked and how
    many chunks the traced run records.
  * ``viewer``: a closed loop of one client asking for frames along an
    orbit at a fixed elevation, the same angular step every frame, from a
    start azimuth drawn from ``--seed``: every seed asks for the same
    poses, in another order.
"""

from __future__ import annotations

import math

import numpy as np

from .scene import look_at_np, on_sphere


class Orbit:
    def __init__(self, spec: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.start = rng.uniform(0.0, 2.0 * math.pi)
        self.elev = math.radians(spec["elevation_deg"])
        self.step = math.radians(spec["degrees_per_frame"])
        self.radius = spec["radius"]

    def pose(self, i: int) -> np.ndarray:
        azim = np.array([self.start + i * self.step])
        return look_at_np(on_sphere(self.radius, self.elev, azim),
                          np.zeros(3)).astype(np.float32)[0]


def sample_indices(seed: int, n: int, high: int) -> list:
    """``n`` distinct frame indices below ``high``, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return sorted(int(i) for i in rng.choice(high, size=min(n, high), replace=False))


def derived_seed(seed: int, salt: int) -> int:
    """A second seed from ``seed`` for draws the benchmark makes itself."""
    return int(np.random.default_rng([seed, salt]).integers(0, 2**62))
