"""One ``.npz`` holding a trained fast-engine model for the port: parameters,
occupancy grid, configuration (JSON), intrinsics, poses, step and, when the
reference package wrote it, a small set of golden renders.

Keys (``scripts/export_torch_fixture.py`` writes the same layout from the
reference package's checkpoint):

    param/<flax path>      f32   e.g. param/cp_lines, param/density_0/kernel
    grid/density, grid/bound
    config_json            str   train/config.py::config_to_json
    intrinsics             f64   [fl_x, fl_y, cx, cy, width, height]
    poses                  f32   (P, 4, 4)
    step                   i64
    golden/...                   intrinsics, pose indices, rgb / acc images
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..data.types import Intrinsics
from .convert import params_from_npz
from ..train.config import Config, config_from_json, config_to_json

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fixtures"
)
MACHINA_NGP = os.path.join(FIXTURE_DIR, "machina_ngp_10000.npz")
# The JAX package's NGPEngine(machina_ngp).init_state(42) parameters: the
# weights its canonical run started from (scripts/export_torch_init.py;
# io/convert.py::params_from_npz reads them).
MACHINA_NGP_INIT42 = os.path.join(FIXTURE_DIR, "machina_ngp_init42.npz")


@dataclass
class Fixture:
    params: dict  # {"params": flax-shaped tree of numpy arrays}
    grid_density: Optional[np.ndarray]
    grid_bound: Optional[float]
    config: Config
    intrinsics: Intrinsics
    poses: np.ndarray
    step: int
    golden: Dict[str, np.ndarray] = field(default_factory=dict)


def _intrinsics_row(intr: Intrinsics) -> np.ndarray:
    return np.array([intr.fl_x, intr.fl_y, intr.cx, intr.cy,
                     intr.width, intr.height], np.float64)


def intrinsics_from_row(row) -> Intrinsics:
    fl_x, fl_y, cx, cy, w, h = (float(v) for v in row)
    return Intrinsics(fl_x=fl_x, fl_y=fl_y, cx=cx, cy=cy,
                      width=int(w), height=int(h))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def write_fixture(path: str, fx: Fixture) -> None:
    inner = fx.params["params"] if "params" in fx.params else fx.params
    arrays = {f"param/{k}": v for k, v in _flatten(inner).items()}
    if fx.grid_density is not None:
        arrays["grid/density"] = np.asarray(fx.grid_density, np.float32)
        arrays["grid/bound"] = np.asarray(fx.grid_bound, np.float32)
    arrays["config_json"] = np.asarray(config_to_json(fx.config))
    arrays["intrinsics"] = _intrinsics_row(fx.intrinsics)
    arrays["poses"] = np.asarray(fx.poses, np.float32)
    arrays["step"] = np.asarray(int(fx.step), np.int64)
    for k, v in fx.golden.items():
        arrays[f"golden/{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def read_fixture(path: str = MACHINA_NGP) -> Fixture:
    params = params_from_npz(path)
    with np.load(path) as z:
        golden = {key[len("golden/"):]: z[key] for key in z.files
                  if key.startswith("golden/")}
        has_grid = "grid/density" in z.files
        return Fixture(
            params=params,
            grid_density=z["grid/density"] if has_grid else None,
            grid_bound=float(z["grid/bound"]) if has_grid else None,
            config=config_from_json(str(z["config_json"])),
            intrinsics=intrinsics_from_row(z["intrinsics"]),
            poses=z["poses"],
            step=int(z["step"]),
            golden=golden,
        )
