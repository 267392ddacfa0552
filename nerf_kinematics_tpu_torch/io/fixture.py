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
import torch

from ..data.types import Intrinsics
from ..ops.occupancy import OccupancyGrid, pair_projections
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


# configs/fox_ngp.yml's ``ngp.fused: off`` route trained on the card for
# chip_smoke.py's ``halo`` phase (scripts/torch_halo_witness.py record).
HALO_FOX_UNFUSED = os.path.join(FIXTURE_DIR, "halo_fox_unfused_1000.npz")


def _bf16_bits(t) -> np.ndarray:
    t = torch.as_tensor(t, dtype=torch.float32).detach().cpu()
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _from_bf16_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16).to(torch.float32)


def write_halo_state(path: str, params, density, bound: float, **extra) -> None:
    """A trained state of a bf16 fast-engine model, small enough to commit:
    the flat parameters rounded to bf16 (the bf16 route's forward reads
    every weight and table entry through that rounding, so its renders and
    its next step's forward are unchanged) and the grid's three pair
    projections rounded to bf16 (all the hull proposal reads, and it reads
    them so rounded). ``extra``: numpy arrays or JSON strings kept beside."""
    grid = OccupancyGrid(torch.as_tensor(density, dtype=torch.float32).cpu(),
                         torch.tensor(float(bound)))
    arrays = {"params_bf16": _bf16_bits(params),
              "proj_bf16": _bf16_bits(pair_projections(grid)),
              "bound": np.asarray(float(bound), np.float32)}
    arrays.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(path, **arrays)


def read_halo_state(path: str = HALO_FOX_UNFUSED, device=None) -> dict:
    """:func:`write_halo_state`'s file -> {"params": (P,) f32, "grid": the
    visual hull of the stored projections (its pair projections are those
    projections exactly), and every other array as stored}."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    proj = _from_bf16_bits(out.pop("proj_bf16"))
    density = torch.minimum(torch.minimum(proj[0][:, :, None], proj[1][:, None, :]),
                            proj[2][None, :, :])
    out["params"] = _from_bf16_bits(out.pop("params_bf16")).to(device)
    out["grid"] = OccupancyGrid(density.contiguous().to(device),
                                torch.tensor(float(out.pop("bound")), device=device))
    return out
