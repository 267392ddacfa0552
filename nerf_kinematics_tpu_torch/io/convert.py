"""Weights carried across: the reference's flax parameter tree <-> the port's
``NGPModel`` state dict, and the occupancy grid.

Both directions are renames and copies: f32 in, the same f32 bits out.
State-dict names follow the tree: ``cp_lines``, ``density_0.kernel``,
``density_0.bias``, ..., ``density_out.kernel``, ``color_out.bias``; kernels
keep the (in, out) layout. A tree of the reference's per-level ``cp`` encoder
(``cp_lines_0`` .. ``cp_lines_{L-1}``, each (3, T, C)) is stacked into the one
``cp_lines`` (L, 3, T, C) the port stores.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..ops.occupancy import OccupancyGrid


def _inner(tree: dict) -> dict:
    return tree["params"] if "params" in tree and isinstance(tree["params"], dict) else tree


def params_from_flax(tree: dict, device=None) -> Dict[str, torch.Tensor]:
    """Flax parameter tree of numpy arrays (``{"params": {...}}`` or the
    inner dict) -> state dict for ``NGPModel.load_state_dict``."""
    p = _inner(tree)
    out = {}
    levels = sorted(
        (k for k in p if re.fullmatch(r"cp_lines_\d+", k)),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    if "hash_table" in p:
        raise NotImplementedError("encoder: hash is not ported yet")
    if levels:
        out["cp_lines"] = np.stack([np.asarray(p[k], np.float32) for k in levels])
    else:
        out["cp_lines"] = np.asarray(p["cp_lines"], np.float32)
    for name, leaf in p.items():
        if isinstance(leaf, dict):
            out[f"{name}.kernel"] = np.asarray(leaf["kernel"], np.float32)
            out[f"{name}.bias"] = np.asarray(leaf["bias"], np.float32)
    return {k: torch.tensor(v, device=device) for k, v in out.items()}


def params_to_flax(state_dict: Dict[str, torch.Tensor],
                   encoder: str = "cp_pallas") -> dict:
    """Inverse of :func:`params_from_flax`: ``{"params": {...}}`` of numpy
    arrays. ``encoder="cp"`` splits the table into the per-level leaves."""
    p: dict = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if key == "cp_lines":
            if encoder == "cp":
                for l in range(arr.shape[0]):
                    p[f"cp_lines_{l}"] = arr[l]
            else:
                p["cp_lines"] = arr
        else:
            name, leaf = key.rsplit(".", 1)
            p.setdefault(name, {})[leaf] = arr
    return {"params": p}


def grid_from_numpy(density, bound, device=None) -> OccupancyGrid:
    """(R, R, R) densities indexed [x, y, z] and the scalar bound -> grid."""
    return OccupancyGrid(
        density=torch.tensor(np.asarray(density, np.float32), device=device),
        bound=torch.tensor(float(np.asarray(bound)), dtype=torch.float32,
                           device=device),
    )
