"""Weights and training state carried across: the reference's flax parameter
tree <-> the port's ``NGPModel`` state dict, the occupancy grid, gradient
trees, and the flattened Adam state.

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


def fused_grads_to_named(d_fused: dict, density_names, color_names) -> dict:
    """The fused kernels' gradient dict (``lines``, ``dW``, ``db`` (out, 1),
    ``cW``, ``cb``; arrays or tensors) -> {state-dict name: array}."""
    out = {"cp_lines": d_fused["lines"]}
    for names, w_key, b_key in ((density_names, "dW", "db"),
                                (color_names, "cW", "cb")):
        for n, w, b in zip(names, d_fused[w_key], d_fused[b_key]):
            out[f"{n}.kernel"] = w
            out[f"{n}.bias"] = b[:, 0]
    return out


def named_from_flax(tree: dict) -> Dict[str, np.ndarray]:
    """A flax-shaped tree of arrays (parameters, gradients or an EMA shadow)
    -> {state-dict name: f32 numpy array}."""
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def _reference_flat_order(layout):
    """Entries of a ``ParamLayout`` in the order the reference's flattened
    optimizer ravels its tree: dictionary keys sorted at every level, so
    modules alphabetically and ``bias`` before ``kernel``."""
    key = lambda e: tuple(e[0].split("."))
    return sorted(layout.entries, key=key)


def flat_from_reference(vec, layout) -> torch.Tensor:
    """A vector in the reference's flattened order (an Adam moment of its
    ``opt_state``) -> the port's flat order."""
    vec = np.asarray(vec, np.float32).reshape(-1)
    if vec.size != layout.total:
        raise ValueError(f"{vec.size} entries, the layout has {layout.total}")
    out = np.empty(layout.total, np.float32)
    pos = 0
    for _, _, off, n in _reference_flat_order(layout):
        out[off : off + n] = vec[pos : pos + n]
        pos += n
    return torch.from_numpy(out)


def flat_to_reference(flat: torch.Tensor, layout) -> np.ndarray:
    """Inverse of :func:`flat_from_reference`."""
    src = flat.detach().cpu().numpy().reshape(-1)
    return np.concatenate([src[off : off + n]
                           for _, _, off, n in _reference_flat_order(layout)])


def adam_state_from_reference(mu, nu, count, layout, device=None):
    """The reference's flattened Adam moments and count (numpy) -> the
    port's ``AdamState``."""
    from ..train.loop import AdamState

    return AdamState(
        flat_from_reference(mu, layout).to(device),
        flat_from_reference(nu, layout).to(device),
        torch.tensor(int(count), dtype=torch.int64, device=device),
    )
