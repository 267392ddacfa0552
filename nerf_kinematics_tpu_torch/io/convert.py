"""Weights and training state carried across: the reference's flax parameter
tree <-> the port's ``NGPModel`` state dict and the classic engine's
``ClassicModel`` state dict, the occupancy grid, gradient trees, and the
flattened Adam state.

Both directions are renames and copies: f32 in, the same f32 bits out.
State-dict names follow the tree: ``cp_lines``, ``density_0.kernel``,
``density_0.bias``, ..., ``density_out.kernel``, ``color_out.bias``; kernels
keep the (in, out) layout. A tree of the reference's per-level ``cp`` encoder
(``cp_lines_0`` .. ``cp_lines_{L-1}``, each (3, T, C)) is stacked into the one
``cp_lines`` (L, 3, T, C) the port stores; the hash encoder's ``hash_table``
(L, T, F) is one leaf in both.
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
        out["hash_table"] = np.asarray(p["hash_table"], np.float32)
    elif levels:
        out["cp_lines"] = np.stack([np.asarray(p[k], np.float32) for k in levels])
    else:
        out["cp_lines"] = np.asarray(p["cp_lines"], np.float32)
    for name, leaf in p.items():
        if isinstance(leaf, dict):
            out[f"{name}.kernel"] = np.asarray(leaf["kernel"], np.float32)
            out[f"{name}.bias"] = np.asarray(leaf["bias"], np.float32)
    return {k: torch.tensor(v, device=device) for k, v in out.items()}


def params_from_npz(path: str) -> dict:
    """A flax parameter tree saved as ``param/<flax path>`` arrays of an
    ``.npz`` (``scripts/export_torch_init.py``; the fixture's parameters use
    the same keys) -> ``{"params": tree}`` of numpy arrays, for
    ``NGPEngine.load_flax_params``."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith("param/"):
                continue
            node = tree
            parts = key.split("/")[1:]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    if not tree:
        raise ValueError(f"{path}: no param/ arrays")
    return {"params": tree}


def params_to_flax(state_dict: Dict[str, torch.Tensor],
                   encoder: str = "cp_pallas") -> dict:
    """Inverse of :func:`params_from_flax`: ``{"params": {...}}`` of numpy
    arrays. ``encoder="cp"`` splits the CP table into the per-level leaves;
    ``"cp_pallas"`` and ``"hash"`` keep the encoder's table one leaf."""
    if encoder not in ("cp", "cp_pallas", "hash"):
        raise ValueError(f"unknown encoder {encoder!r}")
    p: dict = {}
    for key, t in state_dict.items():
        arr = t.detach().cpu().numpy()
        if key == "cp_lines" and encoder == "cp":
            for l in range(arr.shape[0]):
                p[f"cp_lines_{l}"] = arr[l]
        elif key in ("cp_lines", "hash_table"):
            p[key] = arr
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


def _reference_path(name: str):
    """A port parameter name -> the reference's tree path. NGP names are the
    tree's (``density_0.kernel``); a torch ``Linear`` of the classic engine
    (``coarse.layers_xyz.0.weight``) is a dense layer of the reference
    (``coarse / layers_xyz_0 / kernel``)."""
    parts = name.split(".")
    if parts[0] not in ("coarse", "fine"):
        return tuple(parts)
    leaf = "kernel" if parts[-1] == "weight" else parts[-1]
    return (parts[0], "_".join(parts[1:-1]), leaf)


def _reference_flat_order(layout):
    """Entries of a ``ParamLayout`` in the order the reference's flattened
    optimizer ravels its tree: dictionary keys sorted at every level, so
    coarse before fine, modules alphabetically and ``bias`` before
    ``kernel``."""
    return sorted(layout.entries, key=lambda e: _reference_path(e[0]))


def _is_linear_weight(name: str) -> bool:
    # the port keeps a torch Linear's (out, in); the reference ravels (in, out)
    return name.endswith(".weight")


def flat_from_reference(vec, layout) -> torch.Tensor:
    """A vector in the reference's flattened order (an Adam moment of its
    ``opt_state``) -> the port's flat order."""
    vec = np.asarray(vec, np.float32).reshape(-1)
    if vec.size != layout.total:
        raise ValueError(f"{vec.size} entries, the layout has {layout.total}")
    out = np.empty(layout.total, np.float32)
    pos = 0
    for name, shape, off, n in _reference_flat_order(layout):
        part = vec[pos : pos + n]
        if _is_linear_weight(name):
            part = part.reshape(shape[::-1]).T.reshape(-1)
        out[off : off + n] = part
        pos += n
    return torch.from_numpy(out)


def flat_to_reference(flat: torch.Tensor, layout) -> np.ndarray:
    """Inverse of :func:`flat_from_reference`."""
    src = flat.detach().cpu().numpy().reshape(-1)
    parts = []
    for name, shape, off, n in _reference_flat_order(layout):
        part = src[off : off + n]
        if _is_linear_weight(name):
            part = part.reshape(shape).T.reshape(-1)
        parts.append(part)
    return np.concatenate(parts)


def adam_state_from_reference(mu, nu, count, layout, device=None):
    """The reference's flattened Adam moments and count (numpy) -> the
    port's ``AdamState``."""
    from ..train.loop import AdamState

    return AdamState(
        flat_from_reference(mu, layout).to(device),
        flat_from_reference(nu, layout).to(device),
        torch.tensor(int(count), dtype=torch.int64, device=device),
    )


# ------------------------------------------------------------ classic engine

def classic_params_from_flax(tree: dict, device=None) -> Dict[str, torch.Tensor]:
    """The reference classic engine's ``{"coarse": tree, "fine": tree}``
    (parameters or gradients; each tree ``{"params": {...}}`` or the inner
    dict) -> the state dict of ``ClassicModel``: ``coarse.layer1.weight``
    (out, in) from ``coarse/layer1/kernel`` (in, out), and so on."""
    from .torch_compat import flax_to_torch_state_dict

    out = {}
    for net in ("coarse", "fine"):
        if tree.get(net) is None:
            continue
        sub = tree[net]
        sub = sub if "params" in sub and isinstance(sub["params"], dict) \
            else {"params": sub}
        for k, v in flax_to_torch_state_dict(sub).items():
            out[f"{net}.{k}"] = torch.tensor(np.asarray(v, np.float32),
                                             device=device)
    return out


def classic_params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`classic_params_from_flax`: ``{"coarse": {"params":
    ...}, "fine": ...}`` of numpy arrays."""
    from .torch_compat import torch_state_dict_to_flax

    out = {}
    for net in ("coarse", "fine"):
        sub = {k[len(net) + 1:]: v for k, v in state_dict.items()
               if k.startswith(net + ".")}
        if sub:
            out[net] = torch_state_dict_to_flax(sub)
    return out


def classic_named_from_flax(tree: dict) -> Dict[str, np.ndarray]:
    """A classic ``{"coarse", "fine"}`` tree of arrays (parameters, gradients
    or an EMA shadow) -> {state-dict name: f32 numpy array}."""
    return {k: v.numpy() for k, v in classic_params_from_flax(tree).items()}
