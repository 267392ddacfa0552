"""The start states as plain float32 tensors, read with NumPy.

Two layouts, frozen at commit 83f8678 of this repository:

  * ``param/<flax path>`` arrays (``nerf_kinematics_tpu_torch/io/fixture.py``
    and ``io/convert.py::params_from_npz``): ``param/cp_lines`` (L, 3, T, C),
    ``param/<layer>/kernel`` (in, out), ``param/<layer>/bias`` (out,), and
    optionally ``grid/density`` (R, R, R) and ``grid/bound``;
  * the bf16 flat buffer of ``io/fixture.py::write_halo_state``:
    ``params_bf16`` holds the parameters as bf16 bit patterns (uint16) in
    the order of ``NGPModel.named_parameters()`` (``cp_lines``, then each
    density layer's kernel and bias, then each color layer's), and
    ``proj_bf16`` the grid's three pair projections (Pxy, Pxz, Pyz), whose
    visual hull is the grid.
"""

from __future__ import annotations

import numpy as np
import torch


def leaf_shapes(spec: dict):
    """(name, shape) of every leaf in parameter order, from the sizes of a
    configuration (``reference/ngp.py::model_spec``)."""
    cp = spec["cp"]
    out = [("cp_lines", (cp["n_levels"], 3, cp["table_size"], cp["n_components"]))]
    for name, (i, o) in zip(spec["density_names"], spec["density_dims"]):
        out += [(name + ".kernel", (i, o)), (name + ".bias", (o,))]
    for name, (i, o) in zip(spec["color_names"], spec["color_dims"]):
        out += [(name + ".kernel", (i, o)), (name + ".bias", (o,))]
    return out


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(bits).astype(np.uint32) << 16).view(np.float32)


def read_start(path: str, spec: dict):
    """-> ({leaf name: f32 numpy array}, grid density (R, R, R) f32 or None,
    grid bound or None)."""
    with np.load(path) as z:
        files = set(z.files)
        if "params_bf16" in files:
            flat = _bf16_bits_to_f32(z["params_bf16"])
            leaves, off = {}, 0
            for name, shape in leaf_shapes(spec):
                n = int(np.prod(shape))
                leaves[name] = flat[off:off + n].reshape(shape).copy()
                off += n
            if off != flat.size:
                raise ValueError(f"{path}: {flat.size} parameters, the layout has {off}")
            proj = _bf16_bits_to_f32(z["proj_bf16"])
            density = np.minimum(np.minimum(proj[0][:, :, None], proj[1][:, None, :]),
                                 proj[2][None, :, :])
            return leaves, np.ascontiguousarray(density), float(z["bound"])
        leaves = {}
        for name, shape in leaf_shapes(spec):
            arr = np.asarray(z["param/" + name.replace(".", "/")], np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"{path}: {name} is {arr.shape}, expected {shape}")
            leaves[name] = arr
        if "grid/density" in files:
            return leaves, np.asarray(z["grid/density"], np.float32), float(z["grid/bound"])
        return leaves, None, None


def to_torch(leaves: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device).clone()
            for k, v in leaves.items()}
