"""Legacy checkpoints in the reference's torch format.

The classic-NeRF reference persists ``checkpoint{iter}.ckpt`` as a torch zip
pickle with keys ``iter / model_coarse_state_dict / model_fine_state_dict /
optimizer_state_dict / loss / psnr``. The port's ``FlexibleNeRF`` carries
that format's parameter names (``layer1.weight`` (out, in),
``layers_xyz.0.bias`` ...), so its state dicts go into and come out of such a
file as they are. The flax-tree mapping of the reference's own
``io/torch_compat.py`` is kept here too (kernels transposed), for the
parameter trees of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def _to_flax_name(torch_key: str):
    """'layers_xyz.0.weight' -> ('layers_xyz_0', 'kernel')."""
    parts = torch_key.split(".")
    return "_".join(parts[:-1]), {"weight": "kernel", "bias": "bias"}[parts[-1]]


def torch_state_dict_to_flax(sd: dict) -> dict:
    """Torch state dict (tensors or arrays) -> flax parameter tree
    ``{"params": {module: {"kernel", "bias"}}}`` of numpy arrays."""
    params: dict = {}
    for k, v in sd.items():
        mod, leaf = _to_flax_name(k)
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                         dtype=np.float32)
        if leaf == "kernel":
            arr = arr.T  # torch Linear stores (out, in); a flax Dense (in, out)
        params.setdefault(mod, {})[leaf] = arr
    return {"params": params}


def flax_to_torch_state_dict(params: dict) -> Dict[str, np.ndarray]:
    """Inverse of :func:`torch_state_dict_to_flax`: numpy arrays keyed by
    torch names."""
    out = {}
    for mod, leaves in params["params"].items():
        if mod.startswith("layers_xyz_") or mod.startswith("layers_dir_"):
            base, idx = mod.rsplit("_", 1)
            torch_mod = f"{base}.{idx}"
        else:
            torch_mod = mod
        for leaf, arr in leaves.items():
            arr = np.asarray(arr, dtype=np.float32)
            if leaf == "kernel":
                out[f"{torch_mod}.weight"] = arr.T
            else:
                out[f"{torch_mod}.bias"] = arr
    return out


def import_legacy_checkpoint(path) -> dict:
    """Load a reference ``checkpoint{iter}.ckpt``. Returns ``step``,
    ``state_coarse`` and ``state_fine`` (``FlexibleNeRF`` state dicts of
    f32 CPU tensors, ``state_fine`` None when the file has none), ``loss``
    and ``psnr``. The file is a pickle: load only files you trust."""
    ck = torch.load(path, map_location="cpu", weights_only=False)

    def state(sd):
        return {k: torch.as_tensor(np.asarray(v.detach().cpu().numpy()
                                              if hasattr(v, "detach") else v,
                                              dtype=np.float32))
                for k, v in sd.items()}

    return {
        "step": int(ck.get("iter", 0)),
        "state_coarse": state(ck["model_coarse_state_dict"]),
        "state_fine": (state(ck["model_fine_state_dict"])
                       if ck.get("model_fine_state_dict") else None),
        "loss": float(ck["loss"]) if ck.get("loss") is not None else None,
        "psnr": float(ck["psnr"]) if ck.get("psnr") is not None else None,
    }


def export_legacy_checkpoint(path, step: int, state_coarse: dict,
                             state_fine: Optional[dict] = None, loss=None,
                             psnr=None, optimizer_state=None) -> None:
    """Write a reference-layout checkpoint from ``FlexibleNeRF`` state dicts
    (tensors on any device)."""
    cpu = lambda sd: {k: v.detach().to("cpu", torch.float32).clone()
                      for k, v in sd.items()}
    torch.save({
        "iter": int(step),
        "model_coarse_state_dict": cpu(state_coarse),
        "model_fine_state_dict": cpu(state_fine) if state_fine is not None else None,
        "optimizer_state_dict": optimizer_state or {},
        "loss": float(loss) if loss is not None else None,
        "psnr": float(psnr) if psnr is not None else None,
    }, path)
