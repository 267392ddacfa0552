#!/usr/bin/env python
"""Save the JAX package's initial weights of a fast-engine configuration for
the PyTorch port: ``NGPEngine(cfg).init_state(seed)`` (the weights the
JAX trainer starts from) as one compressed ``.npz`` of the flax parameter
tree, f32, keys ``param/<flax path>`` (``param/cp_lines``,
``param/density_0/kernel``, ...). The port reads it with
``nerf_kinematics_tpu_torch/io/convert.py::params_from_npz``, so that a run on
the card starts from the weights the canonical JAX run started from.

    JAX_PLATFORMS=cpu python scripts/export_torch_init.py \
        --config configs/machina_ngp.yml --seed 42 \
        --out nerf_kinematics_tpu_torch/fixtures/machina_ngp_init42.npz
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/machina_ngp.yml")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=(
        "nerf_kinematics_tpu_torch/fixtures/machina_ngp_init42.npz"))
    args = ap.parse_args(argv)

    from nerf_kinematics_tpu.train.config import load_config
    from nerf_kinematics_tpu.train.ngp_engine import NGPEngine

    cfg = load_config(args.config)
    state = NGPEngine(cfg, scene_bound=1.0).init_state(args.seed)
    arrays = {f"param/{k}": v
              for k, v in _flatten(state.params["coarse"]["params"]).items()}
    arrays["seed"] = np.asarray(args.seed, np.int64)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    n = sum(v.size for k, v in arrays.items() if k.startswith("param/"))
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"{n} parameters, seed {args.seed}")


if __name__ == "__main__":
    main()
