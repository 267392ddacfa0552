#!/usr/bin/env python
"""Export a trained fast-engine checkpoint as the PyTorch port's fixture.

Restores an orbax checkpoint of the JAX package on the CPU, renders a small
"golden" image set with the JAX package itself (Pallas kernels in interpret
mode), and writes everything the PyTorch port needs into one compressed
``.npz``: the flax parameter tree (f32), the occupancy grid (f32), the config
as JSON, the camera intrinsics, the orbit poses, the step, and the golden
images (f16).

    JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
        --config configs/machina_ngp.yml \
        --checkpoint logs/machina-ngp/checkpoints --step 10000 \
        --out nerf_kinematics_tpu_torch/fixtures/machina_ngp_10000.npz

The saved checkpoint's sharding file names the accelerator that wrote it, so
a plain restore fails on another backend; every leaf is therefore restored
into a ``ShapeDtypeStruct`` pinned to the first local device.

File layout (keys of the ``.npz``; ``io/fixture.py`` of the port reads it):

    param/<flax path>      f32   e.g. param/cp_lines, param/density_0/kernel
    grid/density           f32   (R, R, R), indexed [x, y, z]
    grid/bound             f32   ()
    config_json            str   config_to_dict(cfg) + "engine", "ngp" and the
                                 two nerf fields it leaves out
    intrinsics             f64   [fl_x, fl_y, cx, cy, width, height]
    poses                  f32   (P, 4, 4) orbit camera-to-world matrices
    step                   i64   ()
    golden/intrinsics      f64   as above, at the golden size
    golden/fast_pose_idx   i64   (G,) rows of ``poses`` rendered by (a)
    golden/fast_rgb, golden/fast_acc    f16  (G, h, w, 3) / (G, h, w)
    golden/eval_pose_idx   i64   (G,) rows of ``poses`` rendered by (b)
    golden/eval_rgb, golden/eval_acc    f16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

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
    ap.add_argument("--checkpoint", default="logs/machina-ngp/checkpoints")
    ap.add_argument("--step", type=int, default=10000)
    ap.add_argument("--out", default=(
        "nerf_kinematics_tpu_torch/fixtures/machina_ngp_10000.npz"))
    ap.add_argument("--size", type=int, default=400,
                    help="full image size the intrinsics describe")
    ap.add_argument("--golden-size", type=int, default=100)
    ap.add_argument("--n-poses", type=int, default=4)
    ap.add_argument("--fast-poses", type=int, nargs="*", default=[0, 2])
    ap.add_argument("--eval-poses", type=int, nargs="*", default=[1, 3])
    args = ap.parse_args(argv)

    import jax
    import orbax.checkpoint as ocp

    from nerf_kinematics_tpu.data.machina import CAMERA_ANGLE_X, orbit_poses
    from nerf_kinematics_tpu.data.types import Intrinsics
    from nerf_kinematics_tpu.train.config import config_to_dict, load_config
    from nerf_kinematics_tpu.train.loop import eval_params
    from nerf_kinematics_tpu.train.ngp_engine import NGPEngine

    cfg = load_config(args.config)
    engine = NGPEngine(cfg, scene_bound=1.0)
    template = engine.init_state()
    device = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    abstract = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(np.shape(x), x.dtype, sharding=device),
        template,
    )
    mgr = ocp.CheckpointManager(os.path.abspath(args.checkpoint))
    state = mgr.restore(
        args.step, args=ocp.args.StandardRestore({"state": abstract})
    )["state"]
    params = eval_params(state)
    aux = state.aux

    def intrinsics_at(size):
        focal = 0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)
        return Intrinsics(fl_x=focal, fl_y=focal, cx=size / 2.0, cy=size / 2.0,
                          width=size, height=size)

    def as_row(intr):
        return np.array([intr.fl_x, intr.fl_y, intr.cx, intr.cy,
                         intr.width, intr.height], np.float64)

    poses = orbit_poses(args.n_poses)
    near, far = cfg.dataset.near, cfg.dataset.far
    g_intr = intrinsics_at(args.golden_size)

    fast = engine.make_fast_render_fn(g_intr, near, far, False)
    full = engine.make_render_fn(g_intr, near, far, False)
    golden = {}
    for name, fn, idx in (("fast", fast, args.fast_poses),
                          ("eval", full, args.eval_poses)):
        rgbs, accs = [], []
        for i in idx:
            t0 = time.perf_counter()
            out = fn(params, jax.numpy.asarray(poses[i]), aux)
            rgbs.append(np.asarray(out["rgb"]))
            accs.append(np.asarray(out["acc"]))
            print(f"golden {name} pose {i}: {time.perf_counter() - t0:.1f} s, "
                  f"mean acc {accs[-1].mean():.4f}", flush=True)
        golden[f"golden/{name}_pose_idx"] = np.asarray(idx, np.int64)
        golden[f"golden/{name}_rgb"] = np.stack(rgbs).astype(np.float16)
        golden[f"golden/{name}_acc"] = np.stack(accs).astype(np.float16)

    config = config_to_dict(cfg)
    config["nerf"]["coarse_loss_weight"] = cfg.nerf.coarse_loss_weight
    config["nerf"]["ema_decay"] = cfg.nerf.ema_decay
    config["engine"] = cfg.engine
    config["ngp"] = dataclasses.asdict(cfg.ngp)

    arrays = {f"param/{k}": v
              for k, v in _flatten(params["coarse"]["params"]).items()}
    arrays["grid/density"] = np.asarray(aux.density, np.float32)
    arrays["grid/bound"] = np.asarray(aux.bound, np.float32)
    arrays["config_json"] = np.asarray(json.dumps(config, sort_keys=True))
    arrays["intrinsics"] = as_row(intrinsics_at(args.size))
    arrays["poses"] = np.asarray(poses, np.float32)
    arrays["step"] = np.asarray(int(state.step), np.int64)
    arrays["golden/intrinsics"] = as_row(g_intr)
    arrays.update(golden)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"{len(arrays)} arrays, step {int(state.step)}")


if __name__ == "__main__":
    main()
