#!/usr/bin/env python3
"""Where ``configs/fox_ngp.yml`` ends on the halo scene, the JAX package
beside the port, both on the CPU: the witness for the halo scene's low
held-out views (ROADMAP C.1).

Each framework makes the halo scene with its own
``make_synthetic_scene(variant="halo")`` (the last two views held out),
starts from the JAX engine's ``init_state(seed)`` weights (the port takes
them through ``load_flax_params``), draws its own rays and trains with the
occupancy refreshes of its trainer (a full sweep at the first refresh and
every ``occ_full_every`` steps, the incremental refresh between), on each
route named:

- ``unfused``: ``ngp.fused: off`` (the CP encoder under autograd);
- ``hash``: ``ngp.encoder: hash``.

For each framework and route it prints the mean train loss of every
``--every`` steps, the held-out PSNR (mean and view 0), and the share of a
64^3 density grid over the scene box above ``--thresh`` (2.5, the mesh
export's ``--marching_cubes_density_thresh``). Prints one JSON object.

    JAX_PLATFORMS=cpu python3 scripts/torch_halo_witness.py
    JAX_PLATFORMS=cpu python3 scripts/torch_halo_witness.py --routes hash --steps 200

Cuts against ``chip_smoke.py``'s ``halo`` phase (49 views of 128^2, 16384
rays a step, 1000 steps, refreshes every 256 steps): ``--views``,
``--size``, ``--rays``, ``--steps``; the refresh schedule is the YAML's
scaled by steps / 1000 (``--steps 1000`` keeps it as the card runs it).
The widths are the YAML's (CP L 5, C 96, T 256; the hash grid L 8, F 4,
T 2^19; 64-wide MLPs).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = {"unfused": {"fused": "off"}, "hash": {"encoder": "hash"}}


def fox_raw() -> dict:
    from nerf_kinematics_tpu_torch.train.config import parse_yaml

    with open(os.path.join(ROOT, "configs", "fox_ngp.yml")) as f:
        return parse_yaml(f.read())


def route_raw(raw: dict, route: str, steps: int, rays: int,
              card_steps: int = 1000) -> dict:
    """The YAML with the route's switch, ``rays`` a step and its refresh
    schedule scaled from ``card_steps`` to ``steps``."""
    raw = copy.deepcopy(raw)
    ngp = raw["ngp"]
    ngp.update(ROUTES[route])
    scale = steps / card_steps
    ngp["occ_update_every"] = max(1, round(ngp.get("occ_update_every", 256) * scale))
    ngp["occ_full_every"] = max(1, round(ngp.get("occ_full_every", 2048) * scale))
    raw["nerf"]["train"]["num_random_rays"] = rays
    return raw


def _psnr(pred, gt) -> float:
    return float(-10.0 * np.log10(np.mean((np.asarray(pred, np.float64) - gt) ** 2)))


def _refresh(it: int, every: int, full_every: int):
    """None, or whether the refresh after step ``it`` is a full sweep: the
    trainers' rule, one step at a time."""
    if it % every:
        return None
    return it == every or it % full_every == 0


def _summary(losses, every, val, grid, thresh, seconds) -> dict:
    losses = np.asarray(losses, np.float64)
    return {
        "loss_by_window": [float(losses[i:i + every].mean())
                           for i in range(0, len(losses), every)],
        "val_psnr_db": val,
        "val_mean_psnr_db": float(np.mean(val)),
        "val0_psnr_db": val[0],
        "grid_share_above_thresh": float((np.asarray(grid) > thresh).mean()),
        "seconds": seconds,
    }


def run_jax(raw: dict, views: int, size: int, steps: int, seed: int, every: int,
            thresh: float, grid_res: int = 64):
    """The JAX engine's run; returns (summary, its initial weights)."""
    import jax
    import jax.numpy as jnp

    from nerf_kinematics_tpu.data import make_synthetic_scene
    from nerf_kinematics_tpu.train import config as jcfg
    from nerf_kinematics_tpu.train.loop import build_shuffled_ray_buffer, eval_params
    from nerf_kinematics_tpu.train.ngp_engine import NGPEngine

    t0 = time.perf_counter()
    ds = make_synthetic_scene(n_views=views, resolution=size, variant="halo")
    cfg = jcfg.config_from_dict(raw)
    eng = NGPEngine(cfg, scene_bound=ds.aabb_scale / 2.0)
    state = eng.init_state(seed)
    weights = jax.tree_util.tree_map(np.array, state.params["coarse"])
    buf = build_shuffled_ray_buffer(jnp.asarray(ds.images[ds.train_idx]),
                                    jnp.asarray(ds.poses[ds.train_idx]),
                                    ds.intrinsics, seed=seed)
    step = eng.make_train_step(ds.intrinsics, ds.near, ds.far, False, donate=False)
    ngp = eng.ngp_config
    losses = []
    for it in range(1, steps + 1):
        state, m = step(state, None, None, buf)
        losses.append(float(m["loss"]))
        full = _refresh(it, ngp.occ_update_every, ngp.occ_full_every)
        if full is not None:
            state = eng.update_occupancy(state, full=full)
    render = eng.make_render_fn(ds.intrinsics, ds.near, ds.far, False)
    params = eval_params(state)
    val = [_psnr(render(params, jnp.asarray(ds.poses[int(i)]), state.aux)["rgb"],
                 ds.images[int(i)]) for i in ds.val_idx]
    grid = np.asarray(eng.density_grid(params, resolution=grid_res))
    return _summary(losses, every, val, grid, thresh, time.perf_counter() - t0), weights


def run_port(raw: dict, weights, views: int, size: int, steps: int, seed: int,
             every: int, thresh: float, grid_res: int = 64) -> dict:
    """The port's run on the CPU from the JAX engine's weights."""
    import torch

    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.train import config as tcfg
    from nerf_kinematics_tpu_torch.train.loop import build_shuffled_ray_buffer, eval_params
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    t0 = time.perf_counter()
    ds = make_synthetic_scene(n_views=views, resolution=size, variant="halo",
                              device="cpu")
    eng = NGPEngine(tcfg.config_from_dict(raw), scene_bound=ds.aabb_scale / 2.0,
                    device="cpu")
    eng.load_flax_params(weights)
    state = eng.init_state(seed=seed, keep_weights=True)
    buf = build_shuffled_ray_buffer(torch.as_tensor(ds.images[ds.train_idx]),
                                    torch.as_tensor(ds.poses[ds.train_idx]),
                                    ds.intrinsics, seed=seed)
    step = eng.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    ngp = eng.ngp_config
    losses = []
    for it in range(1, steps + 1):
        state, m = step(state, None, None, buf)
        losses.append(float(m["loss"]))
        full = _refresh(it, ngp.occ_update_every, ngp.occ_full_every)
        if full is not None:
            state = eng.update_occupancy(state, full=full)
    render = eng.make_render_fn(ds.intrinsics, ds.near, ds.far, False)
    with torch.no_grad(), eng.bound(eval_params(state)):
        val = [_psnr(render(torch.as_tensor(ds.poses[int(i)]), state.aux)["rgb"].numpy(),
                     ds.images[int(i)]) for i in ds.val_idx]
        grid = eng.density_grid(resolution=grid_res).numpy()
    return _summary(losses, every, val, grid, thresh, time.perf_counter() - t0)


def witness(raw: dict, views: int, size: int, steps: int, seed: int, every: int,
            thresh: float, grid_res: int = 64) -> dict:
    """Both frameworks on one configuration; ``gap_db`` is JAX's held-out
    mean PSNR less the port's."""
    jax_out, weights = run_jax(raw, views, size, steps, seed, every, thresh, grid_res)
    port_out = run_port(raw, weights, views, size, steps, seed, every, thresh, grid_res)
    return {"jax": jax_out, "port": port_out,
            "gap_db": jax_out["val_mean_psnr_db"] - port_out["val_mean_psnr_db"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", default="unfused,hash")
    ap.add_argument("--views", type=int, default=25)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--thresh", type=float, default=2.5)
    args = ap.parse_args(argv)
    import torch

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    base = fox_raw()
    report = {"cuts": {"views": args.views, "size": args.size, "rays": args.rays,
                       "steps": args.steps, "card": "49 views of 128^2, 16384 rays, "
                       "1000 steps"}, "seed": args.seed, "thresh": args.thresh}
    for route in args.routes.split(","):
        raw = route_raw(base, route, args.steps, args.rays)
        report[route] = witness(raw, args.views, args.size, args.steps, args.seed,
                                args.every, args.thresh)
        report[route]["refresh"] = {k: raw["ngp"][k] for k in
                                    ("occ_update_every", "occ_full_every")}
        print(json.dumps({route: report[route]}), file=sys.stderr, flush=True)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
