"""Worker for tests/test_torch_parallel.py and tests/test_torch_multihost.py:
one rank of a ``gloo`` process group on the CPU, running the scenarios a
JSON spec names and writing each one's arrays to ``<out_dir>/rank<r>.npz``.

    python _torch_mesh_worker.py <port> <rank> <world> <spec.json> <out_dir>

The parent tests import :data:`SCENARIOS` and run the same functions in
their own process without a mesh, as the single-device baseline.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLASSIC_RAW = {
    "models": {"coarse": {"hidden_size": 32, "num_encoding_fn_xyz": 4,
                          "num_encoding_fn_dir": 2}},
    "nerf": {"train": {"num_coarse": 16, "num_fine": 0, "num_random_rays": 256},
             "validation": {"num_coarse": 16, "num_fine": 0, "perturb": False}},
    "experiment": {"randomseed": 0},
}

NGP_HULL_RAW = {
    "engine": "ngp",
    "ngp": {"encoder": "cp", "fused": "off", "n_levels": 2, "n_components": 8,
            "base_resolution": 4, "max_resolution": 16, "table_size": 32,
            "cp": {"use_bf16": False}, "use_occupancy": True, "occ_resolution": 16,
            "occ_update_every": 8, "occ_full_every": 100,
            "occ_incremental_cells": 512, "occ_proposal": "hull"},
    "nerf": {"train": {"num_coarse": 8, "num_fine": 8, "pixel_sampler": "shuffled",
                       "num_random_rays": 128},
             "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False}},
    "experiment": {"id": "mesh-ngp", "print_every": 8, "validate_every": 24,
                   "save_every": 0, "train_iters": 24},
}

NGP_FUSED_RAW = {
    "engine": "ngp",
    "ngp": {"encoder": "cp_pallas", "n_levels": 2, "n_components": 8,
            "base_resolution": 8, "max_resolution": 32, "table_size": 32,
            "density_width": 16, "density_out": 16, "color_width": 16,
            "color_layers": 2, "use_occupancy": True, "occ_resolution": 16,
            "occ_bins": 8},
    "nerf": {"train": {"num_coarse": 8, "num_fine": 8, "num_random_rays": 256},
             "validation": {"num_coarse": 8, "num_fine": 8, "perturb": False},
             "coarse_loss_weight": 0.0},
    "experiment": {"id": "host-local", "print_every": 0, "validate_every": 0,
                   "save_every": 2, "train_iters": 2},
    "optimizer": {"lr": 0.01},
}


def scene():
    """The port's synthetic sphere: 6 views of 16^2, the last two held out."""
    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(n_views=6, resolution=16, device="cpu")


def config(raw: dict, logdir: str = None):
    from nerf_kinematics_tpu_torch.train.config import config_from_dict

    raw = json.loads(json.dumps(raw))
    ds = raw.setdefault("dataset", {})
    ds.setdefault("near", 2.0 if raw.get("engine") == "ngp" else 0.5)
    ds.setdefault("far", 6.0 if raw.get("engine") == "ngp" else 3.5)
    if logdir is not None:
        raw["experiment"]["logdir"] = logdir
    return config_from_dict(raw)


def _train_tensors(ds):
    import torch

    imgs, poses = ds.split("train")
    return torch.as_tensor(imgs), torch.as_tensor(poses)


def classic_step(spec, mesh, rank):
    """One classic step from the spec's weights with its global draws."""
    import numpy as np
    import torch

    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    ds = scene()
    eng = ClassicNerf(config(CLASSIC_RAW), device="cpu", mesh=mesh)
    state = eng.init_state()
    z = np.load(spec["inputs"])
    state.params.copy_(torch.from_numpy(z["classic_params0"]))
    images, poses = _train_tensors(ds)
    step = eng.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    state, m = step(state, images, poses, pixels=list(z["classic_pixels"]),
                    u_coarse=torch.from_numpy(z["classic_u_coarse"]))
    return {"classic_step_loss": np.float64(m["loss"]),
            "classic_step_params": state.params.numpy().copy(),
            "classic_step_mu": state.opt_state.mu.numpy().copy()}


def classic_fit(spec, mesh, rank):
    """40 classic steps from seed 0 with the generator's draws."""
    import numpy as np

    from nerf_kinematics_tpu_torch.train.loop import ClassicNerf

    ds = scene()
    eng = ClassicNerf(config(CLASSIC_RAW), device="cpu", mesh=mesh)
    state = eng.init_state(0)
    images, poses = _train_tensors(ds)
    step = eng.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    losses = []
    for _ in range(40):
        state, m = step(state, images, poses)
        losses.append(float(m["loss"]))
    return {"classic_fit_losses": np.asarray(losses),
            "classic_fit_params": state.params.numpy().copy()}


def ngp_fit(spec, mesh, rank):
    """``Trainer.fit`` of the NGP hull config: 24 shuffled-sampler steps, a
    full refresh at 8 and incremental ones at 16 and 24, validation."""
    import numpy as np

    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    tr = Trainer(config(NGP_HULL_RAW, spec["ngp_logdir"]), dataset=scene(),
                 device="cpu", use_mesh=mesh is not None)
    assert (tr.mesh is None) == (mesh is None)
    res = tr.fit()
    tr.close()
    return {"ngp_fit_losses": np.asarray(res.losses),
            "ngp_fit_params": res.state.params.numpy().copy(),
            "ngp_fit_grid": res.state.aux.density.numpy().copy(),
            "ngp_fit_val_psnr": np.float64(np.nan if res.val_psnr is None
                                           else res.val_psnr),
            "ngp_fit_refreshes": np.asarray([[i, k == "full"] for i, k, _ in
                                             res.occupancy_refreshes])}


def serve(spec, mesh, rank):
    """``make_fast_render_batch`` of four frames from seeded weights and a
    seeded grid."""
    import numpy as np
    import torch

    from nerf_kinematics_tpu_torch.io.convert import grid_from_numpy
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    ds = scene()
    eng = NGPEngine(config(NGP_FUSED_RAW), 1.0, device="cpu", mesh=mesh)
    state = eng.init_state(3)
    rng = np.random.default_rng(4)
    grid = grid_from_numpy(rng.gamma(0.5, 4.0, (16, 16, 16)).astype(np.float32), 1.0)
    c2ws = torch.as_tensor(ds.poses[:4])
    batch = eng.make_fast_render_batch(ds.intrinsics, ds.near, ds.far)
    with torch.no_grad(), eng.bound(state.params):
        out = batch(c2ws, grid)
    return {f"serve_{k}": v.numpy().copy() for k, v in out.items()}


def host_local(spec, mesh, rank):
    """Each rank loads its slice of the training images and assembles the
    global batch; two steps of the fused NGP config, a checkpoint at 2
    (``spec["save_dir"]``); then, from ``spec["restore_dir"]``'s checkpoint
    of step 2, one step."""
    import numpy as np
    import torch

    from nerf_kinematics_tpu_torch.parallel.multihost import (
        host_local_slice, make_global_batch)
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    ds = scene()
    out = {}
    if spec.get("save_dir"):
        tr = Trainer(config(NGP_FUSED_RAW, spec["save_dir"]), dataset=ds, device="cpu",
                     use_mesh=mesh is not None)
        imgs, _ = ds.split("train")
        tr.images = make_global_batch(torch.as_tensor(imgs[host_local_slice(len(imgs))]),
                                      tr.mesh)
        assert torch.equal(tr.images, torch.as_tensor(imgs))
        res = tr.fit(max_iters=2)
        tr.close()
        out["host_local_loss2"] = np.float64(res.losses[-1])
    if spec.get("restore_dir"):
        out["restored_step_loss"] = np.float64(restore_and_step(
            spec["restore_dir"], ds, mesh))
    return out


def restore_and_step(logdir, ds, mesh) -> float:
    """One step on from the step-2 checkpoint under ``logdir``."""
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    tr = Trainer(config(NGP_FUSED_RAW, logdir), dataset=ds, device="cpu",
                 use_mesh=mesh is not None)
    state, it = tr.ckpt.restore(tr.engine.init_state(), 2, layout=tr.engine.layout)
    assert it == 2
    state, m = tr._train_step(state, tr.images, tr.poses, tr.ray_buf)
    tr.close()
    return float(m["loss"])


def world(spec, mesh, rank):
    import numpy as np

    return {"world": np.asarray([1 if mesh is None else mesh.world,
                                 0 if mesh is None else mesh.rank])}


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(spec: dict, out_dir: str, world: int = 2, timeout: float = 120.0) -> list:
    """Run the spec's scenarios in ``world`` worker processes over gloo on
    localhost; every rank's arrays, in rank order. Any rank's failure or a
    rank past ``timeout`` seconds fails the call (the others are killed)."""
    import subprocess
    import time

    import numpy as np

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r), str(world), path,
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            if p.returncode != 0:
                raise AssertionError(f"rank {r} failed (rc {p.returncode}):\n{err[-3000:]}")
            results.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(world)]


SCENARIOS = {"world": world, "classic_step": classic_step, "classic_fit": classic_fit,
             "ngp_fit": ngp_fit, "serve": serve, "host_local": host_local}


def main() -> int:
    port, rank, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    with open(sys.argv[4]) as f:
        spec = json.load(f)
    out_dir = sys.argv[5]
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from nerf_kinematics_tpu_torch.parallel.mesh import make_mesh
    from nerf_kinematics_tpu_torch.parallel.multihost import initialize_multihost

    assert initialize_multihost(f"127.0.0.1:{port}", nproc, rank, backend="gloo",
                                device="cpu")
    assert initialize_multihost() is True  # the group exists now
    mesh = make_mesh("cpu")
    assert mesh is not None and (mesh.rank, mesh.world) == (rank, nproc)
    out = {}
    for name in spec["scenarios"]:
        out.update(SCENARIOS[name](spec, mesh, rank))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
