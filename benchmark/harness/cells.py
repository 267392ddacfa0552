"""One run of a cell: set-up, warm-up, the measured (or traced) window, the
comparison with the plain reference, and what the result line reports.

The program under test is ``nerf_kinematics_tpu_torch``: the benchmark
hands it a configuration, a scene, a start state and the seed, and takes
from it only what its entry points return, its ``TrainResult`` records and
its kernel launch counters. The reference (``benchmark/reference``) is
handed the same inputs and works out everything else itself.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..reference import fixture as ref_fixture
from ..reference import ngp as ref
from . import scene as scenes
from . import work
from .manifest import REPO_DIR
from .trace import ReadContext, Trace, device_trace
from .traffic import Orbit, derived_seed, sample_indices


@dataclass
class Run:
    kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    ctx: Optional[ReadContext] = None
    checks: dict = field(default_factory=dict)     # name -> (value, limit)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    counters: dict = field(default_factory=dict)
    readings: dict = field(default_factory=dict)   # the comparison in detail

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(v) and v <= lim for v, lim in self.checks.values())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _path(rel: str) -> str:
    return rel if os.path.isabs(rel) else os.path.join(REPO_DIR, rel)


# ---------------------------------------------------------------- faults
# Planted only by the benchmark's own tests and its calibration: each breaks
# the timed path underneath the harness, which must then read `correct`
# false.


@contextlib.contextmanager
def planted(fault: Optional[str]):
    if fault is None:
        yield
        return
    from nerf_kinematics_tpu_torch.train import loop, ngp_engine

    saved = {}

    def patch(mod, name, value):
        saved[(mod, name)] = getattr(mod, name)
        setattr(mod, name, value)

    if fault == "unchanged":          # a step that leaves its state as it was
        patch(loop, "adam_update", lambda *a, **k: None)
    elif fault == "half":             # half the batch, the mean over the rest
        inner = loop.build_objective

        def half_objective(engine, near, far):
            obj = inner(engine, near, far)

            def halved(batch, aux, gen, u_coarse=None, u_fine=None, **kw):
                h = batch[0].shape[0] // 2
                cut = lambda t: None if t is None else t[:h]
                return obj(tuple(cut(t) for t in batch), aux, gen,
                           u_coarse=cut(u_coarse), u_fine=cut(u_fine), **kw)

            return halved

        patch(loop, "build_objective", half_objective)
    elif fault in ("altered", "half_frame"):
        inner = ngp_engine.render_image_fast
        last = {}

        def wrong(*args, **kw):
            if fault == "altered":    # the answer of the previous request
                prev = last.get("call", (args, kw))
                last["call"] = (args, kw)
                return inner(*prev[0], **prev[1])
            out = inner(*args, **kw)
            out["rgb"] = out["rgb"].clone()
            out["rgb"][out["rgb"].shape[0] // 2:] = 1.0   # half the frame left out
            return out

        patch(ngp_engine, "render_image_fast", wrong)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    try:
        yield
    finally:
        for (mod, name), value in saved.items():
            setattr(mod, name, value)


# ---------------------------------------------------------------- shared


def _port_config(cfgf: dict, seed: int, logdir: str):
    from nerf_kinematics_tpu_torch.train.config import config_from_dict

    y = copy.deepcopy(cfgf["yaml"])
    y.setdefault("experiment", {})
    y["experiment"]["randomseed"] = int(seed)
    y["experiment"]["logdir"] = logdir
    return config_from_dict(y), y


def _load_leaves(engine, leaves: dict):
    names = [e[0] for e in engine.layout.entries]
    if sorted(names) != sorted(leaves):
        raise ValueError(f"start state leaves {sorted(leaves)} != model {sorted(names)}")
    with torch.no_grad():
        for name in names:
            engine.model.get_parameter(name).copy_(torch.from_numpy(leaves[name]))


def _leaf_views(engine, flat: torch.Tensor) -> dict:
    return {name: flat[off:off + n].view(shape)
            for name, shape, off, n in engine.layout.entries}


def _reference_precision(device):
    """Full float32 products for the reference (no TF32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return saved


def _restore_precision(saved):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _launch_counters():
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    return {"launches": {k: v for k, v in cuda_lib.LAUNCHES.items() if v},
            "points": {f"{k[0]}/{k[1]}": v for k, v in cuda_lib.POINTS.items() if v}}


def _reset_counters():
    from nerf_kinematics_tpu_torch.ops import cuda_lib

    cuda_lib.reset_launch_counts()


def _train_settings(y: dict, sc: dict, sizes: dict) -> dict:
    """The reference's view of one train step, from the configuration as
    run and the scene."""
    tr, ngp = y["nerf"]["train"], y["ngp"]
    return {"num_coarse": tr["num_coarse"], "num_fine": tr.get("num_fine", 0),
            "near": sc["near"], "far": sc["far"],
            "white": bool(tr.get("white_background", False)),
            "occ_bins": sizes["occ_bins"], "occ_floor": sizes["occ_floor"],
            "lr": y["optimizer"]["lr"], "lr_decay": y["scheduler"]["lr_decay"],
            "lr_decay_factor": y["scheduler"]["lr_decay_factor"],
            "adam": sizes["adam"], "n_rays": tr["num_random_rays"],
            "perturb": bool(tr.get("perturb", True))}


# ---------------------------------------------------------------- training


def run_train(cell: str, wl: dict, cfgf: dict, traffic: dict, seed: int,
              seconds: float, trace: bool, device, t_process: float,
              fault: Optional[str] = None) -> Run:
    from nerf_kinematics_tpu_torch.data.types import Intrinsics, NerfDataset
    from nerf_kinematics_tpu_torch.ops.occupancy import OccupancyGrid
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    device = torch.device(device)
    out = Run("train")
    checked = int(traffic["checked_steps"])
    sizes = cfgf["sizes"]
    with tempfile.TemporaryDirectory() as logdir, planted(fault):
        cfg, y = _port_config(cfgf, seed, logdir)
        sc = scenes.load_scene(cfgf["scene"], device)
        fl_x, fl_y, cx, cy, W, H = sc["intrinsics"]
        n_img = sc["images"].shape[0]
        ds = NerfDataset(images=sc["images"], poses=sc["poses"],
                         intrinsics=Intrinsics(fl_x, fl_y, cx, cy, int(W), int(H)),
                         near=sc["near"], far=sc["far"], train_idx=np.arange(n_img),
                         val_idx=np.zeros(0, np.int64), aabb_scale=sc["aabb_scale"])
        trainer = Trainer(cfg, dataset=ds, device=device)
        eng = trainer.engine
        spec = ref.model_spec(sizes)
        leaves, grid_np, grid_bound = ref_fixture.read_start(_path(cfgf["start"]["train"]),
                                                             spec)
        _load_leaves(eng, leaves)
        grid0, grid_bound = start_grid(cfgf, sc, grid_np, grid_bound)
        state = eng.init_state(keep_weights=True)
        state.aux = OccupancyGrid(torch.as_tensor(grid0, device=device),
                                  torch.tensor(grid_bound, device=device))
        R = grid0.shape[0]
        u_grid = torch.rand((R**3, 3), device=device, generator=torch.Generator(
            device=device).manual_seed(derived_seed(seed, 2)))
        state = eng.update_occupancy(state, full=True, u=u_grid)

        # ---- the first steps, through the window's own call -------------
        p0 = state.params.detach().clone()
        first = trainer.fit(max_iters=1, state=state)
        b1 = sizes["adam"]["b1"]
        g1 = state.opt_state.mu.detach().clone() / (1.0 - b1)
        rest = trainer.fit(max_iters=checked, state=state)
        p_end = state.params.detach().clone()
        losses = first.losses + rest.losses
        prog = {"losses": losses, "grad": {k: v.cpu() for k, v in _leaf_views(eng, g1).items()},
                "change": {k: v.cpu() for k, v in _leaf_views(eng, p_end - p0).items()}}
        # the incremental refresh's shapes, on a copy of the state
        eng.update_occupancy(state.clone(), full=False)
        _sync(device)
        _reset_counters()

        # ---- the window ---------------------------------------------------
        chunk = int(cfg.ngp.occ_update_every)
        n_rays = cfg.nerf.num_random_rays
        it, steps, chunks, refreshes, win_losses, res_chunks = checked, 0, 0, [], [], []
        tr = Trace()
        out.setup_s = time.perf_counter() - t_process
        with device_trace(tr, enabled=trace):
            t0 = time.perf_counter()
            while True:
                res = trainer.fit(max_iters=it + chunk, state=state)
                it += chunk
                steps += chunk
                chunks += 1
                refreshes += res.occupancy_refreshes
                res_chunks += res.chunk_seconds
                win_losses += res.losses
                now = time.perf_counter()
                if (chunks >= int(traffic["trace_chunks"])) if trace else (
                        now - t0 >= seconds):
                    break
        out.window_s = now - t0
        tr.window_s = out.window_s
        out.attempted = steps
        out.failed = int(sum(1 for v in win_losses if not math.isfinite(v)))
        out.e2e["train_rays_per_s"] = steps * n_rays / out.window_s
        if device.type == "cuda":
            out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
        out.counters = _launch_counters()
        out.counters["chunk_s"] = [round(s, 3) for _, s in res_chunks]
        out.counters["refresh_ms"] = [[i, kind, round(s * 1e3, 1)] for i, kind, s in refreshes]
        t = _train_settings(y, sc, sizes)
        step_work = work.train_step(spec, t["n_rays"], t["num_coarse"], t["num_fine"])
        ref_points = sum(R**3 if kind == "full" else sizes["occ_incremental_cells"]
                         for _, kind, _ in refreshes)
        refresh_work = work.refresh(spec, ref_points)
        field_w = {k: step_work[k] * steps for k in step_work}
        out.ctx = ReadContext(
            kind="train", trace=tr, steps=steps,
            work={"field": field_w,
                  "model": {k: field_w[k] + refresh_work[k] for k in field_w}},
            refresh_s=[s for _, _, s in refreshes])
        images = torch.as_tensor(sc["images"])
        poses = torch.as_tensor(sc["poses"])
        del trainer, eng, state, first, rest, res, p0, g1, p_end
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference, after the window ------------------------------------
    saved = _reference_precision(device)
    try:
        r = reference_train(cfgf, t, sc, images, poses, leaves, grid0, grid_bound,
                            u_grid, seed, checked, device, ref.exact)
    finally:
        _restore_precision(saved)
    out.checks = compare_train(prog, r, wl["limits"])
    out.readings = train_details(prog, r)
    return out


def start_grid(cfgf: dict, sc: dict, grid, bound):
    """The occupancy grid training starts from: the start state's, or with
    none a fully occupied one over the scene (the trainer's own start)."""
    if grid is not None:
        return np.asarray(grid, np.float32), float(bound)
    R = cfgf["yaml"]["ngp"]["occ_resolution"]
    return np.ones((R,) * 3, np.float32), max(sc["aabb_scale"] / 2.0, 1.0)


def reference_train(cfgf, t, sc, images, poses, leaves, grid0, grid_bound, u_grid,
                    seed, checked, device, rnd):
    """The reference's first ``checked`` steps from the start state, fed the
    program's draws: the pixel buffer's permutation from ``seed``, each
    step's window offset and jitter from ``seed + 1``, in the order
    ``train/loop.py`` documents (offset, coarse jitter, fine jitter)."""
    if not t["perturb"]:
        raise ValueError("the reference follows perturbed training only")
    spec = ref.model_spec(cfgf["sizes"])
    ngp = cfgf["yaml"]["ngp"]
    smap = ref.scene_map(sc["aabb_scale"], ngp)
    gmap = ref.scene_map(sc["aabb_scale"], ngp, bound=grid_bound)
    params = ref_fixture.to_torch(leaves, device)
    grid = ref.refresh_full(torch.as_tensor(grid0, device=device), params, spec, smap,
                            gmap, u_grid.to(device))
    images = images.to(device)
    poses = poses.to(device)
    n_img, H, W = images.shape[0], images.shape[1], images.shape[2]
    N = n_img * H * W
    fl_x, fl_y, cx, cy = sc["intrinsics"][:4]
    n_rays, Sc, Sf = t["n_rays"], t["num_coarse"], t["num_fine"]
    perm = torch.randperm(N, generator=torch.Generator(device=device).manual_seed(int(seed)),
                          device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    batches, draws = [], []
    for _ in range(checked):
        off = torch.randint(0, max(N - n_rays + 1, 1), (), generator=gen, device=device)
        uc = torch.rand((n_rays, Sc), generator=gen, dtype=torch.float32, device=device)
        uf = (torch.rand((n_rays, Sf), generator=gen, dtype=torch.float32, device=device)
              if Sf else None)
        idx = perm[off + torch.arange(n_rays, device=device)]
        k, rem = idx // (H * W), idx % (H * W)
        row, col = (rem // W).to(torch.float32), (rem % W).to(torch.float32)
        dirs = torch.stack([(col - cx) / fl_x, -(row - cy) / fl_y,
                            -torch.ones_like(col)], dim=-1)
        d = torch.einsum("nij,nj->ni", poses[k, :3, :3], dirs)
        o = poses[k, :3, 3]
        target = images[k, (rem // W), (rem % W)]
        batches.append((o, d, d / torch.linalg.norm(d, dim=-1, keepdim=True), target))
        draws.append((uc, uf))
    p0 = {k: v.clone() for k, v in params.items()}
    losses, first, after = ref.train_steps(params, spec, smap, gmap, grid, batches, draws,
                                           t, rnd)
    return {"losses": losses, "grad": {k: v.detach().cpu() for k, v in first.items()},
            "change": {k: (after[k] - p0[k]).detach().cpu() for k in after}}


def leaf_gaps(prog: dict, refd: dict, keep) -> dict:
    """Each leaf's gap between the two sides' norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    norms = {k: float(torch.linalg.norm(refd[k])) for k in keep}
    med = statistics.median(norms.values())
    return {k: abs(float(torch.linalg.norm(prog[k])) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keep}


def leaf_gap(prog: dict, refd: dict, keep) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(prog, refd, keep).values())


def kept_leaves(refd_grad: dict) -> list:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by rounding alone."""
    norms = {k: float(torch.linalg.norm(v)) for k, v in refd_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, r: dict) -> dict:
    """The numbers a training cell may compare: the first step's loss gap
    (relative), the widest of the checked steps' loss gaps, and the worst
    leaf's gap of the first gradient's norm and of the change's norm."""
    keep = kept_leaves(r["grad"])
    gaps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], r["losses"])]
    return {"loss_gap_first": gaps[0], "loss_gap": max(gaps),
            "grad_gap": leaf_gap(prog["grad"], r["grad"], keep),
            "change_gap": leaf_gap(prog["change"], r["change"], keep)}


def train_details(prog: dict, r: dict) -> dict:
    """Each step's loss gap and each leaf's gaps, for calibration."""
    keep = kept_leaves(r["grad"])
    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], r["losses"])],
            "losses": [prog["losses"], r["losses"]],
            "grad_leaf": leaf_gaps(prog["grad"], r["grad"], keep),
            "change_leaf": leaf_gaps(prog["change"], r["change"], keep),
            "kept": keep}


def compare_train(prog: dict, r: dict, limits: dict) -> dict:
    """The numbers the cell's limits name, each with its limit."""
    nums = train_numbers(prog, r)
    return {k: (nums[k], float(lim)) for k, lim in limits.items()}


# ---------------------------------------------------------------- serving


def run_serve(cell: str, wl: dict, cfgf: dict, traffic: dict, seed: int,
              seconds: float, trace: bool, device, t_process: float,
              fault: Optional[str] = None) -> Run:
    from nerf_kinematics_tpu_torch.data.types import Intrinsics
    from nerf_kinematics_tpu_torch.ops.occupancy import OccupancyGrid
    from nerf_kinematics_tpu_torch.rendering.fast_render import FastRenderSettings
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    device = torch.device(device)
    out = Run("serve")
    sizes = cfgf["sizes"]
    res = int(traffic["resolution"])
    cam = scenes.camera(cfgf["scene"], res)
    fl_x, fl_y, cx, cy, W, H = cam["intrinsics"]
    orbit = Orbit(traffic["orbit"], seed)
    picks = set(sample_indices(seed, int(traffic["checked_frames"]),
                               int(traffic["frames_drawn_from"])))
    with tempfile.TemporaryDirectory() as logdir, planted(fault):
        cfg, y = _port_config(cfgf, seed, logdir)
        eng = NGPEngine(cfg, scene_bound=max(cam["aabb_scale"] / 2.0, 1.0), device=device)
        spec = ref.model_spec(sizes)
        leaves, grid_np, grid_bound = ref_fixture.read_start(_path(cfgf["start"]["serve"]),
                                                             spec)
        _load_leaves(eng, leaves)
        grid = OccupancyGrid(torch.as_tensor(grid_np, device=device),
                             torch.tensor(grid_bound, device=device))
        settings = FastRenderSettings(
            num_coarse=traffic["num_coarse"], num_fine=traffic["num_fine"],
            fg_fraction=traffic["fg_fraction"],
            white_background=bool(y["nerf"]["validation"].get("white_background", False)))
        render = eng.make_fast_render_fn(Intrinsics(fl_x, fl_y, cx, cy, int(W), int(H)),
                                         cam["near"], cam["far"], False, settings=settings)

        def frame(i: int):
            t_call = time.perf_counter()
            rgb = render(orbit.pose(i), grid)["rgb"]
            t_ret = time.perf_counter()
            finite = torch.isfinite(rgb).all()   # read after the window
            return rgb.cpu(), finite, t_ret - t_call

        with torch.no_grad():
            for i in range(int(traffic["warmup_frames"])):
                frame(-1 - i)
            _sync(device)
            _reset_counters()
            kept, latencies, calls, finite = {}, [], [], []
            tr = Trace()
            out.setup_s = time.perf_counter() - t_process
            n = 0
            with device_trace(tr, enabled=trace):
                t0 = time.perf_counter()
                while True:
                    t_req = time.perf_counter()
                    host, ok, call_s = frame(n)
                    now = time.perf_counter()
                    latencies.append(now - t_req)
                    calls.append(call_s)
                    finite.append(ok)
                    if n in picks:
                        kept[n] = host
                    kept["last"] = (n, host)
                    n += 1
                    if (n >= int(traffic["trace_frames"])) if trace else (now - t0 >= seconds):
                        break
        out.window_s = now - t0
        tr.window_s = out.window_s
        out.attempted = n
        out.failed = int((~torch.stack(finite)).sum())
        out.e2e["frames_per_s"] = n / out.window_s
        out.e2e["frame_ms_p95"] = float(np.percentile(np.asarray(latencies) * 1e3, 95))
        if device.type == "cuda":
            out.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
        out.counters = _launch_counters()
        out.counters["frame_ms"] = [round(v * 1e3, 1) for v in latencies]
        s = 2
        blocks = (int(H) // s) * (int(W) // s)
        fine_px = max(1, int(round(traffic["fg_fraction"] * blocks))) * s * s
        fw = work.frame(spec, blocks, fine_px, traffic["num_coarse"], traffic["num_fine"])
        fw = {k: v * n for k, v in fw.items()}
        out.ctx = ReadContext(kind="serve", trace=tr, frames=n,
                              work={"field": fw, "model": fw}, call_s=calls)
        last_i, last_host = kept.pop("last")
        kept.setdefault(last_i, last_host)
        del eng, render
        if device.type == "cuda":
            torch.cuda.empty_cache()

    r_settings = serve_settings(cfgf, traffic, cam)
    saved = _reference_precision(device)
    try:
        gaps = reference_frames(cfgf, cam, leaves, grid_np, grid_bound, orbit, kept,
                                r_settings, device, ref.exact)
    finally:
        _restore_precision(saved)
    out.checks = {k: (max(g[k] for g in gaps.values()), float(lim))
                  for k, lim in wl["limits"].items()}
    out.readings = {"frames": {str(k): v for k, v in gaps.items()}}
    return out


def serve_settings(cfgf: dict, traffic: dict, cam: dict) -> dict:
    """The reference's view of one frame request (``FastRenderSettings``'
    stride, blur and floor at their defaults)."""
    return {"stride": 2, "num_coarse": traffic["num_coarse"],
            "num_fine": traffic["num_fine"], "fg_fraction": traffic["fg_fraction"],
            "pdf_floor": 0.01, "near": cam["near"], "far": cam["far"],
            "occ_bins": cfgf["sizes"]["occ_bins"], "occ_floor": cfgf["sizes"]["occ_floor"],
            "white": bool(cfgf["yaml"]["nerf"]["validation"].get("white_background", False))}


def frame_stats(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far a frame (H, W, 3) lies from the reference's: the root mean
    square over pixels and channels, and of each pixel's largest channel
    error its mean, median, 90th and 99th percentiles and the share above
    1/64."""
    err = (got.float() - want).abs()
    px = err.amax(dim=-1).flatten()
    q = torch.quantile(px[:: max(1, px.numel() // 1000000)],
                       torch.tensor([0.5, 0.9, 0.99], device=px.device))
    return {"frame_rmse": float(torch.sqrt(torch.mean(err**2))),
            "frame_mae": float(px.mean()), "frame_p50": float(q[0]),
            "frame_p90": float(q[1]), "frame_p99": float(q[2]),
            "frame_over_1_64": float((px > 1.0 / 64).float().mean())}


def reference_frames(cfgf, cam, leaves, grid_np, grid_bound, orbit, frames: dict,
                     r_settings: dict, device, rnd) -> dict:
    """:func:`frame_stats` of each kept frame of the program against the
    reference's frame of the same request."""
    spec = ref.model_spec(cfgf["sizes"])
    ngp = cfgf["yaml"]["ngp"]
    smap = ref.scene_map(cam["aabb_scale"], ngp)
    gmap = ref.scene_map(cam["aabb_scale"], ngp, bound=grid_bound)
    params = ref_fixture.to_torch(leaves, device)
    grid = torch.as_tensor(grid_np, device=device)
    out = {}
    for i, host in sorted(frames.items()):
        want = ref.render_frame(params, spec, smap, gmap, grid, orbit.pose(i),
                                cam["intrinsics"], r_settings, rnd)
        out[i] = frame_stats(host.to(device), want)
    return out


# ---------------------------------------------------------------- the control


def control_train(cfgf: dict, traffic: dict, seed: int, device):
    """The reference with float8 operands in the program's place, against
    the f32 reference, on the first steps a run of ``seed`` checks:
    (numbers, details)."""
    spec = ref.model_spec(cfgf["sizes"])
    sc = scenes.load_scene(cfgf["scene"], device)
    leaves, grid, gb = ref_fixture.read_start(_path(cfgf["start"]["train"]), spec)
    grid, gb = start_grid(cfgf, sc, grid, gb)
    R = grid.shape[0]
    u = torch.rand((R**3, 3), device=device, generator=torch.Generator(
        device=device).manual_seed(derived_seed(seed, 2)))
    t = _train_settings(cfgf["yaml"], sc, cfgf["sizes"])
    args = (cfgf, t, sc, torch.as_tensor(sc["images"]), torch.as_tensor(sc["poses"]),
            leaves, grid, gb, u, seed, int(traffic["checked_steps"]), device)
    exact, low = reference_train(*args, ref.exact), reference_train(*args, ref.fp8)
    return train_numbers(low, exact), train_details(low, exact)


def control_serve(cfgf: dict, traffic: dict, seed: int, device) -> dict:
    """The reference's frames with float8 operands against its f32 frames,
    at the frames a run of ``seed`` draws: {frame: frame_stats}."""
    spec = ref.model_spec(cfgf["sizes"])
    cam = scenes.camera(cfgf["scene"], int(traffic["resolution"]))
    leaves, grid, gb = ref_fixture.read_start(_path(cfgf["start"]["serve"]), spec)
    orbit = Orbit(traffic["orbit"], seed)
    rs = serve_settings(cfgf, traffic, cam)
    smap = ref.scene_map(cam["aabb_scale"], cfgf["yaml"]["ngp"])
    gmap = ref.scene_map(cam["aabb_scale"], cfgf["yaml"]["ngp"], bound=gb)
    params = ref_fixture.to_torch(leaves, device)
    low = {i: ref.render_frame(params, spec, smap, gmap, torch.as_tensor(grid, device=device),
                               orbit.pose(i), cam["intrinsics"], rs, ref.fp8).cpu()
           for i in sample_indices(seed, int(traffic["checked_frames"]),
                                   int(traffic["frames_drawn_from"]))}
    return reference_frames(cfgf, cam, leaves, grid, gb, orbit, low, rs, device, ref.exact)


RUNNERS = {"train": run_train, "viewer": run_serve}
