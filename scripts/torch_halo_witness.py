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

Two more modes answer the ``fused: off`` half in its trained regime, which
the CPU cannot reach by training (a JAX step at 16384 rays takes minutes):

- ``record`` (the card) trains the ``halo`` phase's ``fused: off`` run as
  ``chip_smoke.py`` does (49 views of 128^2, 16384 rays, 1000 steps, the
  YAML's refreshes), reads the held-out and four training views' PSNRs and
  a 32^2 crop of held-out view 0, and writes the state
  (``io/fixture.py::write_halo_state``: parameters and grid projections in
  bf16, which is how the route reads them; the record checks that the
  stored state renders the same bits) to
  ``nerf_kinematics_tpu_torch/fixtures/halo_fox_unfused_1000.npz``.
- ``replay`` (the CPU, both packages) makes the halo scene once through the
  port's generator, loads the card's state into the JAX engine and the
  port, renders the held-out and the four training views through both
  (PSNR beside the card's), then takes ``--steps`` steps at 16384 rays
  from that state (fresh Adam moments) in lockstep, both given the same
  window offsets and depth jitter drawn here; from step 2 on, also JAX's
  loss from the port's state. ``--f32`` runs both packages' layers and
  tables in f32 from the same state (the card's renders are bf16's).

    python3 scripts/torch_halo_witness.py record
    JAX_PLATFORMS=cpu python3 scripts/torch_halo_witness.py replay --steps 3
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROUTES = {"unfused": {"fused": "off"}, "hash": {"encoder": "hash"}}
HALO_FIXTURE = os.path.join(ROOT, "nerf_kinematics_tpu_torch", "fixtures",
                            "halo_fox_unfused_1000.npz")


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


# ---------------------------------------------------------------- record / replay

REPLAY_TRAIN_VIEWS = 4   # training views rendered beside the two held-out ones
CROP = 32                # the crop of held-out view 0 the tier-1 test renders
LOSS_RTOL = 1e-4         # ROADMAP "Rules for parity tests"
G_LIVE = 2e-6            # compare gradients only where |g| exceeds this
G_ATOL_SHARE = 2e-2      # bf16 gradients: of each leaf's largest entry
HELD_DB = 0.1            # JAX against the card on the held-out views


def crop_at(size: int) -> tuple:
    """(row, col) of the central CROP x CROP window."""
    r0 = (size - CROP) // 2
    return r0, r0


def crop_intrinsics(intr, r0: int, c0: int):
    """The pinhole of the window rows r0.., cols c0.. of a view."""
    import dataclasses

    return dataclasses.replace(intr, cx=intr.cx - c0, cy=intr.cy - r0,
                               width=CROP, height=CROP)


def replay_views(ds) -> list:
    """Held-out views, then REPLAY_TRAIN_VIEWS training views spread over
    the orbit."""
    tr = np.asarray(ds.train_idx)
    pick = tr[np.linspace(0, len(tr) - 1, REPLAY_TRAIN_VIEWS).round().astype(int)]
    return [int(i) for i in ds.val_idx] + [int(i) for i in pick]


def port_render(eng, params, grid, intr, ds, pose):
    import torch

    render = eng.make_render_fn(intr, ds.near, ds.far, False)
    with torch.no_grad(), eng.bound(params):
        return render(torch.as_tensor(pose, device=eng.device), grid)["rgb"]


def record(args) -> int:
    """The ``halo`` phase's ``fused: off`` run on the card, its PSNRs and its
    state; see the module docstring."""
    import dataclasses
    import tempfile

    import torch

    import chip_smoke
    from nerf_kinematics_tpu_torch.bench import nvidia_smi_line
    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.io.fixture import read_halo_state, write_halo_state
    from nerf_kinematics_tpu_torch.train.loop import eval_params
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for a rehearsal")
    dev = torch.device(args.device)
    scene = {"n_views": args.views or chip_smoke.HALO_SCENE["n_views"],
             "resolution": args.size or chip_smoke.HALO_SCENE["resolution"]}
    t0 = time.perf_counter()
    ds = make_synthetic_scene(variant="halo", device=dev, **scene)
    with tempfile.TemporaryDirectory() as root:
        cfg, cuts = chip_smoke.halo_config(root, args.steps, False)
        if args.rays:
            cfg = cfg.replace(nerf=dataclasses.replace(cfg.nerf, num_random_rays=args.rays))
        cfg = cfg.replace(ngp=dataclasses.replace(cfg.ngp, fused="off"))
        trainer = Trainer(cfg, ds, device=dev)
        res = trainer.fit(state=trainer.engine.init_state())
        trainer.close()
    eng, state = trainer.engine, res.state
    params, grid = eval_params(state), state.aux
    views = replay_views(ds)
    r0, c0 = crop_at(ds.intrinsics.height)
    cintr = crop_intrinsics(ds.intrinsics, r0, c0)

    def renders(p, g):
        out = [port_render(eng, p, g, ds.intrinsics, ds, ds.poses[i]) for i in views]
        return out, port_render(eng, p, g, cintr, ds, ds.poses[views[0]])

    imgs, crop = renders(params, grid)
    psnrs = [_psnr(im.cpu().numpy(), ds.images[i]) for im, i in zip(imgs, views)]
    n_val = len(ds.val_idx)
    losses = np.asarray(res.losses, np.float64)
    meta = {"nvidia_smi": nvidia_smi_line() if dev.type == "cuda" else "cpu",
            "torch": torch.__version__,
            "steps": int(state.step), "rays": cfg.nerf.num_random_rays,
            "scene": scene, "cuts": cuts,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "loss_last16": float(losses[-16:].mean()),
            "refreshes": [[i, k] for i, k, _ in res.occupancy_refreshes]}
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    write_halo_state(
        out, params, grid.density, float(grid.bound),
        views=np.asarray(views), n_val=np.asarray(n_val),
        card_psnr_db=np.asarray(psnrs), card_crop=crop.cpu().numpy(),
        crop_at=np.asarray([r0, c0]), crop_pose=np.asarray(ds.poses[views[0]]),
        intrinsics=np.asarray([ds.intrinsics.fl_x, ds.intrinsics.fl_y, ds.intrinsics.cx,
                               ds.intrinsics.cy, ds.intrinsics.width,
                               ds.intrinsics.height], np.float64),
        near_far=np.asarray([ds.near, ds.far], np.float64),
        card_gt_mean=np.asarray([float(np.mean(ds.images[i], dtype=np.float64))
                                 for i in views]),
        meta=json.dumps(meta))
    # the stored state (bf16 parameters, the grid's hull) renders the same bits
    st = read_halo_state(out, device=dev)
    imgs2, crop2 = renders(st["params"], st["grid"])
    equal = all(torch.equal(a, b) for a, b in zip(imgs + [crop], imgs2 + [crop2]))
    report = dict(meta, views=views, card_val_psnr_db=psnrs[:n_val],
                  card_train_psnr_db=psnrs[n_val:], stored_state_renders_equal=equal,
                  fixture_bytes=os.path.getsize(out), seconds=time.perf_counter() - t0)
    print(json.dumps(report))
    return 0 if equal else 1


def jax_grid(grid):
    import jax.numpy as jnp

    from nerf_kinematics_tpu.ops.occupancy import OccupancyGrid

    return OccupancyGrid(jnp.asarray(grid.density.numpy()), jnp.float32(float(grid.bound)))


def replay_pair(raw: dict, st: dict, bound: float):
    """Both engines on the recorded state: (port engine, port state, JAX
    engine, JAX state). Fresh Adam moments in both."""
    import jax
    import jax.numpy as jnp

    from nerf_kinematics_tpu.train import config as jcfg
    from nerf_kinematics_tpu.train.ngp_engine import NGPEngine as JEngine
    from nerf_kinematics_tpu_torch.train import config as tcfg
    from nerf_kinematics_tpu_torch.train.ngp_engine import NGPEngine

    te = NGPEngine(tcfg.config_from_dict(raw), scene_bound=bound, device="cpu")
    tstate = te.init_state()
    tstate.params.copy_(st["params"])
    tstate.aux = st["grid"]
    tree = params_to_flax_of(te, tstate.params)
    je = JEngine(jcfg.config_from_dict(raw), scene_bound=bound)
    jstate = je.init_state(int(raw["experiment"]["randomseed"]))
    jstate = jstate._replace(
        params=dict(jstate.params, coarse=jax.tree_util.tree_map(jnp.asarray, tree)),
        aux=jax_grid(st["grid"]))
    return te, tstate, je, jstate


def jax_intrinsics(ti):
    from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics

    return JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                       width=ti.width, height=ti.height)


def jax_render(je, jstate, intr, ds, pose):
    import jax.numpy as jnp

    from nerf_kinematics_tpu.train.loop import eval_params as jeval

    render = je.make_render_fn(jax_intrinsics(intr), ds.near, ds.far, False)
    return np.asarray(render(jeval(jstate), jnp.asarray(pose), jstate.aux)["rgb"])


@contextlib.contextmanager
def jax_draws(u, offset):
    """Within the block ``jax.random`` hands a traced NGP step the window
    offset and the depth jitter ``u``."""
    import jax
    import jax.numpy as jnp

    saved = jax.random.uniform, jax.random.randint
    jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, **kw: (
        jnp.asarray(u.reshape(shape), dtype))
    jax.random.randint = lambda key, shape, minval, maxval, dtype=jnp.int32: (
        jnp.asarray(offset, dtype))
    try:
        yield
    finally:
        jax.random.uniform, jax.random.randint = saved


def params_to_flax_of(te, flat):
    """The port's flat parameters as the JAX model's variables."""
    from nerf_kinematics_tpu_torch.io.convert import params_to_flax

    with te.bound(flat):
        return params_to_flax({n: p.detach() for n, p in te.model.named_parameters()})


def jax_moments(opt_state, n: int):
    """The flattened Adam's (mu, nu) leaves of the JAX optimizer state."""
    import jax

    big = [np.asarray(l) for l in jax.tree_util.tree_leaves(opt_state) if np.size(l) == n]
    if len(big) != 2:
        raise AssertionError(f"expected mu and nu of size {n}, found {len(big)}")
    return big


def replay(args) -> int:
    """The card's state through both packages on the CPU; see the module
    docstring."""
    import jax
    import jax.numpy as jnp
    import torch

    from nerf_kinematics_tpu_torch.data.synthetic import make_synthetic_scene
    from nerf_kinematics_tpu_torch.io import convert
    from nerf_kinematics_tpu_torch.io.fixture import read_halo_state
    from nerf_kinematics_tpu_torch.train.loop import build_shuffled_ray_buffer

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    t0 = time.perf_counter()
    st = read_halo_state(args.src)
    meta = json.loads(str(st["meta"]))
    ds = make_synthetic_scene(variant="halo", device="cpu", **meta["scene"])
    views = [int(i) for i in st["views"]]
    n_val = int(st["n_val"])
    bound = max(ds.aabb_scale / 2.0, 1.0)
    raw = route_raw(fox_raw(), "unfused", 1000, int(meta["rays"]))
    if args.f32:
        # the same state through f32 layers and tables in both packages: what
        # bf16 rounding adds to the two packages' gap
        raw["ngp"]["compute_dtype"] = "float32"
        raw["ngp"]["cp"] = dict(raw["ngp"].get("cp") or {}, use_bf16=False)
    te, tstate, je, jstate = replay_pair(raw, st, bound)
    report = {"card": meta["nvidia_smi"], "views": views, "f32": args.f32,
              "gt_mean_abs_diff_vs_card": float(np.max(np.abs(
                  [np.mean(ds.images[i], dtype=np.float64) for i in views]
                  - st["card_gt_mean"]))),
              "scene_seconds": time.perf_counter() - t0}
    # ---- (a) renders from the card's weights and grid -------------------------
    t1 = time.perf_counter()
    rows = []
    for k, i in enumerate(views):
        jimg = jax_render(je, jstate, ds.intrinsics, ds, ds.poses[i])
        timg = port_render(te, tstate.params, tstate.aux, ds.intrinsics, ds,
                           ds.poses[i]).numpy()
        rows.append({"view": i, "held_out": k < n_val,
                     "card_db": float(st["card_psnr_db"][k]),
                     "jax_db": _psnr(jimg, ds.images[i]),
                     "port_db": _psnr(timg, ds.images[i]),
                     "jax_vs_port_db": _psnr(jimg, timg)})
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    report["renders"] = rows
    report["render_seconds"] = time.perf_counter() - t1
    held = [r for r in rows if r["held_out"]]
    report["jax_held_out_within_db"] = max(abs(r["jax_db"] - r["card_db"]) for r in held)
    # ---- (b) lockstep steps from that state -----------------------------------
    t2 = time.perf_counter()
    n_rays = int(meta["rays"])
    S = te.cfg.nerf.train.num_coarse
    buf = build_shuffled_ray_buffer(torch.as_tensor(ds.images[ds.train_idx]),
                                    torch.as_tensor(ds.poses[ds.train_idx]),
                                    ds.intrinsics, seed=int(raw["experiment"]["randomseed"]))
    jbuf = {k: jnp.asarray(v.numpy()) for k, v in buf.items()}
    n_total = int(buf["target"].shape[0])
    rng = np.random.default_rng(args.seed)
    tstep = te.make_train_step(ds.intrinsics, ds.near, ds.far, False)
    jintr = jax_intrinsics(ds.intrinsics)
    layout = te.layout
    steps = []
    for k in range(1, args.steps + 1):
        offset = int(rng.integers(0, n_total - n_rays + 1))
        u = rng.uniform(size=(n_rays, S)).astype(np.float32)
        with jax_draws(u, offset):
            # a new jit each step, traced with this step's draws
            jstate, jm = je.make_train_step(jintr, ds.near, ds.far, False,
                                            donate=False)(jstate, None, None, jbuf)
        jloss = float(jm["loss"])
        if k > 1:
            # the JAX step's loss from the port's state: the two parameter
            # sets part after a step where |g| is at rounding level (Adam's
            # first update is -lr sign(g)), so this isolates the step itself
            synced = jstate._replace(params=dict(jstate.params, coarse=jax.tree_util.tree_map(
                jnp.asarray, params_to_flax_of(te, tstate.params))))
            with jax_draws(u, offset):
                _, js = je.make_train_step(jintr, ds.near, ds.far, False,
                                           donate=False)(synced, None, None, jbuf)
            jloss_synced = float(js["loss"])
        before = tstate.params.clone()
        tstate, tm = tstep(tstate, None, None, buf, offset=offset,
                           u_coarse=torch.as_tensor(u))
        tloss = float(tm["loss"])
        row = {"step": k, "offset": offset, "jax_loss": jloss, "port_loss": tloss,
               "rel": abs(tloss - jloss) / abs(jloss)}
        if k > 1:
            row.update(jax_loss_from_port_state=jloss_synced,
                       rel_from_port_state=abs(tloss - jloss_synced) / abs(jloss_synced))
        if k == 1:
            # Adam's first moment after one step is (1 - b1) g
            mu, _ = jax_moments(jstate.opt_state, layout.total)
            g_j = convert.flat_from_reference(mu, layout).numpy() / (1.0 - te.adam.b1)
            g_t = tstate.opt_state.mu.numpy() / (1.0 - te.adam.b1)
            live = np.abs(g_j) > G_LIVE
            p_j = layout.flatten({n: torch.as_tensor(v) for n, v in convert.named_from_flax(
                jax.tree_util.tree_map(np.asarray, jstate.params["coarse"])).items()}).numpy()
            moved_t = tstate.params.numpy() - before.numpy()
            moved_j = p_j - before.numpy()
            leaves = {}
            for name, _, off, n in layout.entries:
                sl = slice(off, off + n)
                scale = float(np.abs(g_j[sl]).max()) or 1.0
                leaves[name] = float(np.abs(g_t[sl] - g_j[sl])[live[sl]].max(initial=0.0)
                                     / scale)
            row.update(live_share=float(live.mean()),
                       grad_err_by_leaf=leaves,
                       grad_ok=all(v <= G_ATOL_SHARE for v in leaves.values()),
                       update_sign_agree_live=float(
                           (np.sign(moved_t[live]) == np.sign(moved_j[live])).mean()))
        steps.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    report["lockstep"] = steps
    report["lockstep_seconds"] = time.perf_counter() - t2
    report["losses_agree"] = all(r["rel"] <= LOSS_RTOL for r in steps)
    report["losses_agree_from_port_state"] = all(
        r.get("rel_from_port_state", r["rel"]) <= LOSS_RTOL for r in steps)
    report["verdict"] = ("behaviour kept" if report["losses_agree"] and steps[0]["grad_ok"]
                         and report["jax_held_out_within_db"] <= HELD_DB else "differs")
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("record", "replay"):
        ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        sub = ap.add_subparsers(dest="mode", required=True)
        r = sub.add_parser("record")
        r.add_argument("--out", default=HALO_FIXTURE)
        r.add_argument("--device", default="cuda")
        r.add_argument("--steps", type=int, default=1000)
        r.add_argument("--rays", type=int, default=0, help="default: the YAML's")
        r.add_argument("--views", type=int, default=0, help="default: chip_smoke's")
        r.add_argument("--size", type=int, default=0, help="default: chip_smoke's")
        p = sub.add_parser("replay")
        p.add_argument("--src", default=HALO_FIXTURE)
        p.add_argument("--steps", type=int, default=3)
        p.add_argument("--seed", type=int, default=0, help="of the lockstep's draws")
        p.add_argument("--f32", action="store_true",
                       help="both packages' layers and tables in f32, not the YAML's bf16")
        args = ap.parse_args(argv)
        return record(args) if args.mode == "record" else replay(args)
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
