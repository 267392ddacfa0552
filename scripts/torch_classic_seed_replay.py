#!/usr/bin/env python3
"""The classic CLI's seed-42 start on machina400, recorded on the card and
replayed on the CPU through the JAX package and the port (ROADMAP C.2:
on the card that run sits on the all-white image from step 200 on).

``record`` (the card) writes machina400 as ``chip_smoke.py``'s ``cli`` phase
does, builds the port's ``Trainer`` from the same YAML copy of
``configs/machina_classic.yml`` (seed 42), and steps it from its
``init_state()`` one step at a time, recording every draw the step takes
from its generator (the pixels, the depth jitter of both passes, the
density noise of both passes). For each of the first ``--probe`` steps it
keeps the loss, the loss an all-white prediction would have on the same
batch, and the validation PSNR of val view 0. It checks that the recorded
draws, passed in, give the generator's steps bit for bit, and that its
steps give ``Trainer.fit``'s parameters at ``--check`` steps. It writes the
scene (train and val views, one test view), the first weights and the draws
of the first K steps, K as large as ``--max_mib`` allows past the step from
which every loss equals the all-white one (the start has died).

``replay`` (the CPU, with the JAX package) loads that scene once through the
port's loader, starts both frameworks from the recorded weights (the JAX
engine takes them through ``classic_params_to_flax``), gives both the
card's draws for the K steps, then lets each draw its own to ``--steps``.
It prints each one's validation PSNR of val view 0 at K and every
``--every`` steps beside the all-white image's, and whether it sits there
(within 0.05 dB at the end). The JAX step is traced anew for each replayed
step, with ``jax.random`` handing it that step's numbers.

    python3 scripts/torch_classic_seed_replay.py record --out logs/c2_replay
    python3 scripts/torch_classic_seed_replay.py record --device cpu --resolution 16 \\
        --samples 32 --probe 6 --check 8 --replay_check 3 --out /tmp/c2   # a rehearsal
    JAX_PLATFORMS=cpu python3 scripts/torch_classic_seed_replay.py replay \\
        --src logs/c2_replay --steps 400
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 42
SITS_DB = 0.05
DRAWS = ("u_coarse", "u_fine", "noise_coarse", "noise_fine")


def config_copy(dst: str, basedir: str) -> str:
    import chip_smoke

    os.makedirs(dst, exist_ok=True)
    return chip_smoke.copy_config(
        "machina_classic.yml", dst, basedir=basedir, randomseed=SEED,
        logdir=os.path.join(dst, "logs"), validate_every=200, print_every=200)


@contextlib.contextmanager
def recording(gen, out: list):
    """Within the block every ``torch.rand`` / ``randn`` / ``randint`` drawn
    from ``gen`` is appended to ``out`` as (name, host copy)."""
    import torch

    orig = {n: getattr(torch, n) for n in ("rand", "randn", "randint")}

    def wrap(name):
        def draw(*args, **kw):
            x = orig[name](*args, **kw)
            if kw.get("generator") is gen:
                out.append((name, x.detach().cpu().numpy().copy()))
            return x
        return draw

    try:
        for n in orig:
            setattr(torch, n, wrap(n))
        yield
    finally:
        for n, f in orig.items():
            setattr(torch, n, f)


def step_draws(rec: list) -> dict:
    """One step's recorded draws -> the train step's keyword arguments."""
    kinds = [n for n, _ in rec]
    if kinds != ["randint"] * 3 + ["rand", "randn", "rand", "randn"]:
        raise AssertionError(f"unexpected draws in a step: {kinds}")
    x = [a for _, a in rec]
    return {"pixels": x[:3], "u_coarse": x[3], "noise_coarse": x[4], "u_fine": x[5],
            "noise_fine": x[6]}


def as_kwargs(d: dict, device) -> dict:
    import torch

    kw = {k: torch.as_tensor(d[k], device=device) for k in DRAWS}
    kw["pixels"] = [torch.as_tensor(p, device=device) for p in d["pixels"]]
    return kw


def record(args) -> int:
    import torch

    from nerf_kinematics_tpu_torch.data.machina import write_machina_dataset
    from nerf_kinematics_tpu_torch.metrics.psnr import psnr
    from nerf_kinematics_tpu_torch.train.config import load_config
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    import chip_smoke

    device = args.device or "cuda"
    if device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu for a rehearsal")
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    scene = dict(chip_smoke.SCENE, **{k: v for k, v in (
        ("resolution", args.resolution), ("n_samples", args.samples)) if v})
    report = {"card": torch.cuda.get_device_name(0) if device != "cpu" else "cpu",
              "scene": scene}
    with tempfile.TemporaryDirectory() as root:
        basedir = os.path.join(root, "machina400")
        t0 = time.perf_counter()
        write_machina_dataset(basedir, device=device, **scene)
        report["scene_seconds"] = time.perf_counter() - t0
        trainer = Trainer(load_config(config_copy(os.path.join(root, "run"), basedir)),
                          device=device)
        ds = trainer.dataset
        i_val = int(ds.val_idx[0])
        white_val = psnr(np.ones_like(ds.images[i_val]), ds.images[i_val])
        step = trainer._train_step
        state = trainer.engine.init_state()
        state0 = state.clone()
        params0 = state.params.detach().cpu().numpy().copy()
        imgs = trainer.images
        draws, probe, kept = [], [], {}
        for k in range(1, args.probe + 1):
            rec = []
            with recording(state.generator, rec):
                state, m = step(state, imgs, trainer.poses, trainer.ray_buf)
            d = step_draws(rec)
            draws.append(d)
            img, row, col = (torch.as_tensor(p, device=imgs.device) for p in d["pixels"])
            white_loss = 2.0 * float(torch.mean((1.0 - imgs[img, row, col]) ** 2))
            probe.append({"step": k, "loss": float(m["loss"]), "white_loss": white_loss,
                          "val_psnr_db": trainer.validate(state)["val_psnr"]})
            if k <= args.replay_check:
                kept[k] = state.params.clone()
        # the draws passed in give the generator's steps, bit for bit
        s = state0.clone()
        for k in range(1, args.replay_check + 1):
            s, _ = step(s, imgs, trainer.poses, trainer.ray_buf,
                        **as_kwargs(draws[k - 1], imgs.device))
            if not torch.equal(s.params, kept[k]):
                raise AssertionError(f"replayed step {k} differs from the generator's")
        # the step-by-step run is Trainer.fit's
        for _ in range(args.probe, args.check):
            state, _ = step(state, imgs, trainer.poses, trainer.ray_buf)
        fit = trainer.fit(max_iters=args.check, state=state0.clone())
        report["fit_equal"] = bool(torch.equal(fit.state.params, state.params))
        report["val_psnr_at_check"] = trainer.validate(state)["val_psnr"]
        trainer.close()

        dead = [abs(p["loss"] - p["white_loss"]) <= 1e-4 * p["white_loss"] for p in probe]
        died = next((k + 1 for k in range(len(dead)) if all(dead[k:])), None)
        # the scene: train and val views, one test view
        kept_dir = os.path.join(out, "machina400")
        shutil.rmtree(kept_dir, ignore_errors=True)
        os.makedirs(kept_dir)
        for split in ("train", "val", "test"):
            with open(os.path.join(basedir, f"transforms_{split}.json")) as f:
                meta = json.load(f)
            if split == "test":
                meta["frames"] = meta["frames"][:1]
            for fr in meta["frames"]:
                src = os.path.join(basedir, fr["file_path"] + ".png")
                dst = os.path.join(kept_dir, fr["file_path"] + ".png")
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copyfile(src, dst)
            with open(os.path.join(kept_dir, f"transforms_{split}.json"), "w") as f:
                json.dump(meta, f)
    scene_bytes = sum(os.path.getsize(os.path.join(dp, f))
                      for dp, _, fs in os.walk(kept_dir) for f in fs)
    per_step = sum(np.asarray(v).nbytes for d in draws[:1] for v in
                   list(d["pixels"]) + [d[k] for k in DRAWS])
    room = int((args.max_mib * 2**20 - scene_bytes - params0.nbytes) // per_step)
    n_keep = min(len(draws), room, (died + args.margin) if died else room)
    arrays = {"params0": params0}
    for k in DRAWS:
        arrays[k] = np.stack([d[k] for d in draws[:n_keep]])
    arrays["pixels"] = np.stack([np.stack(d["pixels"]) for d in draws[:n_keep]])
    np.savez(os.path.join(out, "draws.npz"), **arrays)
    report.update(all_white_val_psnr_db=white_val, died_at=died, steps_kept=n_keep,
                  scene_bytes=scene_bytes, probe=probe)
    with open(os.path.join(out, "record.json"), "w") as f:
        json.dump(report, f)
    print(json.dumps({k: v for k, v in report.items() if k != "probe"}))
    print(json.dumps({"probe": [[p["step"], p["loss"], p["white_loss"], p["val_psnr_db"]]
                                for p in probe]}))
    return 0 if report["fit_equal"] else 1


@contextlib.contextmanager
def jax_draws(d: dict):
    """``jax.random`` hands the traced step ``d``'s numbers, in the order
    the JAX step draws them: three pixel integers, then the coarse and the
    fine jitter (uniform), the coarse and the fine noise (normal)."""
    import jax
    import jax.numpy as jnp

    ints = list(d["pixels"])
    uni = [d["u_coarse"], d["u_fine"]]
    nrm = [d["noise_coarse"], d["noise_fine"]]
    orig = jax.random.randint, jax.random.uniform, jax.random.normal

    def take(queue, shape, dtype):
        x = queue.pop(0)
        if tuple(shape) != x.shape:
            raise AssertionError(f"draw of shape {tuple(shape)}, recorded {x.shape}")
        return jnp.asarray(x, dtype)

    jax.random.randint = lambda key, shape, minval, maxval, dtype=jnp.int32: take(
        ints, shape, dtype)
    jax.random.uniform = lambda key, shape=(), dtype=jnp.float32, **kw: take(
        uni, shape, dtype)
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: take(nrm, shape, dtype)
    try:
        yield
    finally:
        jax.random.randint, jax.random.uniform, jax.random.normal = orig
    if ints or uni or nrm:
        raise AssertionError(f"the JAX step left recorded draws unused: {len(ints)} "
                             f"integers, {len(uni)} uniforms, {len(nrm)} normals")


def replay(args) -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from nerf_kinematics_tpu.data.types import Intrinsics as JIntrinsics
    from nerf_kinematics_tpu.train.config import load_config as jload_config
    from nerf_kinematics_tpu.train.loop import ClassicNerf as JClassic
    from nerf_kinematics_tpu_torch.io.convert import classic_params_to_flax
    from nerf_kinematics_tpu_torch.metrics.psnr import psnr
    from nerf_kinematics_tpu_torch.train.config import load_config
    from nerf_kinematics_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    src = os.path.abspath(args.src)
    with open(os.path.join(src, "record.json")) as f:
        rec = json.load(f)
    z = np.load(os.path.join(src, "draws.npz"))
    n_rec = z["pixels"].shape[0]
    draws = [{"pixels": list(z["pixels"][k]), **{n: z[n][k] for n in DRAWS}}
             for k in range(n_rec)]
    report = {"steps_replayed": n_rec, "card": {k: rec[k] for k in
              ("died_at", "all_white_val_psnr_db", "val_psnr_at_check")},
              "card_val_psnr_at_replayed": rec["probe"][n_rec - 1]["val_psnr_db"]}
    with tempfile.TemporaryDirectory() as root:
        yml = config_copy(root, os.path.join(src, "machina400"))
        trainer = Trainer(load_config(yml), device="cpu")
        te, ds = trainer.engine, trainer.dataset
        tstate = te.init_state()
        report["weights_equal"] = bool(np.array_equal(tstate.params.numpy(), z["params0"]))
        if not report["weights_equal"]:
            tstate.params.copy_(torch.as_tensor(z["params0"]))
        je = JClassic(jload_config(yml))
        with te.bound(tstate.params):
            tree = classic_params_to_flax(
                {n: p.detach() for n, p in te.model.named_parameters()})
        jstate = je.init_state(SEED)
        jstate = jstate._replace(params=jax.tree_util.tree_map(jnp.asarray, tree))
        ti = ds.intrinsics
        jintr = JIntrinsics(fl_x=ti.fl_x, fl_y=ti.fl_y, cx=ti.cx, cy=ti.cy,
                            width=ti.width, height=ti.height)
        raw_step = je._build_train_step(jintr, ds.near, ds.far, ds.use_ndc)
        jstep = jax.jit(raw_step)
        tstep = te.make_train_step(ti, ds.near, ds.far, ds.use_ndc)
        jrender = je.make_render_fn(jintr, ds.near, ds.far, ds.use_ndc)
        trender = te.make_render_fn(ti, ds.near, ds.far, ds.use_ndc)
        jimgs, jposes = jnp.asarray(trainer.images.numpy()), jnp.asarray(trainer.poses.numpy())
        i_val = int(ds.val_idx[0])
        gt, pose = ds.images[i_val], ds.poses[i_val].astype(np.float32)
        white = psnr(np.ones_like(gt), gt)

        def val():
            j = psnr(np.asarray(jrender(jstate.params, jnp.asarray(pose))["rgb"]), gt)
            with torch.no_grad(), te.bound(tstate.params):
                t = psnr(trender(torch.as_tensor(pose))["rgb"].numpy(), gt)
            return j, t

        curves = {"jax": {}, "port": {}}
        losses = {"jax": [], "port": []}
        t0 = time.perf_counter()
        for k in range(1, args.steps + 1):
            if k <= n_rec:
                with jax_draws(draws[k - 1]):
                    # a new function each step, so that it is traced anew
                    jstate, jm = jax.jit(lambda *a: raw_step(*a))(jstate, jimgs, jposes)
                tstate, tm = tstep(tstate, trainer.images, trainer.poses,
                                   **as_kwargs(draws[k - 1], "cpu"))
            else:
                jstate, jm = jstep(jstate, jimgs, jposes)
                tstate, tm = tstep(tstate, trainer.images, trainer.poses)
            losses["jax"].append(float(jm["loss"]))
            losses["port"].append(float(tm["loss"]))
            if k == n_rec or k % args.every == 0:
                curves["jax"][k], curves["port"][k] = val()
        trainer.close()
    report.update(all_white_val_psnr_db=white, seconds=time.perf_counter() - t0,
                  first_losses={fw: v[:5] for fw, v in losses.items()})
    for fw in ("jax", "port"):
        last = curves[fw][max(curves[fw])]
        report[fw] = {"val_psnr_db": curves[fw],
                      "sits_at_end": bool(abs(last - white) <= SITS_DB),
                      "loss_replayed_last": losses[fw][n_rec - 1]}
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("record")
    r.add_argument("--out", default="logs/c2_replay")
    r.add_argument("--probe", type=int, default=100, help="steps recorded and probed")
    r.add_argument("--check", type=int, default=200, help="steps held to Trainer.fit")
    r.add_argument("--replay_check", type=int, default=5)
    r.add_argument("--margin", type=int, default=5, help="steps kept past the death")
    r.add_argument("--max_mib", type=float, default=56.0)
    r.add_argument("--device", default=None, help="default: the GPU")
    r.add_argument("--resolution", type=int, default=None, help="default: chip_smoke's")
    r.add_argument("--samples", type=int, default=None, help="default: chip_smoke's")
    p = sub.add_parser("replay")
    p.add_argument("--src", default="logs/c2_replay")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--every", type=int, default=100)
    args = ap.parse_args(argv)
    return record(args) if args.mode == "record" else replay(args)


if __name__ == "__main__":
    sys.exit(main())
