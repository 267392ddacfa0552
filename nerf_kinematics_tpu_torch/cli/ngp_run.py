"""CLI: the fast engine's train / evaluate / render command, with the flags
of instant-ngp's ``scripts/run.py``, on the GPU unless told otherwise:

    python -m nerf_kinematics_tpu_torch.cli.ngp_run <scene> \\
        --n_steps 25000 --save_snapshot model.nktsnap
    python -m nerf_kinematics_tpu_torch.cli.ngp_run <scene> \\
        --load_snapshot model.nktsnap --test_transforms transforms_val.json
    ... --screenshot_transforms t.json --screenshot_dir out/ --width 1280
    ... --save_mesh mesh.ply --marching_cubes_res 256
    ... --config configs/machina_ngp.yml   (the YAML's whole recipe)
    ... --encoder hash                      (the Instant-NGP hash grid)
    ... --device cpu                        (the plain versions, on the CPU)

Image paths resolve relative to their JSON. ``--mode`` is accepted and
ignored with the reference's warning. ``--save_mesh`` writes the
isosurface of the density at ``--marching_cubes_density_thresh`` on a
``--marching_cubes_res``^3 grid over the scene box, by the native mesh core
(``export/mesh.py``).

Snapshots are the JAX package's ``.nktsnap`` files (``io/snapshot.py``):
``{"params": {"coarse": <flax tree>}}`` of the weights evaluation scores
(the EMA shadow when the run keeps one), plus, as instant-ngp's snapshots
carry the density grid, ``"occupancy"`` (the grid's ``density`` and
``bound``). A snapshot without it starts from a fresh grid, as the JAX CLI
does. The metadata holds ``step``, ``engine`` and the run's whole
configuration (``train/config.py::config_to_json``, which keeps what the
reference's ``config_to_dict`` drops). Counterpart of ``nerf_kinematics_tpu/cli/ngp_run.py``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fast-NeRF (NGP-class) train / evaluate / render")
    p.add_argument("scene", help="Scene dir containing transforms.json (or a JSON path)")
    p.add_argument("--n_steps", type=int, default=0, help="Train this many steps")
    p.add_argument("--save_snapshot", default=None, help="Write a snapshot after training")
    p.add_argument("--load_snapshot", default=None, help="Load a snapshot before anything else")
    p.add_argument("--test_transforms", default=None, help="Transforms JSON to PSNR-evaluate")
    p.add_argument("--screenshot_transforms", default=None, help="Transforms JSON to render")
    p.add_argument("--screenshot_dir", default="screenshots", help="Output dir for renders")
    p.add_argument("--save_mesh", default=None, help="Write a .ply isosurface mesh")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--marching_cubes_density_thresh", type=float, default=2.5)
    p.add_argument("--width", type=int, default=None, help="Render width override")
    p.add_argument("--height", type=int, default=None, help="Render height override")
    p.add_argument("--batch", type=int, default=4096, help="Rays per training step")
    p.add_argument("--samples", type=int, default=64, help="Coarse samples per ray")
    p.add_argument("--fine-samples", type=int, default=64, help="Importance samples per ray")
    p.add_argument("--encoder", default="cp",
                   choices=["cp", "cp_pallas", "hash"], help="Positional encoder")
    p.add_argument("--config", default=None,
                   help="YAML config (reference schema) supplying the whole "
                        "model/optimizer/sampling recipe. The CLI then "
                        "contributes only the scene location and, when "
                        "given, --n_steps; --batch/--samples/--fine-samples/"
                        "--encoder are taken from the YAML. Without it this "
                        "CLI uses its built-in demo hyperparameters.")
    p.add_argument("--mode", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on the CPU)")
    return p


def make_config(args):
    """The run's Config: the YAML's recipe with the scene and, when given,
    --n_steps; or the built-in demo hyperparameters."""
    import dataclasses

    from ..models.ngp import NGPConfig
    from ..rendering.renderer import RenderSettings
    from ..train.config import (Config, DatasetConfig, ExperimentConfig, NeRFConfig,
                                OptimizerConfig, SchedulerConfig, load_config)

    scene_id = os.path.basename(os.path.normpath(args.scene)).replace(".json", "") or "scene"
    if args.config:
        cfg = load_config(args.config)
        return cfg.replace(
            engine="ngp",
            ngp=cfg.ngp if cfg.ngp is not None else NGPConfig(),
            dataset=dataclasses.replace(cfg.dataset, basedir=args.scene, type="ngp"),
            experiment=dataclasses.replace(
                cfg.experiment, id=f"ngp-{scene_id}",
                # --n_steps overrides the YAML's budget only when given
                train_iters=(args.n_steps if args.n_steps > 0
                             else cfg.experiment.train_iters)),
        )
    return Config(
        engine="ngp",
        ngp=NGPConfig(encoder=args.encoder),
        dataset=DatasetConfig(basedir=args.scene, type="ngp"),
        experiment=ExperimentConfig(
            id=f"ngp-{scene_id}", logdir="logs", train_iters=max(args.n_steps, 1),
            print_every=500, validate_every=0, save_every=0),
        nerf=NeRFConfig(
            train=RenderSettings(num_coarse=args.samples, num_fine=args.fine_samples,
                                 perturb=True),
            validation=RenderSettings(num_coarse=args.samples, num_fine=args.fine_samples,
                                      perturb=False),
            num_random_rays=args.batch),
        optimizer=OptimizerConfig(lr=1e-2),
        scheduler=SchedulerConfig(lr_decay=50, lr_decay_factor=0.33),
    )


def snapshot_tree(engine, state) -> dict:
    """The snapshot of a state: the weights evaluation scores as the JAX
    engine's parameter tree, and the occupancy grid."""
    from ..io.convert import params_to_flax
    from ..train.loop import eval_params

    with engine.bound(eval_params(state)):
        sd = {k: v.detach() for k, v in engine.model.state_dict().items()}
    enc = engine.ngp_config.resolved_encoder()
    tree = {"params": {"coarse": params_to_flax(sd, encoder=enc)}}
    if state.aux is not None:
        tree["occupancy"] = {"density": state.aux.density.detach().cpu().numpy(),
                             "bound": state.aux.bound.detach().cpu().numpy()}
    return tree


def state_from_snapshot(engine, payload: dict, meta: dict):
    """A fresh state with the snapshot's weights: zero Adam moments, the EMA
    shadow re-seeded from the weights (a shadow left at the random init
    would make every render read it), the snapshot's step and grid."""
    from ..io.convert import grid_from_numpy

    engine.load_flax_params(payload["params"]["coarse"])
    state = engine.init_state(keep_weights=True)
    state.step.fill_(int(meta.get("step", 0)))
    occ = payload.get("occupancy")
    if occ is not None and state.aux is not None:
        state.aux = grid_from_numpy(occ["density"], occ["bound"], device=engine.device)
    return state


def main(argv=None) -> dict:
    """Run the command; returns the numbers it printed (``val_psnr``,
    ``test_psnr`` per frame and ``test_mean_psnr``, ``screenshots``,
    ``mesh`` (vertices, triangles)), for callers in the same process."""
    args = build_parser().parse_args(argv)
    if args.mode is not None:
        print("Warning: --mode is no longer in use. It will be ignored. "
              "The mode is automatically chosen based on the scene.")
    from .._device import resolve_device
    from ..io.snapshot import load_snapshot, save_snapshot
    from ..train.trainer import Trainer

    device = resolve_device(args.device)
    trainer = Trainer(make_config(args), device=device)
    engine = trainer.engine
    state = engine.init_state()
    out: dict = {}

    if args.load_snapshot:
        payload, meta = load_snapshot(args.load_snapshot)
        state = state_from_snapshot(engine, payload, meta)
        print(f"Loaded snapshot {args.load_snapshot} at step {meta.get('step', 0)}")

    if args.n_steps and int(state.step) < args.n_steps:
        # Trainer.fit: the same chunked dispatch and occupancy refreshes as
        # every other training run
        res = trainer.fit(max_iters=args.n_steps, state=state)
        state = res.state
        v = trainer.validate(state)
        if v:
            print(f"val psnr: {v['val_psnr']:.2f} dB")
            out["val_psnr"] = v["val_psnr"]

    if args.save_snapshot:
        from ..train.config import config_to_json

        save_snapshot(args.save_snapshot, snapshot_tree(engine, state),
                      {"step": int(state.step), "engine": "ngp",
                       "config": json.loads(config_to_json(trainer.cfg))})
        print(f"Saved snapshot to {args.save_snapshot}")

    if args.test_transforms:
        out.update(_test_transforms(trainer, state, args))

    if args.screenshot_transforms:
        out["screenshots"] = _screenshots(trainer, state, args)

    if args.save_mesh:
        from ..export.mesh import extract_mesh_from_engine
        from ..train.loop import eval_params

        verts, tris = extract_mesh_from_engine(
            engine, eval_params(state), resolution=args.marching_cubes_res,
            iso=args.marching_cubes_density_thresh, path=args.save_mesh)
        print(f"Saved mesh to {args.save_mesh}: {len(verts)} vertices, "
              f"{len(tris)} triangles")
        out["mesh"] = (len(verts), len(tris))
    trainer.close()
    return out


def _render_pose(trainer, state, pose, W, H):
    """(H, W, 3) uint8 of the standard renderer at ``pose``, with the
    dataset's intrinsics scaled to W x H."""
    from ..data.types import Intrinsics
    from ..train.loop import eval_params

    ds = trainer.dataset
    intr = ds.intrinsics
    if W and H and (W != intr.width or H != intr.height):
        intr = Intrinsics(intr.fl_x * W / intr.width, intr.fl_y * H / intr.height,
                          W / 2.0, H / 2.0, W, H,
                          k1=intr.k1, k2=intr.k2, p1=intr.p1, p2=intr.p2)
    render = trainer.engine.make_render_fn(intr, ds.near, ds.far, ds.use_ndc)
    with torch.no_grad(), trainer.engine.bound(eval_params(state)):
        rgb = render(torch.as_tensor(np.asarray(pose), device=trainer.device),
                     state.aux)["rgb"]
    return np.clip(rgb.float().cpu().numpy() * 255, 0, 255).astype("uint8")


def _test_transforms(trainer, state, args) -> dict:
    from ..data.ngp_transforms import load_transforms_json
    from ..metrics.psnr import psnr

    imgs, poses, _, _ = load_transforms_json(args.test_transforms)
    if imgs is None:
        raise SystemExit(f"no images resolvable from {args.test_transforms}")
    scores = []
    for i in range(len(poses)):
        pred = _render_pose(trainer, state, poses[i], imgs.shape[2], imgs.shape[1])
        gt = (imgs[i] * 255).astype("uint8")
        scores.append(psnr(pred.astype(np.float64), gt.astype(np.float64), max_val=255.0))
        print(f"frame {i}: psnr {scores[-1]:.2f} dB")
    print(f"mean psnr: {np.mean(scores):.2f} dB over {len(scores)} frames")
    return {"test_psnr": scores, "test_mean_psnr": float(np.mean(scores))}


def _screenshots(trainer, state, args) -> list:
    from ..data.ngp_transforms import load_transforms_json
    from ..io.image import write_png

    os.makedirs(args.screenshot_dir, exist_ok=True)
    with open(args.screenshot_transforms) as f:
        meta = json.load(f)
    _, poses, intr, _ = load_transforms_json(args.screenshot_transforms, require_images=False)
    names = [os.path.basename(fr.get("file_path", f"frame_{i:04d}.png"))
             for i, fr in enumerate(meta["frames"])]
    W = args.width or intr.width or trainer.dataset.intrinsics.width
    H = args.height or intr.height or trainer.dataset.intrinsics.height
    written = []
    for name, pose in zip(names, poses):
        print(f"rendering {args.screenshot_dir}/{name}")
        img = _render_pose(trainer, state, pose, W, H)
        path = os.path.join(args.screenshot_dir, os.path.splitext(name)[0] + ".png")
        write_png(path, img)
        written.append(path)
    print(f"wrote {len(poses)} renders to {args.screenshot_dir}")
    return written


if __name__ == "__main__":
    main()
