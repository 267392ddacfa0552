"""CLI: train or evaluate an engine from a YAML config, on the GPU unless
told otherwise.

    python -m nerf_kinematics_tpu_torch.cli.run_nerf --config configs/lego.yml

Flags:
    --eval            render + PSNR the first val view from a checkpoint, and
                      write the GT-vs-render pair under <rundir>/imgs/
    --render-video    render the dataset's novel-view path to PNGs and a
                      video (mp4 with ffmpeg, else an animated GIF)
    --fast            the fast engine's serving renderer for --render-video
    --load-checkpoint a checkpoint step, or a legacy checkpoint{iter}.ckpt
    --max-iters N     override experiment.train_iters
    --export-legacy   also write the reference's checkpoint{iter}.ckpt files
    --device cpu      run on the CPU (the plain versions of the kernels)
    --mesh            data parallelism over the ranks of a process group

``--mesh`` under ``torchrun`` splits each step's rays over the ranks and the
``--fast`` video's frames (the pose batch padded to a multiple of the world
size, the padding dropped); each rank takes ``cuda:{LOCAL_RANK % devices}``
(NCCL when every rank has its own GPU, gloo when they share one or run on
the CPU) and rank 0 alone writes logs, checkpoints, images and the video:

    torchrun --nproc_per_node 2 -m nerf_kinematics_tpu_torch.cli.run_nerf \
        --config configs/machina_ngp.yml --mesh

Without a process group, or with a world of 1, ``--mesh`` is the
single-device path. Counterpart of ``nerf_kinematics_tpu/cli/run_nerf.py``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train/evaluate NeRF (PyTorch/CUDA port)")
    p.add_argument("--config", required=True, help="Path to YAML config (reference schema)")
    p.add_argument("--eval", action="store_true", help="Evaluate instead of train")
    p.add_argument("--render-video", action="store_true", help="Render novel-view path")
    p.add_argument("--fast", action="store_true",
                   help="serving-rate fast renderer for --render-video (fast "
                        "engine: block-shared coarse pass + foreground "
                        "compaction; writes the video and reports fps)")
    p.add_argument("--fast-fg", type=float, default=0.35,
                   help="--fast: fraction of 2x2 blocks (by coarse-composite "
                        "contrast) that get the fine pass")
    p.add_argument("--fast-fine", type=int, default=64,
                   help="--fast: fine samples per ray")
    p.add_argument("--load-checkpoint", default=None, help="Checkpoint step or legacy .ckpt path")
    p.add_argument("--max-iters", type=int, default=None, help="Override train_iters")
    p.add_argument("--mesh", action="store_true",
                   help="Shard rays (and --fast frames) over the ranks of a "
                        "process group (torchrun)")
    p.add_argument("--export-legacy", action="store_true", help="Write torch-layout ckpts too")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on the CPU)")
    return p


def main(argv=None) -> dict:
    """Run the command; returns what it printed as numbers (``val_psnr``,
    ``rays_per_sec``, ``fps``, ``frames``, ``video``), for callers in the
    same process."""
    args = build_parser().parse_args(argv)
    from .._device import resolve_device
    from ..train.config import load_config
    from ..train.trainer import Trainer

    device = args.device
    joined = False  # whether this command joined the group, and leaves it
    if args.mesh:
        from ..parallel.multihost import initialize_multihost, local_rank

        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", local_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        existed = dist.is_initialized()
        joined = initialize_multihost(device=device) and not existed
    device = resolve_device(device)
    cfg = load_config(args.config)
    trainer = Trainer(cfg, device=device, export_legacy=args.export_legacy,
                      use_mesh=args.mesh)

    try:
        if args.eval:
            if not trainer.is_main:
                return {}
            state = load_state(trainer, args.load_checkpoint)
            v = trainer.validate(state)
            if not v:
                raise SystemExit("the dataset has no val split")
            print(f"val_loss={v['val_loss']:.6f} val_psnr={v['val_psnr']:.3f} dB")
            _save_val_images(trainer, v)
            return {"val_psnr": v["val_psnr"], "val_loss": v["val_loss"]}
        if args.render_video:
            state = load_state(trainer, args.load_checkpoint)
            return _render_video(trainer, state, fast=args.fast,
                                 fast_fg=args.fast_fg, fast_fine=args.fast_fine)
        result = trainer.fit(max_iters=args.max_iters)
        if trainer.is_main and result.val_psnr is not None:
            print(f"final val_psnr={result.val_psnr:.3f} dB")
        if trainer.is_main and result.rays_per_sec is not None:
            print(f"throughput={result.rays_per_sec:.0f} rays/s")
        return {"val_psnr": result.val_psnr, "rays_per_sec": result.rays_per_sec,
                "step": int(result.state.step)}
    finally:
        trainer.close()
        if joined:
            dist.destroy_process_group()


def load_state(trainer, load_checkpoint):
    """A fresh state with the weights of ``load_checkpoint``: a legacy
    ``.ckpt`` file (classic engine), a checkpoint step of the run, or, when
    it is None, the run's latest checkpoint (the fresh state when there is
    none). The EMA shadow, when the run keeps one, starts from the loaded
    weights of a legacy file."""
    from ..train.loop import init_ema_shadow

    engine = trainer.engine
    state = engine.init_state()
    if load_checkpoint and os.path.isfile(load_checkpoint):
        from ..io.torch_compat import import_legacy_checkpoint

        if trainer.cfg.engine != "classic":
            raise SystemExit("a legacy .ckpt holds the classic engine's weights")

        legacy = import_legacy_checkpoint(load_checkpoint)
        with torch.no_grad():
            engine.model.coarse.load_state_dict(legacy["state_coarse"])
            if legacy["state_fine"] is not None and engine.model.fine is not None:
                engine.model.fine.load_state_dict(legacy["state_fine"])
            state.step.fill_(legacy["step"])
        state.ema = init_ema_shadow(state.params, trainer.cfg.nerf.ema_decay)
        return state
    restored, _ = trainer.ckpt.restore(
        state, int(load_checkpoint) if load_checkpoint else None,
        layout=engine.layout)
    return restored if restored is not None else state


def _save_val_images(trainer, v):
    """The GT-vs-render pair (the reference's results/.../imgs/{reals,
    rendered} layout)."""
    from ..io.image import write_png

    to_u8 = lambda a: np.clip(np.asarray(a) * 255, 0, 255).astype(np.uint8)
    for sub in ("rendered", "reals"):
        os.makedirs(os.path.join(trainer.rundir, "imgs", sub), exist_ok=True)
    write_png(os.path.join(trainer.rundir, "imgs", "rendered", "val_0.png"),
              to_u8(v["val_image"]))
    ds = trainer.dataset
    write_png(os.path.join(trainer.rundir, "imgs", "reals", "val_0.png"),
              to_u8(ds.images[int(ds.val_idx[0])]))
    print(f"wrote GT-vs-render pair under {trainer.rundir}/imgs/")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _render_video(trainer, state, fast: bool = False, fast_fg: float = 0.35,
                  fast_fine: int = 64) -> dict:
    from ..io.image import write_png, write_video
    from ..train.loop import eval_params

    ds = trainer.dataset
    poses = ds.render_poses
    if poses is None:
        raise SystemExit("dataset has no render path (no *_test_video.json / spiral)")
    outdir = os.path.join(trainer.rundir, "video")
    engine, device = trainer.engine, trainer.device
    mesh = trainer.mesh
    if mesh is not None and not fast:
        mesh = None  # the evaluation renderer runs on rank 0 alone
        if not trainer.is_main:
            return {}

    render = trainer._render
    if fast:
        # the serving recipe: the compaction's savings re-spent on fine depth
        from ..rendering.fast_render import FastRenderSettings

        if not hasattr(engine, "make_fast_render_fn"):
            raise SystemExit("--fast needs the fast engine (engine: ngp)")
        val = trainer.cfg.nerf.validation
        settings = FastRenderSettings(num_coarse=val.num_coarse, num_fine=fast_fine,
                                      fg_fraction=fast_fg,
                                      white_background=val.white_background)
        render = engine.make_fast_render_fn(ds.intrinsics, ds.near, ds.far,
                                            ds.use_ndc, settings=settings)

    # All frames in flight and one synchronisation before the clock stops;
    # the poses go to the device in one transfer, and a first frame (the
    # kernels' first launch) is rendered before the clock starts.
    n = len(poses)
    pose_arr = np.asarray(poses)
    pad = 0
    if mesh is not None:
        # frames split over the ranks: pad the pose batch to a multiple of
        # the world size with the last pose; the padded frames are dropped
        pad = (-n) % mesh.world
        pose_arr = np.concatenate([pose_arr] + [pose_arr[-1:]] * pad)
    dposes = torch.as_tensor(pose_arr, dtype=torch.float32, device=device)
    with torch.no_grad(), engine.bound(eval_params(state)):
        render(dposes[0], state.aux)["rgb"].sum().item()
        t0 = time.perf_counter()
        if mesh is not None:
            batch = engine.make_fast_render_batch(ds.intrinsics, ds.near, ds.far,
                                                  ds.use_ndc, settings=settings)
            outs = list(batch(dposes, state.aux)["rgb"][:n])
        else:
            outs = [render(p, state.aux)["rgb"] for p in dposes]
        _sync(device)
        dt = (time.perf_counter() - t0) * n / (n + pad)
    if not trainer.is_main:
        return {"frames": n, "fps": n / dt}
    os.makedirs(outdir, exist_ok=True)

    frames = []
    for i, o in enumerate(outs):
        f = o.float().cpu().numpy()
        frames.append(f)
        write_png(os.path.join(outdir, f"frame_{i:04d}.png"),
                  np.clip(f * 255, 0, 255).astype(np.uint8))
    video = write_video(os.path.join(outdir, "video.mp4"), frames, fps=24)
    fps = n / dt
    print(f"wrote {n} frames to {outdir} ({fps:.1f} fps render{' [fast]' if fast else ''}); "
          f"video {video}")
    return {"frames": n, "fps": fps, "video": video, "outdir": outdir}


if __name__ == "__main__":
    main()
