"""CLI: the thesis's full pipeline in one command (BASELINE.json config 5).

robot FK capture → transforms.json → fast-NeRF training → held-out PSNR →
360° novel-view video → mesh export → parallax analysis report.

    python -m nerf_kinematics_tpu_torch.cli.full_pipeline \\
        --capture <dir with poses.txt and images_robot/> \\
        --out runs/wheel --steps 2000

Counterpart of ``nerf_kinematics_tpu/cli/full_pipeline.py``, with the same
flags plus ``--device`` (default: the GPU). A capture of PNG images
(``TestNERF k.png``, and no JPEG) is converted as PNG. The video is written by
``io/image.py::write_video`` (a GIF where no ``ffmpeg`` is on ``PATH``), and
the report names the file written; the mesh goes through the native core of
``export/mesh.py``. ``report.json`` also holds each stage's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..train.loop import eval_params


def build_parser():
    p = argparse.ArgumentParser(description="FK capture → NeRF full pipeline")
    p.add_argument("--capture", required=True,
                   help="Capture dir with poses.txt + images")
    p.add_argument("--out", required=True, help="Output directory")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--fine-samples", type=int, default=64)
    p.add_argument("--downsample", type=int, default=8,
                   help="Image downsample factor for training")
    p.add_argument("--encoder", default="cp", choices=["cp", "cp_pallas", "hash"])
    p.add_argument("--mesh-res", type=int, default=128)
    p.add_argument("--video-frames", type=int, default=60)
    p.add_argument("--skip-video", action="store_true")
    p.add_argument("--skip-mesh", action="store_true")
    p.add_argument("--limit-frames", type=int, default=0,
                   help="Use only the first N capture frames (the reference's "
                        "fox10/fox20/fox49 frames-vs-quality ablation)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the GPU; 'cpu' to run on the CPU)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    from ..metrics.parallax import analyze_transforms_json, summary_table
    from ..poses.pipeline import convert_poses

    seconds = {}

    # 1. Pose conversion (recenter, unit radius, Z-flip, orbit synthesis).
    t0 = time.perf_counter()
    tf_path = os.path.join(args.out, "transforms.json")
    image_folder = _find_images(args.capture)
    conv = convert_poses(
        poses_path=os.path.join(args.capture, "poses.txt"),
        image_folder=image_folder,
        image_ext=_image_ext(image_folder),
        recenter=True,
        scale_trans=1.0,
        output=tf_path,
        with_sharpness=True,
    )
    seconds["convert"] = time.perf_counter() - t0
    print(f"[1/5] converted {len(conv.train['frames'])} train + 1 val frames "
          f"({seconds['convert']:.1f}s)")

    # 2. Parallax diagnosis.
    t0 = time.perf_counter()
    m = analyze_transforms_json(tf_path, "capture")
    print("[2/5] parallax analysis:")
    print(summary_table([m]))
    low_parallax = m.directional_std < 0.3
    if low_parallax:
        print("  WARNING: low view-direction diversity — expect the "
              "low-parallax failure mode (PSNR < 10 dB, cf. the wheel study).")
    with open(os.path.join(args.out, "parallax.json"), "w") as f:
        json.dump(m.as_dict(), f, indent=2)
    seconds["parallax"] = time.perf_counter() - t0

    # 3. Train the fast engine.
    from ..data import load_dataset
    from ..models.ngp import NGPConfig
    from ..rendering.renderer import RenderSettings
    from ..train.config import (
        Config, DatasetConfig, ExperimentConfig, NeRFConfig, OptimizerConfig,
        SchedulerConfig,
    )
    from ..train.trainer import Trainer

    t0 = time.perf_counter()
    cfg = Config(
        engine="ngp",
        ngp=NGPConfig(encoder=args.encoder),
        dataset=DatasetConfig(basedir=args.capture, type="robot",
                              downsample_factor=args.downsample,
                              llffhold=8, near=0.05, far=3.0, no_ndc=True),
        experiment=ExperimentConfig(
            id="pipeline", logdir=args.out, train_iters=args.steps,
            print_every=max(args.steps // 10, 1),
            validate_every=max(args.steps // 4, 1), save_every=args.steps,
        ),
        nerf=NeRFConfig(
            train=RenderSettings(num_coarse=args.samples,
                                 num_fine=getattr(args, "fine_samples"), perturb=True),
            validation=RenderSettings(num_coarse=args.samples,
                                      num_fine=getattr(args, "fine_samples"),
                                      perturb=False),
            num_random_rays=args.batch,
        ),
        optimizer=OptimizerConfig(lr=1e-2),
        scheduler=SchedulerConfig(lr_decay=50, lr_decay_factor=0.33),
    )
    dataset = load_dataset(
        cfg.dataset, white_background=cfg.nerf.train.white_background,
        device=args.device,
    )
    if args.limit_frames:
        dataset.train_idx = dataset.train_idx[: args.limit_frames]
        print(f"  ablation: training on {len(dataset.train_idx)} frames")
    trainer = Trainer(cfg, dataset=dataset, device=args.device)
    try:
        result = trainer.fit()
        state = result.state
        seconds["train"] = time.perf_counter() - t0
        print(f"[3/5] trained {args.steps} steps: val psnr "
              f"{result.val_psnr if result.val_psnr is not None else float('nan'):.2f} dB, "
              f"{result.rays_per_sec or 0:.0f} rays/s ({seconds['train']:.1f}s)")

        # 4. 360° novel-view video from the converter's orbit path.
        t0 = time.perf_counter()
        video = None
        if not args.skip_video:
            from ..data.ngp_transforms import load_transforms_json
            from ..io.image import write_video

            _, vposes, _, _ = load_transforms_json(
                tf_path.replace(".json", "_test_video.json"), require_images=False
            )
            vposes = vposes[: args.video_frames]
            # all frames in flight, one read of the device at the end
            dposes = torch.as_tensor(np.asarray(vposes), dtype=torch.float32,
                                     device=trainer.device)
            with torch.no_grad(), trainer.engine.bound(eval_params(state)):
                outs = [trainer._render(p, state.aux)["rgb"] for p in dposes]
                frames = [o.float().cpu().numpy() for o in outs]
            video = write_video(os.path.join(args.out, "orbit.mp4"), frames, fps=15)
            seconds["video"] = time.perf_counter() - t0
            print(f"[4/5] wrote {len(frames)}-frame orbit video: {video} "
                  f"({seconds['video']:.1f}s)")
        else:
            print("[4/5] video skipped")

        # 5. Mesh export.
        t0 = time.perf_counter()
        mesh = None
        if not args.skip_mesh:
            from ..export.mesh import extract_mesh_from_engine

            mesh = os.path.join(args.out, "scene.ply")
            verts, tris = extract_mesh_from_engine(
                trainer.engine, eval_params(state), resolution=args.mesh_res,
                iso=2.5, path=mesh,
            )
            seconds["mesh"] = time.perf_counter() - t0
            print(f"[5/5] mesh: {len(verts)} verts / {len(tris)} tris → {mesh} "
                  f"({seconds['mesh']:.1f}s)")
        else:
            print("[5/5] mesh skipped")
    finally:
        trainer.close()

    report = {
        "val_psnr": result.val_psnr,
        "rays_per_sec": result.rays_per_sec,
        "steps": args.steps,
        "parallax": m.as_dict(),
        "low_parallax_warning": bool(low_parallax),
        "video": video,
        "mesh": mesh,
        "stage_seconds": seconds,
    }
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def _image_ext(folder):
    """The converter's image extension: the reference's "jpg", or "png"
    where the folder holds PNG images and no JPEG (a capture the card can
    read without Pillow)."""
    names = [n.lower() for n in os.listdir(folder)]
    if not any(n.endswith(".jpg") for n in names) and any(n.endswith(".png") for n in names):
        return "png"
    return "jpg"


def _find_images(capture):
    for name in ("images_robot", "images"):
        d = os.path.join(capture, name)
        if os.path.isdir(d):
            return d
    raise SystemExit(f"no image folder under {capture}")


if __name__ == "__main__":
    main()
