"""sfm2nerf: COLMAP-free pose recovery -> instant-ngp transforms.json.

The in-framework replacement for the reference's COLMAP fallback pipeline
(colmap feature_extractor -> exhaustive_matcher -> mapper -> colmap2nerf).
Same output contract as ``cli/colmap2nerf.py``, no external binary:

    python -m nerf_kinematics_tpu_torch.cli.sfm2nerf \
        --images datasets/fox49/images --out fox_dir/transforms.json \
        --val-images datasets/fox49/val/images

``--val-images``: extra frames registered in the SAME reconstruction but
written to a separate ``transforms_val.json`` (held out of training).

Counterpart of ``nerf_kinematics_tpu/cli/sfm2nerf.py``, with the same flags
plus ``--device``: where the bundle adjustments run (default the GPU;
``--device cpu`` runs them on the CPU). The front-end needs cv2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--images", required=True, help="directory of images")
    ap.add_argument("--val-images", default=None,
                    help="optional directory of held-out validation images")
    ap.add_argument("--out", required=True, help="output transforms.json path")
    ap.add_argument("--aabb_scale", type=float, default=16.0)
    ap.add_argument("--max_dim", type=int, default=1024,
                    help="downscale cap for feature detection")
    ap.add_argument("--window", type=int, default=6,
                    help="sequential matching window")
    ap.add_argument("--ba_iters", type=int, default=3000)
    ap.add_argument("--target_avg_distance", type=float, default=4.0)
    ap.add_argument("--device", default=None,
                    help="where the bundle adjustments run (default: the GPU)")
    args = ap.parse_args(argv)

    from ..poses.sfm import run_sfm, sfm_to_transforms

    exts = ("*.jpg", "*.jpeg", "*.png", "*.JPG", "*.PNG")
    paths = sorted(p for e in exts for p in glob.glob(os.path.join(args.images, e)))
    if not paths:
        raise SystemExit(f"no images found under {args.images}")
    val_paths = []
    if args.val_images:
        val_paths = sorted(
            p for e in exts for p in glob.glob(os.path.join(args.val_images, e))
        )
    # Merge in FILENAME order: captures are video frames, and the sliding
    # matching window assumes list order ≈ temporal order — a val frame
    # appended at the end would only see long-range pairs and fail to
    # register (observed on fox49: val 0001.jpg is the first video frame).
    all_paths = sorted(paths + val_paths, key=os.path.basename)
    val_set = set(val_paths)

    result = run_sfm(all_paths, max_dim=args.max_dim, window=args.window,
                     ba_iters=args.ba_iters, device=args.device)
    print(f"registered {len(result.registered)}/{len(all_paths)} images, "
          f"mean reprojection {result.mean_reproj_px:.2f}px")

    full = sfm_to_transforms(
        result, all_paths, aabb_scale=args.aabb_scale,
        target_avg_distance=args.target_avg_distance,
    )
    train_frames = [
        (i, fr) for i, fr in zip(result.registered, full["frames"])
        if all_paths[i] not in val_set
    ]
    val_frames = [
        (i, fr) for i, fr in zip(result.registered, full["frames"])
        if all_paths[i] in val_set
    ]

    out_train = {**full, "frames": [fr for _, fr in train_frames]}
    with open(args.out, "w") as f:
        json.dump(out_train, f, indent=2)
    print(f"wrote {args.out} ({len(train_frames)} train frames)")

    if val_paths:
        val_path = args.out.replace(".json", "_val.json")
        out_val = {**full, "frames": [fr for _, fr in val_frames]}
        with open(val_path, "w") as f:
            json.dump(out_val, f, indent=2)
        print(f"wrote {val_path} ({len(val_frames)} val frames)")


if __name__ == "__main__":
    main()
