"""CLI: render the lego-class "machina" benchmark dataset to disk, in
blender format (transforms_{train,val,test}.json + RGBA PNGs) or in LLFF
layout (poses_bounds.npy + images/), on the GPU unless told otherwise.

Usage:
    python -m nerf_kinematics_tpu_torch.cli.make_scene --out cache/machina400 \
        [--resolution 400] [--views 100] [--val 8] [--test 16] [--seed 7] \
        [--samples 1024] [--format blender|llff] [--force] [--device cpu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="output dataset directory")
    ap.add_argument("--resolution", type=int, default=400)
    ap.add_argument("--views", type=int, default=100, help="train views")
    ap.add_argument("--val", type=int, default=8)
    ap.add_argument("--test", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--samples", type=int, default=1024,
                    help="ground-truth volume-render samples per ray")
    ap.add_argument("--format", choices=["blender", "llff"], default="blender",
                    help="on-disk layout: blender transforms JSONs or LLFF "
                         "poses_bounds.npy (forward-facing rig)")
    ap.add_argument("--force", action="store_true", help="render even if cached")
    ap.add_argument("--device", default=None,
                    help="torch device to render on (default: the GPU)")
    args = ap.parse_args(argv)

    t0 = time.perf_counter()
    if args.format == "llff":
        from ..data.machina_llff import write_machina_llff_dataset

        out = write_machina_llff_dataset(
            args.out, resolution=args.resolution, n_views=args.views,
            seed=args.seed, n_samples=args.samples, force=args.force,
            device=args.device)
        desc = f"{args.views} forward-facing views (LLFF layout)"
    else:
        from ..data.machina import write_machina_dataset

        out = write_machina_dataset(
            args.out, resolution=args.resolution, n_train=args.views,
            n_val=args.val, n_test=args.test, seed=args.seed,
            n_samples=args.samples, force=args.force, device=args.device)
        desc = f"{args.views} train / {args.val} val / {args.test} test views"
    dt = time.perf_counter() - t0
    print(f"machina dataset at {out}: {desc} "
          f"@ {args.resolution}x{args.resolution} ({dt:.1f}s)")


if __name__ == "__main__":
    main()
