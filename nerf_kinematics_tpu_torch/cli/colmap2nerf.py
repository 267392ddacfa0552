"""CLI: COLMAP text model -> transforms.json.

Flag-compatible with ``nerf_kinematics_tpu/cli/colmap2nerf.py`` (and the
reference invocation ``colmap2nerf --images <dir> --text <colmap_text_dir>
--out transforms.json``):

    python -m nerf_kinematics_tpu_torch.cli.colmap2nerf \
        --images images --text colmap_text --out transforms.json

``--run_colmap`` first runs the ``colmap`` binary (feature_extractor ->
matcher -> mapper -> model_converter) through ``subprocess`` to write the
TXT model, and exits with the same message where the binary is absent.
The conversion is numpy on the host (``poses/colmap.py``); PNG images need
no Pillow for their sharpness.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from ..poses.colmap import colmap_to_transforms


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="COLMAP TXT model → transforms.json")
    p.add_argument("--images", default="images", help="Image directory")
    p.add_argument("--text", default="colmap_text", help="COLMAP TXT model dir")
    p.add_argument("--out", default="transforms.json", help="Output JSON")
    p.add_argument("--aabb_scale", type=float, default=16.0)
    p.add_argument("--keep_colmap_coords", action="store_true",
                   help="Skip reorientation/recentering")
    p.add_argument("--no_sharpness", action="store_true")
    p.add_argument("--run_colmap", action="store_true",
                   help="Run the colmap binary (SfM) before converting")
    p.add_argument("--colmap_matcher", default="exhaustive",
                   choices=["exhaustive", "sequential", "spatial",
                            "transitive", "vocab_tree"])
    p.add_argument("--colmap_db", default="colmap.db")
    p.add_argument("--colmap_camera_model", default="OPENCV",
                   choices=["SIMPLE_PINHOLE", "PINHOLE", "SIMPLE_RADIAL",
                            "RADIAL", "OPENCV"])
    return p


def run_colmap_sfm(args) -> None:
    """Shell out to COLMAP exactly as the reference colmap2nerf does:
    feature_extractor → <matcher>_matcher → mapper → model_converter
    (output TXT into ``args.text``). Errors out with an actionable message
    when the binary is absent."""
    binary = shutil.which("colmap")
    if binary is None:
        sys.exit(
            "colmap2nerf: the `colmap` binary is not installed. Camera poses "
            "cannot be recovered without it (structure-from-motion is out of "
            f"scope for this framework). Install COLMAP, then re-run:\n"
            f"  colmap2nerf --run_colmap --images {args.images} "
            f"--text {args.text} --out {args.out}\n"
            "Everything downstream (TXT import, reorientation, distortion-"
            "aware training) is implemented and tested against synthetic "
            "COLMAP models (tests/test_fox_pipeline.py)."
        )
    sparse = os.path.join(os.path.dirname(args.colmap_db) or ".", "sparse")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(args.text, exist_ok=True)
    steps = [
        [binary, "feature_extractor", "--database_path", args.colmap_db,
         "--image_path", args.images,
         "--ImageReader.camera_model", args.colmap_camera_model,
         "--ImageReader.single_camera", "1"],
        [binary, f"{args.colmap_matcher}_matcher",
         "--database_path", args.colmap_db],
        [binary, "mapper", "--database_path", args.colmap_db,
         "--image_path", args.images, "--output_path", sparse],
        [binary, "model_converter", "--input_path",
         os.path.join(sparse, "0"), "--output_path", args.text,
         "--output_type", "TXT"],
    ]
    for cmd in steps:
        print("running:", " ".join(cmd))
        subprocess.run(cmd, check=True)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.run_colmap:
        run_colmap_sfm(args)
    colmap_to_transforms(
        text_dir=args.text,
        images_dir=args.images,
        aabb_scale=args.aabb_scale,
        out_path=args.out,
        keep_colmap_coords=args.keep_colmap_coords,
        with_sharpness=not args.no_sharpness,
    )


if __name__ == "__main__":
    main()
