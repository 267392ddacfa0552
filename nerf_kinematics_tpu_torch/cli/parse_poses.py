"""CLI: convert robot FK poses.txt to Instant-NGP transforms.json.

Flag-compatible with the reference converter (parser_instant_ngp.py:174-190)
and with ``nerf_kinematics_tpu/cli/parse_poses.py``, with the same printed
lines:

    python -m nerf_kinematics_tpu_torch.cli.parse_poses \
        --poses poses.txt --image_folder images_robot --recenter --scale_trans 1.0

PNG images (``--image_ext png``) need no Pillow; JPEG reads through it.
"""

from __future__ import annotations

import argparse

from ..poses.pipeline import convert_poses


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Convert poses.txt to Instant-NGP transforms.json with sharpness"
    )
    p.add_argument("--poses", default="poses.txt", help="Path to poses.txt")
    p.add_argument("--image_folder", default="images_robot", help="Folder with images")
    p.add_argument("--image_prefix", default="TestNERF ", help="Image name prefix")
    p.add_argument("--image_ext", default="jpg", help="Image file extension")
    p.add_argument("--camera_angle_x", type=float, default=87.0, help="Horizontal FOV (deg)")
    p.add_argument("--camera_angle_y", type=float, default=58.0, help="Vertical FOV (deg)")
    p.add_argument("--k1", type=float, default=0.0, help="Radial distortion k1")
    p.add_argument("--k2", type=float, default=0.0, help="Radial distortion k2")
    p.add_argument("--p1", type=float, default=0.0, help="Tangential distortion p1")
    p.add_argument("--p2", type=float, default=0.0, help="Tangential distortion p2")
    p.add_argument("--recenter", action="store_true", help="Recenter cameras to scene origin")
    p.add_argument("--scale_trans", type=float, default=1.0, help="Uniform scale for camera translations")
    p.add_argument("--output", default="transforms.json", help="Output JSON name")
    p.add_argument("--no_sharpness", action="store_true", help="Skip sharpness scoring")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    result = convert_poses(
        poses_path=args.poses,
        image_folder=args.image_folder,
        image_prefix=args.image_prefix,
        image_ext=args.image_ext,
        fov_x_deg=args.camera_angle_x,
        fov_y_deg=args.camera_angle_y,
        k1=args.k1,
        k2=args.k2,
        p1=args.p1,
        p2=args.p2,
        recenter=args.recenter,
        scale_trans=args.scale_trans,
        output=args.output,
        with_sharpness=not args.no_sharpness,
    )
    n_train = len(result.train["frames"])
    w, h = result.train["w"], result.train["h"]
    if args.recenter:
        print(f"Applied recentering, scale factor: {result.scale_factor}")
    print(f"aabb_scale: {result.aabb_scale}")
    print(f"Wrote {result.paths['train']} with {n_train} training frames (size {w}x{h}).")
    print(f"Wrote {result.paths['val']} with 1 validation frame.")
    print(f"Wrote {result.paths['test']} with {len(result.test['frames'])} test frames.")
    print(f"Wrote {result.paths['video']} with {len(result.video['frames'])} video frames.")


if __name__ == "__main__":
    main()
