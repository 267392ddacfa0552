"""Pose-diversity / parallax analysis — the capture-quality diagnostic.

Reproduces the reference's ``paralaje.ipynb`` ``analyze_poses`` metrics
(cell 0, lines 8-43): camera positions are normalized per-axis to [-1, 1],
then per-dataset statistics are computed — num_frames, ``mean_distance``
(mean distance from the position centroid), ``spatial_std`` (mean per-axis
std), ``spatial_range`` (mean per-axis range / 2), and ``directional_std``
(mean per-axis std of the forward vectors -R[:, 2]).

Golden validation: the wheel capture's directional_std reproduces the
notebook output exactly (0.13272; 11 frames). The notebook's positional
numbers (mean_distance 1.0197, spatial_std 0.3271, spatial_range 0.9742)
were computed with the three datasets' normalization coupled through shared
notebook state over fox/lego transforms that are gitignored in the reference
snapshot, so they are not bit-reproducible here; the qualitative diagnosis
(wheel = low parallax ⇒ <10 dB failure mode) is preserved and tested.

Counterpart of ``nerf_kinematics_tpu/metrics/parallax.py`` (numpy, the same
arithmetic). matplotlib is imported inside ``plot_pose_clouds`` only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np


@dataclass
class PoseMetrics:
    label: str
    num_frames: int
    mean_distance: float
    spatial_std: float
    spatial_range: float
    directional_std: float

    def as_dict(self) -> dict:
        return {
            "label": self.label,
            "num_frames": self.num_frames,
            "mean_distance": self.mean_distance,
            "spatial_std": self.spatial_std,
            "spatial_range": self.spatial_range,
            "directional_std": self.directional_std,
        }


def analyze_poses(poses: np.ndarray, label: str = "dataset") -> PoseMetrics:
    """Compute parallax metrics for (N, 4, 4) camera-to-world poses."""
    poses = np.asarray(poses, np.float64)
    positions = poses[:, :3, 3]
    forwards = -poses[:, :3, 2]

    # Normalize positions per-axis to [-1, 1] (reference lines 22-27).
    pmin, pmax = positions.min(0), positions.max(0)
    span = np.where(pmax - pmin > 1e-12, pmax - pmin, 1.0)
    norm = 2.0 * (positions - pmin) / span - 1.0

    centroid = norm.mean(0)
    mean_distance = float(np.linalg.norm(norm - centroid, axis=1).mean())
    spatial_std = float(norm.std(0).mean())
    spatial_range = float((norm.max(0) - norm.min(0)).mean() / 2.0)
    directional_std = float(forwards.std(0).mean())

    return PoseMetrics(
        label=label,
        num_frames=int(poses.shape[0]),
        mean_distance=mean_distance,
        spatial_std=spatial_std,
        spatial_range=spatial_range,
        directional_std=directional_std,
    )


def analyze_transforms_json(path: str, label: Optional[str] = None) -> PoseMetrics:
    """Analyze a transforms.json file's frames (the notebook's input mode)."""
    import json

    with open(path) as f:
        meta = json.load(f)
    mats = [
        fr.get("transform_matrix", fr.get("transform_matrix_start"))
        for fr in meta["frames"]
    ]
    poses = np.asarray([m for m in mats if m is not None], np.float64)
    return analyze_poses(poses, label or path)


def summary_table(metrics: Sequence[PoseMetrics]) -> str:
    """Plain-text comparison table (the notebook's pandas summary)."""
    cols = ["label", "num_frames", "mean_distance", "spatial_std",
            "spatial_range", "directional_std"]
    rows = [[str(getattr(m, c)) if c in ("label", "num_frames")
             else f"{getattr(m, c):.4f}" for c in cols] for m in metrics]
    widths = [max(len(c), *(len(r[i]) for r in rows)) for i, c in enumerate(cols)]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    return "\n".join([fmt.format(*cols)] + [fmt.format(*r) for r in rows])


def plot_pose_clouds(metrics_and_poses, path: str) -> None:
    """3D quiver plot of camera positions + forward vectors per dataset
    (the notebook's visualization; results/paralaje.png analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    colors = ["tab:red", "tab:blue", "tab:green", "tab:orange", "tab:purple"]
    for i, (label, poses) in enumerate(metrics_and_poses):
        poses = np.asarray(poses)
        pos = poses[:, :3, 3]
        pmin, pmax = pos.min(0), pos.max(0)
        span = np.where(pmax - pmin > 1e-12, pmax - pmin, 1.0)
        norm = 2.0 * (pos - pmin) / span - 1.0
        fwd = -poses[:, :3, 2]
        c = colors[i % len(colors)]
        ax.scatter(*norm.T, color=c, label=label, s=30)
        ax.quiver(*norm.T, *fwd.T, length=0.25, color=c, alpha=0.6)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> None:
    """CLI mirror of paralaje.ipynb: metrics table (+ optional 3D pose
    plot) for one or more transforms*.json files.

        python -m nerf_kinematics_tpu_torch.metrics.parallax \
            wheel/transforms.json fox/transforms.json --plot paralaje.png
    """
    import argparse
    import json

    ap = argparse.ArgumentParser(description="Pose-diversity analysis")
    ap.add_argument("transforms", nargs="+", help="transforms*.json paths")
    ap.add_argument("--plot", default=None,
                    help="write the 3D pose-cloud quiver PNG here")
    args = ap.parse_args(argv)

    metrics, clouds = [], []
    for path in args.transforms:
        m = analyze_transforms_json(path)
        metrics.append(m)
        with open(path) as f:
            meta = json.load(f)
        mats = [fr.get("transform_matrix", fr.get("transform_matrix_start"))
                for fr in meta["frames"]]
        clouds.append((m.label, np.asarray(
            [x for x in mats if x is not None], np.float64)))
    print(summary_table(metrics))
    if args.plot:
        plot_pose_clouds(clouds, args.plot)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
