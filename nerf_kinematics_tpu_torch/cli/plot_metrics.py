"""CLI: training-curve PNGs from a run's metrics.jsonl, in the reference's
exported-curve layout (results/<scene>/nerf-pytorch/loss/{train,val}_{loss,
psnr}.png):

    python -m nerf_kinematics_tpu_torch.cli.plot_metrics logs/<run-id> [--out dir]

It needs matplotlib, imported inside :func:`main`: it runs on a machine that
has it (a CPU workstation), not on the GPU machine the port trains on, which
has none. It draws what the metrics file holds and touches no device.
Counterpart of ``nerf_kinematics_tpu/cli/plot_metrics.py``.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import defaultdict

CANONICAL = ["train/loss", "train/psnr", "val/loss", "val/psnr"]


def load_series(metrics_path: str):
    series = defaultdict(lambda: ([], []))
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            xs, ys = series[rec["tag"]]
            xs.append(rec["step"])
            ys.append(rec["value"])
    return series


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="Plot metrics.jsonl curves")
    p.add_argument("rundir", help="Run directory containing metrics.jsonl")
    p.add_argument("--out", default=None, help="Output dir (default <rundir>/loss)")
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    metrics_path = os.path.join(args.rundir, "metrics.jsonl")
    outdir = args.out or os.path.join(args.rundir, "loss")
    os.makedirs(outdir, exist_ok=True)

    series = load_series(metrics_path)
    written = []
    for tag in list(series):
        xs, ys = series[tag]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.plot(xs, ys, linewidth=1.2)
        ax.set_xlabel("iteration")
        ax.set_ylabel(tag.split("/")[-1])
        ax.set_title(tag)
        if tag.endswith("loss"):
            ax.set_yscale("log")
        ax.grid(alpha=0.3)
        fname = tag.replace("/", "_") + ".png"
        fig.tight_layout()
        fig.savefig(os.path.join(outdir, fname), dpi=110)
        plt.close(fig)
        written.append(fname)
    print(f"wrote {len(written)} plots to {outdir}: {', '.join(sorted(written))}")
    return written


if __name__ == "__main__":
    main()
