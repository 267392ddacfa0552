"""The work a configuration's field does, counted from its widths: the
operations and bytes of the encoder and the two MLPs, per point and per
step or frame, and the H100's published peaks.

Operations follow ``nerf_kinematics_tpu_torch/utils/flops.py`` at commit
83f8678 (``cp_encoder_useful_flops_per_point``, ``_mlp_fwd``): the CP
encoder at what its interpolation needs, two rows per level and axis
(12 L C a point forward, as much again backward); a dense layer 2 a b
forward and three times that trained (dW and dx). The MLP widths are the
model's as it runs (``models/ngp.py``): ``density_layers`` layers in all,
the output included, and ``color_layers`` likewise, the color MLP taking
the whole density output beside the spherical harmonics.
Bytes count each input once and each output once: a point's position and
direction (and for training its interval, its ray's target and its ray's
error), its output, and the parameters (read once a call, their gradient
written once a call).
"""

from __future__ import annotations

# NVIDIA H100 SXM, dense, from its data sheet: the denominators of every
# roofline share and MFU the benchmark reports.
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES_PER_S = 3.35e12


def mlp_flops(dims) -> int:
    """Forward operations of a dense chain, ``dims`` the (in, out) pairs."""
    return sum(2 * a * b for a, b in dims)


def encoder_flops(spec: dict) -> int:
    """Forward operations of the CP encoder a point (useful count)."""
    cp = spec["cp"]
    return 3 * 2 * 2 * cp["n_levels"] * cp["n_components"]


def n_params(spec: dict) -> int:
    cp = spec["cp"]
    n = cp["n_levels"] * 3 * cp["table_size"] * cp["n_components"]
    for a, b in spec["density_dims"] + spec["color_dims"]:
        n += a * b + b
    return n


def point_flops(spec: dict, color: bool = True, trained: bool = False) -> int:
    enc = encoder_flops(spec)
    mlp = mlp_flops(spec["density_dims"]) + (mlp_flops(spec["color_dims"]) if color else 0)
    return (2 * enc + 3 * mlp) if trained else (enc + mlp)


def train_step(spec: dict, rays: int, num_coarse: int, num_fine: int) -> dict:
    """Field work of one train step: with fine samples the coarse pass is
    density only and forward only, the fine pass forward and backward;
    without, the coarse pass is trained."""
    pbytes = 4 * n_params(spec)
    if num_fine:
        coarse = rays * num_coarse
        flops = (coarse * point_flops(spec, color=False)
                 + rays * num_fine * point_flops(spec, trained=True))
        nbytes = coarse * (12 + 4) + rays * num_fine * (12 + 12 + 4) + rays * (12 + 4)
        calls = 2
    else:
        flops = rays * num_coarse * point_flops(spec, trained=True)
        nbytes = rays * num_coarse * (12 + 12 + 16) + rays * 12
        calls = 1
    return {"flops": float(flops), "bytes": float(nbytes + calls * pbytes + pbytes)}


def refresh(spec: dict, points: int) -> dict:
    """An occupancy refresh: density at ``points`` points."""
    return {"flops": float(points * point_flops(spec, color=False)),
            "bytes": float(points * (12 + 4) + 4 * n_params(spec))}


def frame(spec: dict, blocks: int, pixels_fine: int, num_coarse: int,
          num_fine: int) -> dict:
    """A served frame: the whole field forward at the blocks' coarse points
    and the chosen pixels' fine points."""
    pts = blocks * num_coarse + pixels_fine * num_fine
    return {"flops": float(pts * point_flops(spec)),
            "bytes": float(pts * (12 + 12 + 16) + 2 * 4 * n_params(spec))}


def least_seconds(w: dict) -> float:
    """The least time the H100 could take for the work ``w``."""
    return max(w["flops"] / PEAK_FLOPS_BF16, w["bytes"] / PEAK_BYTES_PER_S)
