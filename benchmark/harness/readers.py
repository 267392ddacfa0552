"""What the per-layer metrics' readers (``benchmark/metrics/<metric>.py``)
share: each reader names its quantity and, where it has one, its group of
kernel names, and calls one of these. Each returns None where the traced
window holds nothing to read."""

from __future__ import annotations

from . import work
from .trace import is_port_kernel


def per_unit(ctx) -> int:
    """Steps (training) or frames (serving) in the traced window."""
    return ctx.steps or ctx.frames


def mean_ms(seconds: list):
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def launches(ctx):
    n = per_unit(ctx)
    return len(ctx.trace.kernels) / n if n and ctx.trace.kernels else None


def glue_ms(ctx):
    """Device ms a step or frame of kernels that are not the program's own."""
    n = per_unit(ctx)
    if not n or not ctx.trace.kernels:
        return None
    return 1e3 * sum(e - s for k, s, e in ctx.trace.kernels if not is_port_kernel(k)) / n


def roofline_pct(ctx, kernels, work_key: str = "field"):
    """The least time for the window's ``work_key`` work over the device
    time of ``kernels``, in percent."""
    seconds = ctx.trace.seconds_of(kernels)
    if not seconds or not ctx.work.get(work_key):
        return None
    return 100.0 * work.least_seconds(ctx.work[work_key]) / seconds


def mfu_pct(ctx):
    """Useful model operations of the traced window over its wall time, as a
    share of the dense bf16 peak."""
    if not ctx.trace.window_s or not ctx.work.get("model"):
        return None
    return 100.0 * ctx.work["model"]["flops"] / ctx.trace.window_s / work.PEAK_FLOPS_BF16


def idle_pct(ctx):
    """One less the union of the device operations' intervals over the
    traced window's wall time, in percent."""
    if not ctx.trace.window_s or not ctx.trace.ops:
        return None
    return 100.0 * max(0.0, 1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
