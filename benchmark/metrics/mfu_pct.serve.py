"""Useful model operations of the traced serving window (the frames' field
work, ``harness/work.py``) over its wall time, as a share of the H100's
dense bf16 peak, in percent. Moves ``frames_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
