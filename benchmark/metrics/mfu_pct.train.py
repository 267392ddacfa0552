"""Useful model operations of the traced training window (every step's
field work and every refresh's density queries, ``harness/work.py``) over
its wall time, as a share of the H100's dense bf16 peak, in percent. Moves
``train_rays_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.mfu_pct(ctx)
