"""The share of the traced window's wall time in which no operation ran on
the device, in percent. Moves ``frames_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.idle_pct(ctx)
