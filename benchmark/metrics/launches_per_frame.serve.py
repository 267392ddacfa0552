"""Device kernels in the traced window per served frame. Moves
``frames_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.launches(ctx)
