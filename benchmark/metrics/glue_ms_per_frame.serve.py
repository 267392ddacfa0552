"""Device milliseconds a frame of kernels that are not the program's own
CUDA kernels. Moves ``frames_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.glue_ms(ctx)
