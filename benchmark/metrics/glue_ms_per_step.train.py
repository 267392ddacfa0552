"""Device milliseconds a train step of kernels that are not the program's
own CUDA kernels (PyTorch's: sampling, compositing, gathers, Adam, the
refresh's MLP). Moves ``train_rays_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.glue_ms(ctx)
