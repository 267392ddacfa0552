"""Device kernels in the traced window per train step, the occupancy
refreshes' included. Moves ``train_rays_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.launches(ctx)
