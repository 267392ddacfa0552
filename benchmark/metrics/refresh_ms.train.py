"""Mean host milliseconds of an occupancy refresh in the traced window, from
the program's own span: ``TrainResult.occupancy_refreshes`` (the refresh
ends in a ``synchronize``). Moves ``train_rays_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.mean_ms(ctx.refresh_s)
