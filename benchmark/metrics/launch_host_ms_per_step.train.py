"""Host milliseconds a train step of the kernels' wrappers in the traced
window: the program's spans ``launch.<kernel>`` (``ops/*_cuda.py``, from a
wrapper's entry to the return of its launch; the occupancy refreshes'
included) summed over the window's steps. Moves ``train_rays_per_s``."""

from benchmark.harness import readers, spans


def read(ctx):
    return spans.launch_ms(readers.per_unit(ctx))
