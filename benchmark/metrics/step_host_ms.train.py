"""Mean host milliseconds of one train step's enqueue in the traced window:
the program's span ``step`` (``train/loop.py``, from the batch to the
optimizer's update, each kernel wrapper inside). Moves
``train_rays_per_s``."""

from benchmark.harness import spans


def read(ctx):
    return spans.mean_ms("step")
