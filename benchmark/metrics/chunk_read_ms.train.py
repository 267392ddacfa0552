"""Mean host milliseconds of a chunk's one read of the device in the traced
window: the program's span ``fit.read`` (``train/trainer.py``, the losses'
``tolist``), how far the device lags the host when the chunk's last step
is enqueued. Moves ``train_rays_per_s``."""

from benchmark.harness import spans


def read(ctx):
    return spans.mean_ms("fit.read")
