"""Mean host milliseconds of a frame's call in the traced window, from
inside the program: its span ``frame`` (``NGPEngine.make_fast_render_fn``,
the rays to the pasted maps; ``host_ms_per_frame.serve`` times the same call
from outside). Moves ``frames_per_s``."""

from benchmark.harness import spans


def read(ctx):
    return spans.mean_ms("frame")
