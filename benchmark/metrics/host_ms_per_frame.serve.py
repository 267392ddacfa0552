"""Mean host milliseconds from the call of the fast renderer to its return,
before the frame is copied to the host: the benchmark's span around
``NGPEngine.make_fast_render_fn``'s function. Moves ``frames_per_s``."""

from benchmark.harness import readers


def read(ctx):
    return readers.mean_ms(ctx.call_s)
