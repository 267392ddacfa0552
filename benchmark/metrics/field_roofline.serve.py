"""The field's share of its roofline in serving, in percent: the least time
the H100 needs for the encoder and MLP forward at the frames' coarse and
fine points (``harness/work.py``), over the device time of the kernels
that compute it. Moves ``frames_per_s``."""

from benchmark.harness import readers

# Row 3 of the port's kernel table (and its non-finite table scan).
FIELD_KERNELS = ("nkt_apply_tile_kernel", "nkt_fused_apply_kernel", "nkt_table_scan_kernel")


def read(ctx):
    return readers.roofline_pct(ctx, FIELD_KERNELS)
