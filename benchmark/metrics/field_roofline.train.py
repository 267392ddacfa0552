"""The field's share of its roofline in training, in percent: the least
time the H100 needs for the encoder and MLP work of the window's step points
(``harness/work.py``), over the device time of the kernels that compute
it. The refresh's field work is left out: its MLP runs in PyTorch. Moves
``train_rays_per_s``."""

from benchmark.harness import readers

# The field's kernels on both training routes and their parts: rows 2 and 7
# (the two-call step), rows 3 and 6 (the fused cp route, row 5 inside both
# tile kernels).
FIELD_KERNELS = (
    "nkt_mma_sigma_kernel", "nkt_fused_sigma_kernel",
    "nkt_apply_tile_kernel", "nkt_fused_apply_kernel", "nkt_fused_apply_save_kernel",
    "nkt_fused_tile_kernel", "nkt_train_rays_kernel",
    "nkt_fused_point_bwd_kernel", "nkt_cp_encode_bwd_kernel", "nkt_wgrad_kernel",
    "nkt_wgrad_mma_kernel", "nkt_reduce_partials_kernel", "nkt_table_scan_kernel",
    "nkt_dl_record_kernel", "nkt_dl_nonfinite_kernel",
)


def read(ctx):
    return readers.roofline_pct(ctx, FIELD_KERNELS)
