"""The destination-tile plans' counting sort and scans
(csrc/dest_tiles.cuh), shared by K2 and K4: their device time counts
against the port kernels, no bound is counted for them."""

KERNELS = ("scan_reduce_kernel", "scan_top_kernel", "scan_down_kernel",
           "digit_hist_kernel", "digit_scatter_kernel", "key_starts_kernel",
           "tile_work_kernel")
BOUND_PER_LAUNCH_OF = ()


def nbytes(v):
    return 0


def flops(v):
    return 0
