"""b5_fwd_roofline.prefill: kernel B5's forward in prefill, the
least time of the window's scans (4 N P a token and head) over the
device time of B5's forward kernels, percent."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, readers.B5_FWD, "scan", backward=False)
