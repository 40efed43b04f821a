"""b5_bwd_roofline.train: kernel B5's backward, the least time of
the window's scan gradients (8 N P a token and head) over the device
time of B5's backward kernels, percent."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, readers.B5_BWD, "scan", backward=True)
