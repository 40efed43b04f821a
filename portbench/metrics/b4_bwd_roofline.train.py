"""b4_bwd_roofline.train: kernel B4's backward, the least time of
the window's attention gradients (8 D a visible pair and head) over
the device time of B4's backward kernels, percent."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, readers.B4_BWD, "attention", backward=True)
