"""b4_fwd_roofline.prefill: kernel B4's forward in prefill, the
least time of the window's attention (4 D a visible pair and head)
over the device time of every B4 forward form, percent."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, readers.B4_FWD, "attention", backward=False)
