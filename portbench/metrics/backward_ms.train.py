"""backward_ms.train: device milliseconds a training step spends in
its backward (``readers.range_ms``)."""
from portbench import readers


def read(ctx):
    return readers.range_ms(ctx, "backward")
