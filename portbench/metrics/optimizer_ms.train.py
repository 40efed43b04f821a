"""optimizer_ms.train: device milliseconds a training step spends in
its ``train_step.optimizer`` range (clipping and the update)."""
from portbench import readers


def read(ctx):
    return readers.range_ms(ctx, "optimizer")
