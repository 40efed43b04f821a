"""train_mfu: the training step's model operations (forward and
backward, nothing recomputed; ``counts.step_flops``) over the traced
window at the card's bf16 peak, percent."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx, train=True)
