"""prefill_mfu: the prefills' model operations (logits at the last
position; ``counts.step_flops``) over the traced window at the card's
bf16 peak, percent."""
from portbench import readers


def read(ctx):
    return readers.mfu(ctx, train=False)
