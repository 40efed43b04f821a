"""expert_load.prefill: the mean over the window's MoE layers of the
program's ``moe.expert_load``, the most pairs an expert took over the
mean (1 is an even load)."""
from portbench import spans


def read(ctx):
    return spans.counter_mean(ctx, "moe.expert_load")
