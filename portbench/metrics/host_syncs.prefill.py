"""host_syncs.prefill: the host syncs a request that the program counts
(the sum of its ``host_sync.*`` counters in the window)."""
from portbench import spans


def read(ctx):
    return spans.counter_sum(ctx, "host_sync.")
