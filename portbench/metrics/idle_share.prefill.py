"""idle_share.prefill: percent of the traced prefill window in which
no device operation ran."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
