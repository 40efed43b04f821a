"""idle_share.train: percent of the traced training window in which
no device operation ran."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
