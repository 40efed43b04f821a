"""peak_mem_gib.train: the training window's peak of allocated device
memory, GiB."""
from portbench import readers


def read(ctx):
    return readers.peak_gib(ctx)
