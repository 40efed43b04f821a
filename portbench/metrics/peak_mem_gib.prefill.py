"""peak_mem_gib.prefill: the prefill window's peak of allocated
device memory, GiB (the digests kept for the comparison included)."""
from portbench import readers


def read(ctx):
    return readers.peak_gib(ctx)
