from .reuse_hist import (
    LAUNCHES,
    NUM_BINS,
    bin_ids_plain,
    ctas_for,
    reuse_histogram,
    reuse_histogram_moments,
    reuse_histogram_moments_plain,
    reuse_histogram_plain,
)

__all__ = [
    "LAUNCHES",
    "NUM_BINS",
    "bin_ids_plain",
    "ctas_for",
    "reuse_histogram",
    "reuse_histogram_moments",
    "reuse_histogram_moments_plain",
    "reuse_histogram_plain",
]
