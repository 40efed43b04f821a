from .sdcm import (
    A_BUCKETS,
    LAUNCHES,
    META_COLUMNS,
    a_max_bucket,
    phit_plain,
    sdcm_hit_probs,
    sdcm_hit_probs_plain,
    pow2,
    sdcm_rates,
    sdcm_rates_plain,
    sdcm_rates_ragged,
    sdcm_rates_ragged_plain,
)

__all__ = [
    "A_BUCKETS",
    "LAUNCHES",
    "META_COLUMNS",
    "a_max_bucket",
    "phit_plain",
    "sdcm_hit_probs",
    "sdcm_hit_probs_plain",
    "pow2",
    "sdcm_rates",
    "sdcm_rates_plain",
    "sdcm_rates_ragged",
    "sdcm_rates_ragged_plain",
]
