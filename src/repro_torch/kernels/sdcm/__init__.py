from .sdcm import (
    A_BUCKETS,
    LAUNCHES,
    a_max_bucket,
    phit_plain,
    sdcm_hit_probs,
    sdcm_hit_probs_plain,
    sdcm_rates,
    sdcm_rates_plain,
)

__all__ = [
    "A_BUCKETS",
    "LAUNCHES",
    "a_max_bucket",
    "phit_plain",
    "sdcm_hit_probs",
    "sdcm_hit_probs_plain",
    "sdcm_rates",
    "sdcm_rates_plain",
]
