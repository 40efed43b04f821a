from repro_torch.core.reuse.batched import (
    count_leq_before,
    reuse_distances_offline,
)
from repro_torch.core.reuse.distance import (
    INF_RD,
    reuse_distances,
    reuse_distances_ref,
)
from repro_torch.core.reuse.profile import (
    ReuseProfile,
    profile_from_distances,
    profile_from_pairs,
)

__all__ = [
    "INF_RD",
    "ReuseProfile",
    "count_leq_before",
    "profile_from_distances",
    "profile_from_pairs",
    "reuse_distances",
    "reuse_distances_offline",
    "reuse_distances_ref",
]
