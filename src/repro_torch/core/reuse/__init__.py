from repro_torch.core.reuse.batched import (
    count_leq_before,
    reuse_distances_batched,
    reuse_distances_offline,
)
from repro_torch.core.reuse.crd import (
    MulticoreProfiles,
    crd_profile,
    multicore_profiles,
)
from repro_torch.core.reuse.distance import (
    DEFAULT_WINDOW,
    INF_RD,
    iter_address_windows,
    per_set_reuse_distances,
    reuse_distance_windows,
    reuse_distance_windows_device,
    reuse_distances,
    reuse_distances_ref,
    reuse_distances_streaming,
)
from repro_torch.core.reuse.fused import (
    FusedReuseHistogram,
    binned_profile_from_distances,
    binned_profile_windows,
    profile_from_binned_hist,
)
from repro_torch.core.reuse.profile import (
    ReuseProfile,
    log2_binned,
    profile_from_distances,
    profile_from_distances_incremental,
    profile_from_pairs,
    profile_from_trace,
)
from repro_torch.core.reuse.sampled import (
    SAMPLE_BOUND_DELTA,
    sample_lines_mask,
    sampled_profile_windows,
    sampled_reuse_profile,
    sampling_error_bound,
)

__all__ = [
    "DEFAULT_WINDOW",
    "FusedReuseHistogram",
    "INF_RD",
    "MulticoreProfiles",
    "ReuseProfile",
    "SAMPLE_BOUND_DELTA",
    "binned_profile_from_distances",
    "binned_profile_windows",
    "count_leq_before",
    "crd_profile",
    "iter_address_windows",
    "log2_binned",
    "multicore_profiles",
    "per_set_reuse_distances",
    "profile_from_binned_hist",
    "profile_from_distances",
    "profile_from_distances_incremental",
    "profile_from_pairs",
    "profile_from_trace",
    "reuse_distance_windows",
    "reuse_distance_windows_device",
    "reuse_distances",
    "reuse_distances_batched",
    "reuse_distances_offline",
    "reuse_distances_ref",
    "reuse_distances_streaming",
    "sample_lines_mask",
    "sampled_profile_windows",
    "sampled_reuse_profile",
    "sampling_error_bound",
]
