"""PRD / CRD construction — port of ``repro/core/reuse/crd.py`` (paper
§2.4, Table 3; §3.2–3.3).

* PRD — *private-stack* reuse profile: reuse distances of one core's
  mimicked private trace.
* CRD — *concurrent* reuse profile: reuse distances of the interleaved
  shared trace, exhibiting dilation (remote refs inflate D), overlap
  (shared data between the endpoints deflates it) and interception
  (the reused datum itself is shared).

Mimicry and interleaving are host numpy; the distances are computed on
``device`` (``None`` resolves to the GPU).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.trace.interleave import interleave_traces
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.device import resolve_device

from .distance import reuse_distances
from .profile import ReuseProfile, profile_from_distances


@dataclass(frozen=True)
class MulticoreProfiles:
    num_cores: int
    private: list[ReuseProfile]   # per core, PRD
    shared: ReuseProfile          # CRD of the interleaved trace
    strategy: str


def prd_profiles(
    private_traces: list[LabeledTrace], line_size: int = 1, *, device=None
) -> list[ReuseProfile]:
    dev = resolve_device(device)
    return [
        profile_from_distances(
            reuse_distances(t.addresses, line_size, device=dev))
        for t in private_traces
    ]


def crd_profile(
    private_traces: list[LabeledTrace],
    strategy: str = "round_robin",
    *,
    line_size: int = 1,
    chunk_size: int = 1,
    seed: int = 0,
    device=None,
) -> ReuseProfile:
    shared = interleave_traces(
        private_traces, strategy, chunk_size=chunk_size, seed=seed
    )
    return profile_from_distances(reuse_distances(
        shared.addresses, line_size, device=resolve_device(device)))


def multicore_profiles(
    trace: LabeledTrace,
    num_cores: int,
    *,
    strategy: str = "round_robin",
    line_size: int = 1,
    chunk_size: int | None = None,
    seed: int = 0,
    device=None,
) -> MulticoreProfiles:
    """One sequential trace -> PRD per core + CRD (the paper's pipeline)."""
    dev = resolve_device(device)
    privates = gen_private_traces(trace, num_cores, chunk_size=chunk_size)
    return MulticoreProfiles(
        num_cores=num_cores,
        private=prd_profiles(privates, line_size, device=dev),
        shared=crd_profile(
            privates, strategy, line_size=line_size, seed=seed, device=dev
        ),
        strategy=strategy,
    )
