"""Reuse distances and profiles: the port's offline engine (torch ops)
is bit-identical to every engine of the JAX package."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.reuse import batched as ref_batched
from repro.core.reuse.distance import (
    RD_OFFLINE_THRESHOLD,
    reuse_distances as ref_reuse_distances,
    reuse_distances_ref as ref_stack_oracle,
)
from repro.core.reuse.profile import (
    profile_from_distances as ref_profile_from_distances,
    profile_from_pairs as ref_profile_from_pairs,
)
from repro.workloads import polybench as ref_pb

from repro_torch import interop
from repro_torch.core.reuse import batched, distance
from repro_torch.core.reuse.distance import reuse_distances, reuse_distances_ref
from repro_torch.core.reuse.profile import (
    profile_from_distances,
    profile_from_pairs,
)
from repro_torch.workloads import polybench as pb

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)


def port_rd(addresses, line_size=1):
    out = reuse_distances(addresses, line_size, device="cpu")
    assert out.dtype == torch.int64 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("n", [0, 1, 2, 57, 3000, RD_OFFLINE_THRESHOLD + 808])
def test_random_trace_matches_every_reference_engine(n):
    rng = np.random.default_rng(n)
    addrs = rng.integers(0, max(n // 4, 1), n) * 8  # heavy repeats
    got = port_rd(addrs)
    assert np.array_equal(got, ref_reuse_distances(addrs, method="scan"))
    assert np.array_equal(got, ref_reuse_distances(addrs, method="offline"))
    assert np.array_equal(got, ref_stack_oracle(list(addrs)))
    assert np.array_equal(got, reuse_distances_ref(list(addrs)))


@pytest.mark.parametrize("line_size", [1, 64])
@pytest.mark.parametrize("abbr", ["atx", "2mm", "jcb", "blk", "dbn"])
def test_polybench_trace_matches_reference(abbr, line_size):
    port_t = pb.make_workload(abbr, "smoke").trace()
    ref_t = ref_pb.make_workload(abbr, "smoke").trace()
    got = port_rd(port_t.addresses, line_size)
    assert np.array_equal(
        got, ref_reuse_distances(ref_t.addresses, line_size, method="scan"))
    assert np.array_equal(
        got, ref_reuse_distances(ref_t.addresses, line_size, method="offline"))
    lines = ref_t.addresses // line_size
    assert np.array_equal(got, ref_stack_oracle(list(lines)))


def test_large_polybench_trace_above_offline_threshold():
    port_t = pb.make_workload("mvt", "validation").trace()
    ref_t = ref_pb.make_workload("mvt", "validation").trace()
    assert len(ref_t) > RD_OFFLINE_THRESHOLD
    got = port_rd(port_t.addresses, 64)
    assert np.array_equal(got, ref_reuse_distances(ref_t.addresses, 64))


@pytest.mark.parametrize("case", ["ties", "negatives", "wide", "sorted_desc"])
def test_count_leq_before_matches_reference(case):
    rng = np.random.default_rng(11)
    vals = {
        "ties": rng.integers(0, 4, 500),
        "negatives": rng.integers(-50, 50, 777),
        "wide": rng.integers(-(1 << 40), 1 << 40, 300),
        "sorted_desc": np.arange(200)[::-1].copy(),
    }[case].astype(np.int64)
    got = batched.count_leq_before(torch.from_numpy(vals)).numpy()
    assert np.array_equal(got, ref_batched.count_leq_before(vals))
    brute = np.array([(vals[:t] <= vals[t]).sum() for t in range(vals.size)])
    assert np.array_equal(got, brute)


def test_prev_occurrence_matches_reference():
    keys = np.random.default_rng(5).integers(0, 30, 400).astype(np.int64)
    got = batched._prev_occurrence(torch.from_numpy(keys)).numpy()
    assert np.array_equal(got, ref_batched._prev_occurrence(keys))


def test_passes_are_counted_by_device():
    before = distance.PASSES["cpu"]
    reuse_distances(np.arange(10), device="cpu")
    assert distance.PASSES["cpu"] == before + 1


@pytest.mark.parametrize("line_size", [1, 64])
def test_profiles_match_reference(line_size):
    ref_t = ref_pb.make_workload("cov", "smoke").trace()
    ref_prof = ref_profile_from_distances(
        ref_reuse_distances(ref_t.addresses, line_size))
    prof = profile_from_distances(
        reuse_distances(ref_t.addresses, line_size, device="cpu"))
    assert np.array_equal(prof.distances, ref_prof.distances)
    assert np.array_equal(prof.counts, ref_prof.counts)
    assert prof.distances.dtype == prof.counts.dtype == np.int64
    assert prof.total == ref_prof.total
    assert np.array_equal(prof.probabilities, ref_prof.probabilities)
    assert prof.inf_fraction == ref_prof.inf_fraction
    carried = interop.profile_from_arrays(
        ref_prof.distances, ref_prof.counts, ref_prof.total)
    assert np.array_equal(carried.distances, prof.distances)
    assert np.array_equal(carried.counts, prof.counts)
    assert carried.total == prof.total


def test_profile_from_pairs_matches_reference():
    rng = np.random.default_rng(2)
    d = rng.integers(-1, 20, 60)
    c = rng.integers(1, 9, 60)
    got, ref = profile_from_pairs(d, c), ref_profile_from_pairs(d, c)
    assert np.array_equal(got.distances, ref.distances)
    assert np.array_equal(got.counts, ref.counts) and got.total == ref.total


def test_interop_profile_rejects_bad_arrays():
    with pytest.raises(ValueError):
        interop.profile_from_arrays([3, 1], [1, 1])
    with pytest.raises(ValueError):
        interop.profile_from_arrays([1, 3], [1, 1], total=5)
