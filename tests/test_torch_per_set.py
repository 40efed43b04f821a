"""Per-set reuse distances and the batched multi-segment engine: the
port (``device="cpu"``) against the JAX package, bit for bit, at every
method, engine and shard count."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.reuse import batched as ref_batched
from repro.core.reuse import distance as ref_distance
from repro.dist import sharding as ref_sharding

from repro_torch.core.reuse import batched, distance
from repro_torch.dist import sharding

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)


def segments(seed: int, k: int = 40):
    """Seeded segments of mixed length (some empty), heavy reuse."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        n = int(rng.choice([0, 1, 2, 7, 50, 300, 1200]))
        out.append(rng.integers(0, max(n // 3, 1), n) * 8)
    return out


def as_numpy(tensors):
    return [t.numpy() for t in tensors]


@pytest.mark.parametrize("num_sets", [1, 2, 8, 64, 1024])
@pytest.mark.parametrize("method", ["auto", "monolithic", "batched"])
def test_per_set_distances_equal_reference(num_sets, method):
    rng = np.random.default_rng(num_sets)
    addrs = rng.integers(0, 1 << 16, 6000)
    got = distance.per_set_reuse_distances(
        addrs, line_size=64, num_sets=num_sets, method=method, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    # the reference's batched method runs its Fenwick engine at many
    # sets, seconds of XLA:CPU time; its monolithic scan holds them all
    ref_methods = ("monolithic", "batched") if num_sets <= 64 else (
        "monolithic",)
    for ref_method in ref_methods:
        want = ref_distance.per_set_reuse_distances(
            addrs, line_size=64, num_sets=num_sets, method=ref_method)
        assert np.array_equal(got.numpy(), want)


def test_per_set_auto_above_threshold_equals_reference(monkeypatch):
    """Above PER_SET_BATCH_THRESHOLD the reference's auto takes its
    batched method; the port's one pass gives the same integers."""
    monkeypatch.setattr(distance, "PER_SET_BATCH_THRESHOLD", 256)
    rng = np.random.default_rng(4)
    addrs = rng.integers(0, 1 << 14, size=2000)
    passes = distance.PASSES["cpu"]
    got = distance.per_set_reuse_distances(addrs, line_size=64, num_sets=16,
                                           device="cpu")
    assert distance.PASSES["cpu"] == passes + 1
    want = ref_distance.per_set_reuse_distances(addrs, line_size=64,
                                                num_sets=16,
                                                method="monolithic")
    assert np.array_equal(got.numpy(), want)


def test_routing_sizes_equal_reference():
    assert distance.PER_SET_BATCH_THRESHOLD == ref_distance.PER_SET_BATCH_THRESHOLD
    assert distance.RD_OFFLINE_THRESHOLD == ref_distance.RD_OFFLINE_THRESHOLD
    assert distance.PER_SET_BATCH_THRESHOLD == ref_distance.PER_SET_BATCH_THRESHOLD
    assert distance.RD_OFFLINE_THRESHOLD == ref_distance.RD_OFFLINE_THRESHOLD


def test_per_set_takes_a_tensor_and_an_empty_trace():
    addrs = np.arange(0, 64 * 40, 16)
    got = distance.per_set_reuse_distances(
        torch.from_numpy(addrs), line_size=64, num_sets=4, device="cpu")
    want = ref_distance.per_set_reuse_distances(addrs, line_size=64,
                                                num_sets=4)
    assert np.array_equal(got.numpy(), want)
    empty = distance.per_set_reuse_distances([], line_size=64, num_sets=4,
                                             device="cpu")
    assert empty.numel() == 0 and empty.dtype == torch.int64


def test_split_by_set_and_compact_ids_equal_reference():
    rng = np.random.default_rng(9)
    addrs = rng.integers(0, 1 << 40, 3000)
    segs, order = distance.split_by_set(addrs, line_size=64, num_sets=16)
    ref_segs, ref_order = ref_distance.split_by_set(addrs, line_size=64,
                                                    num_sets=16)
    assert np.array_equal(order, ref_order)
    assert len(segs) == len(ref_segs)
    assert all(np.array_equal(a, b) for a, b in zip(segs, ref_segs))
    ids = distance.compact_ids(addrs)
    assert ids.dtype == np.int32
    assert np.array_equal(ids, ref_distance.compact_ids(addrs))


@pytest.mark.parametrize("engine", ["auto", "fenwick", "offline"])
@pytest.mark.parametrize("shards", [None, 1, 2, 3, 7])
def test_batched_equals_reference_at_every_engine_and_shard_count(engine,
                                                                   shards):
    segs = segments(seed=3)
    got = batched.reuse_distances_batched(segs, engine=engine,
                                          num_shards=shards, device="cpu")
    want = ref_batched.reuse_distances_batched(segs, engine="offline",
                                               num_shards=1)
    assert len(got) == len(segs)
    for g, w, s in zip(got, want, segs):
        assert g.dtype == torch.int64 and g.numel() == len(s)
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("line_size", [1, 64])
def test_batched_line_size_and_segment_objects(line_size):
    from repro_torch.core.trace.types import trace_from_blocks

    segs = segments(seed=5, k=12)
    traces = [trace_from_blocks([("b", s, True)]) if s.size else s
              for s in segs]
    got = batched.reuse_distances_batched(traces, line_size, device="cpu")
    for g, s in zip(got, segs):
        want = ref_distance.reuse_distances(s, line_size, method="scan")
        assert np.array_equal(g.numpy(), want)


def test_batched_single_segment_at_every_shard_count():
    rng = np.random.default_rng(6)
    t = rng.integers(0, 1 << 12, size=20_000)
    want = ref_distance.reuse_distances(t, method="offline")
    for shards in (1, 4):
        (got,) = batched.reuse_distances_batched([t], num_shards=shards,
                                                 device="cpu")
        assert np.array_equal(got.numpy(), want)


def test_batched_all_empty_and_unknown_engine():
    got = batched.reuse_distances_batched([[], np.empty(0)], device="cpu")
    assert [g.numel() for g in got] == [0, 0]
    with pytest.raises(ValueError, match="unknown batched RD engine"):
        batched.reuse_distances_batched([np.arange(4)], engine="nope",
                                        device="cpu")


@pytest.mark.parametrize("shards", [1, 2, 3, 7, 500])
@pytest.mark.parametrize("case", ["ties", "negatives", "wide", "prev"])
def test_count_leq_before_shards_equal_reference(shards, case):
    rng = np.random.default_rng(11)
    vals = {
        "ties": rng.integers(0, 4, 500),
        "negatives": rng.integers(-50, 50, 777),
        "wide": rng.integers(-(1 << 60), 1 << 60, 300),
        "prev": rng.integers(-1, 400, 400),
    }[case]
    got = batched.count_leq_before(torch.from_numpy(vals), num_shards=shards)
    assert np.array_equal(
        got.numpy(), ref_batched.count_leq_before(vals, num_shards=shards))
    assert np.array_equal(got.numpy(), ref_batched.count_leq_before(vals))


@pytest.mark.parametrize("method", ["auto", "scan", "offline"])
def test_reuse_distances_method_equal_reference(method):
    rng = np.random.default_rng(0)
    t = rng.integers(0, 1 << 12, size=5000) * 16
    got = distance.reuse_distances(t, 64, method=method, device="cpu")
    for ref_method in ("scan", "offline", "auto"):
        assert np.array_equal(
            got.numpy(), ref_distance.reuse_distances(t, 64, method=ref_method))


def test_unknown_methods_raise():
    with pytest.raises(ValueError, match="unknown reuse-distance method"):
        distance.reuse_distances([1, 2], method="nope", device="cpu")
    with pytest.raises(ValueError, match="unknown per-set method"):
        distance.per_set_reuse_distances([1, 2], line_size=1, num_sets=1,
                                         method="nope", device="cpu")


@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_partition_segments_equals_reference(shards):
    rng = np.random.default_rng(shards)
    lengths = rng.integers(0, 1000, 37).tolist()
    assert (sharding.partition_segments(lengths, shards)
            == ref_sharding.partition_segments(lengths, shards))
    assert sharding.local_shard_count("cpu") == 1
