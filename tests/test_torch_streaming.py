"""Streaming: windowed reuse distances, the streaming interleaver and
window re-chunking — the port on the CPU against the JAX package on the
same seeded inputs, bit for bit."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.reuse import distance as ref_distance
from repro.core.trace import interleave as ref_interleave
from repro.core.trace import types as ref_types
from repro.core.trace.mimic import gen_private_traces as ref_mimic
from repro.workloads.polybench import make_atax as ref_make_atax

from repro_torch.core.reuse import distance
from repro_torch.core.trace import interleave, types
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.interop import trace_from_arrays
from repro_torch.workloads.polybench import make_atax

torch.set_num_threads(1)

WINDOWS = [1, 7, 256, 1000, 4096]


def addresses(n, lines, seed):
    return np.random.default_rng(seed).integers(0, lines, n) * 8


@pytest.mark.parametrize("ws", WINDOWS)
def test_windows_bit_identical_to_reference(ws):
    addrs = addresses(600 if ws < 256 else 5000, 400, ws)
    got = list(distance.reuse_distance_windows(addrs, 8, window_size=ws,
                                               device="cpu"))
    want = list(ref_distance.reuse_distance_windows(addrs, 8,
                                                    window_size=ws))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ws", WINDOWS)
def test_streaming_bit_identical_to_reference_and_in_memory(ws):
    addrs = addresses(600 if ws < 256 else 5000, 900, 50 + ws)
    got = distance.reuse_distances_streaming(addrs, 64, window_size=ws,
                                             device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(),
        ref_distance.reuse_distances_streaming(addrs, 64, window_size=ws))
    assert torch.equal(got, distance.reuse_distances(addrs, 64,
                                                     device="cpu"))


def test_table1_golden_streamed():
    trace = [ord(c) for c in "wxwyxzzw"]
    expected = [-1, -1, 1, -1, 2, -1, 0, 3]
    for ws in (1, 2, 3, 8, 100):
        got = distance.reuse_distances_streaming(trace, window_size=ws,
                                                 device="cpu")
        assert got.tolist() == expected


def test_streaming_on_a_workload_trace():
    addrs = make_atax(n=32).trace().addresses
    np.testing.assert_array_equal(addrs, ref_make_atax(n=32).trace().addresses)
    whole = distance.reuse_distances(addrs, 64, device="cpu")
    for ws in (256, 1000, 4096):
        assert torch.equal(
            distance.reuse_distances_streaming(addrs, 64, window_size=ws,
                                               device="cpu"), whole)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 40), min_size=0, max_size=120),
       st.integers(1, 130))
def test_streaming_property(trace, ws):
    arr = np.asarray(trace, dtype=np.int64)
    got = distance.reuse_distances_streaming(arr, window_size=ws,
                                             device="cpu")
    assert got.tolist() == distance.reuse_distances_ref(trace).tolist()
    assert got.tolist() == ref_distance.reuse_distances_streaming(
        arr, window_size=ws).tolist()


def test_streaming_counts_one_pass_and_yields_empty_windows():
    distance.PASSES.clear()
    wins = list(distance.reuse_distance_windows_device(
        [np.array([1, 2]), np.empty(0, np.int64), np.array([1])],
        window_size=4, device="cpu"))
    assert [w.tolist() for w in wins] == [[-1, -1], [], [1]]
    assert distance.PASSES == {"cpu": 1}
    assert distance.reuse_distances_streaming([], device="cpu").numel() == 0
    with pytest.raises(ValueError, match="window_size"):
        next(distance.reuse_distance_windows_device([1], window_size=0,
                                                    device="cpu"))


def test_iter_address_windows_matches_reference():
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 1 << 20, 1000)
    trace = trace_from_arrays(addrs, np.zeros(1000, np.int32),
                              np.zeros(1000, bool))
    ref_trace = ref_types.LabeledTrace(addrs, np.zeros(1000, np.int32),
                                       np.zeros(1000, bool))
    cases = [
        (addrs, addrs),
        (list(addrs[:50]), list(addrs[:50])),
        (trace, ref_trace),
        (list(trace.windows(300)), list(ref_trace.windows(300))),
        (iter([addrs[:10], addrs[10:]]), iter([addrs[:10], addrs[10:]])),
    ]
    for src, ref_src in cases:
        got = list(distance.iter_address_windows(src, window_size=128,
                                                 line_size=64))
        want = list(ref_distance.iter_address_windows(
            ref_src, window_size=128, line_size=64))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _privates(n, cores, seed):
    w = make_atax(n=n)
    t = w.trace()
    ref_t = ref_make_atax(n=n).trace()
    return gen_private_traces(t, cores), ref_mimic(ref_t, cores)


@pytest.mark.parametrize("strategy,chunk", [
    ("round_robin", 1), ("chunked", 1), ("chunked", 16), ("chunked", 300),
])
@pytest.mark.parametrize("ws", [7, 256, 4096])
def test_interleave_windows_match_reference(strategy, chunk, ws):
    privs, ref_privs = _privates(16, 4, 0)
    got = list(interleave.interleave_windows(
        privs, strategy, window_size=ws, chunk_size=chunk))
    want = list(ref_interleave.interleave_windows(
        ref_privs, strategy, window_size=ws, chunk_size=chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.addresses, w.addresses)
        np.testing.assert_array_equal(g.bb_ids, w.bb_ids)
        np.testing.assert_array_equal(g.shared_mask, w.shared_mask)
        np.testing.assert_array_equal(g.inst_ids, w.inst_ids)
        assert g.bb_names == w.bb_names
    whole = interleave.interleave_traces(privs, strategy, chunk_size=chunk)
    np.testing.assert_array_equal(
        np.concatenate([g.addresses for g in got]), whole.addresses)


def test_interleave_windows_rejects_uniform_and_unknown():
    privs, _ = _privates(8, 2, 0)
    for bad in ("uniform", "nope"):
        with pytest.raises(ValueError):
            list(interleave.interleave_windows(privs, bad))
        with pytest.raises(ValueError):
            list(ref_interleave.interleave_windows(privs, bad))
    with pytest.raises(ValueError, match="at least one"):
        list(interleave.interleave_windows([]))


@pytest.mark.parametrize("ws", [1, 5, 64, 1000])
def test_rebatch_windows_matches_reference(ws):
    rng = np.random.default_rng(ws)
    sizes = rng.integers(0, 90, 12)
    pieces, ref_pieces = [], []
    for i, k in enumerate(sizes):
        a = rng.integers(0, 1000, k)
        b = rng.integers(0, 5, k).astype(np.int32)
        s = rng.random(k) < 0.3
        pieces.append(trace_from_arrays(a, b, s, bb_names={i: f"bb{i}"}))
        ref_pieces.append(ref_types.LabeledTrace(a, b, s, None, {i: f"bb{i}"}))
    got = list(types.rebatch_windows(pieces, ws))
    want = list(ref_types.rebatch_windows(ref_pieces, ws))
    assert [len(g) for g in got] == [len(w) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.addresses, w.addresses)
        np.testing.assert_array_equal(g.bb_ids, w.bb_ids)
        np.testing.assert_array_equal(g.shared_mask, w.shared_mask)
        np.testing.assert_array_equal(g.inst_ids, w.inst_ids)
        assert g.bb_names == w.bb_names
    with pytest.raises(ValueError):
        list(types.rebatch_windows(pieces, 0))


def test_labeled_trace_is_a_chunked_source():
    t = trace_from_arrays([1, 2, 3], [0, 0, 1], [False] * 3)
    assert isinstance(t, types.ChunkedTraceSource)
    assert not isinstance(np.arange(3), types.ChunkedTraceSource)
