"""SHARDS-sampled profiles: the port's ``core/reuse/sampled.py`` and
``Session(sampled=R)`` (``device="cpu"``) against the JAX package's —
masks, bounds, profile pairs and error bounds equal; predicted hit
rates within 1e-6 of the reference's sampled predict."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.api import PredictionRequest as RefRequest
from repro.api import Session as RefSession
from repro.core.reuse import sampled as ref_sampled
from repro.workloads import polybench as ref_pb

from repro_torch.api import PredictionRequest, Session
from repro_torch.api.stages import MimicProfileBuilder
from repro_torch.core.reuse import sampled
from repro_torch.hw.targets import resolve_target
from repro_torch.workloads import polybench as pb

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)

RATE_TOL = 1e-6  # hit rates (tests/api/test_batched_sdcm.py's bound)
GRID = dict(targets=("i7-5960X", "tpu-v5e"), core_counts=(1, 2),
            respect_core_limit=False)


def mix_trace(n=30_000, seed=1):
    """The reference test's hot + cold-ish address mix."""
    rng = np.random.default_rng(seed)
    tr = np.concatenate([rng.integers(0, 128, n // 2),
                         rng.integers(0, n // 4, n - n // 2)]) * 64
    rng.shuffle(tr)
    return tr


def assert_same_profile(got, want):
    assert np.array_equal(got.distances, want.distances)
    assert np.array_equal(got.counts, want.counts)
    assert got.total == want.total
    assert got.error_bound == want.error_bound


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5, 0.999, 1.0])
def test_mask_equals_reference(seed, rate):
    rng = np.random.default_rng(seed)
    top = np.iinfo(np.int64).max
    lines = np.concatenate([
        rng.integers(0, 1 << 20, 5000),
        top - rng.integers(0, 1 << 20, 500),  # near 2^63
        np.array([0, 1, top, (1 << 62), (1 << 63) - 2]),
    ])
    got = sampled.sample_lines_mask(lines, rate=rate, seed=seed)
    assert np.array_equal(
        got, ref_sampled.sample_lines_mask(lines, rate=rate, seed=seed))
    assert np.array_equal(sampled._hash_lines(lines, seed),
                          ref_sampled._hash_lines(lines, seed))


@pytest.mark.parametrize("kw", [
    dict(rate=0.1, n_refs=1000),
    dict(rate=0.5, n_refs=30_000, sq_line_mass=2e6, max_line_mass=400.0),
    dict(rate=0.01, n_refs=10**6, sq_line_mass=1e9, max_line_mass=5e3,
         kept_refs=9_000),
    dict(rate=0.2, n_refs=50, kept_refs=0),
    dict(rate=1.0, n_refs=10),
])
def test_error_bound_equals_reference(kw):
    assert sampled.sampling_error_bound(**kw) == \
        ref_sampled.sampling_error_bound(**kw)
    assert sampled.SAMPLE_BOUND_DELTA == ref_sampled.SAMPLE_BOUND_DELTA


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate", [0.05, 0.3, 1.0])
def test_profiles_equal_reference(rate, seed):
    trace = mix_trace()
    got = sampled.sampled_reuse_profile(trace, 64, rate=rate, seed=seed,
                                        device="cpu")
    want = ref_sampled.sampled_reuse_profile(trace, 64, rate=rate, seed=seed)
    assert_same_profile(got, want)
    win = sampled.sampled_profile_windows(
        trace, 64, rate=rate, seed=seed, window_size=4096, device="cpu")
    assert_same_profile(win, ref_sampled.sampled_profile_windows(
        trace, 64, rate=rate, seed=seed, window_size=4096))
    # the window path is the in-memory path, window by window
    assert_same_profile(win, got)


def test_cold_and_empty_traces():
    cold = np.arange(0, 64 * 3000, 64)
    for rate in (0.25, 1.0):
        assert_same_profile(
            sampled.sampled_reuse_profile(cold, 64, rate=rate, device="cpu"),
            ref_sampled.sampled_reuse_profile(cold, 64, rate=rate))
    empty = sampled.sampled_reuse_profile([], 64, rate=0.5, device="cpu")
    assert_same_profile(empty, ref_sampled.sampled_reuse_profile([], 64,
                                                                 rate=0.5))
    with pytest.raises(ValueError, match="sampling rate"):
        sampled.sampled_reuse_profile(cold, rate=0.0, device="cpu")


@pytest.fixture(scope="module")
def atax32():
    return pb.make_atax(n=32), ref_pb.make_atax(n=32)


@pytest.mark.parametrize("window", [None, 512])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_session_predict_equals_reference(atax32, rate, window):
    port_w, ref_w = atax32
    got_sess = Session(device="cpu", sampled=rate, window_size=window)
    got = got_sess.predict(port_w, PredictionRequest(**GRID))
    want_sess = RefSession(sampled=rate, window_size=window)
    want = want_sess.predict(ref_w, RefRequest(**GRID))
    exact = Session(device="cpu").predict(port_w, PredictionRequest(**GRID))
    assert len(got) == len(want) == len(exact)
    for g, w, e in zip(got, want, exact):
        art = got_sess.artifacts(port_w, g.cores, line_size=resolve_target(
            g.target).levels[0].line_size)
        ref_art = want_sess.artifacts(ref_w, w.cores, line_size=art.line_size)
        assert art.sampled == ref_art.sampled == rate
        assert_same_profile(art.prd, ref_art.prd)
        assert_same_profile(art.crd, ref_art.crd)
        bound = max(art.prd.error_bound, art.crd.error_bound)
        assert bound > 0.0
        for lvl, rate_w in w.hit_rates.items():
            assert abs(g.hit_rates[lvl] - rate_w) <= RATE_TOL
            assert abs(g.hit_rates[lvl] - e.hit_rates[lvl]) < bound


def test_rate_one_equals_exact(atax32):
    port_w, _ = atax32
    req = PredictionRequest(**GRID)
    exact = Session(device="cpu").predict(port_w, req)
    full = Session(device="cpu", sampled=1.0)
    assert full.predict(port_w, req).to_json() == exact.to_json()
    assert full.artifacts(port_w, 2).prd.error_bound == 0.0


def test_per_request_override_and_cache_keys(atax32):
    port_w, _ = atax32
    s = Session(device="cpu")
    s.predict(port_w, PredictionRequest(targets=("i7-5960X",),
                                        core_counts=(1, 2), sampled_rate=0.5))
    assert s.artifacts(port_w, 2, sampled=0.5).sampled == 0.5
    assert s.artifacts(port_w, 2).sampled is None
    assert s._builder_for(0.5) is s._builder_for(0.5)
    assert s._builder_for(0.5).device == s.device
    bad = Session(device="cpu")
    bad.builder = object()
    with pytest.raises(ValueError, match="with_sampled"):
        bad._builder_for(0.5)


def test_builder_options_and_fingerprints():
    fp = MimicProfileBuilder.STORE_NAME
    assert MimicProfileBuilder("cpu", sampled=0.5).store_fingerprint == \
        fp + "+sampled0.5"
    assert MimicProfileBuilder("cpu", sampled=0.25).store_fingerprint == \
        fp + "+sampled0.25"
    assert MimicProfileBuilder("cpu").store_fingerprint == fp
    with pytest.raises(ValueError, match="mutually exclusive"):
        MimicProfileBuilder("cpu", binned=True, sampled=0.5)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Session(device="cpu", binned=True, sampled=0.5)
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="sampled rate"):
            MimicProfileBuilder("cpu", sampled=bad)
    with pytest.raises(ValueError, match="default builder"):
        Session(device="cpu", profile_builder=MimicProfileBuilder("cpu"),
                sampled=0.5)
    Session(device="cpu", profile_builder=MimicProfileBuilder(
        "cpu", sampled=0.5), sampled=0.5)
    b = MimicProfileBuilder("cpu", window_size=64, sampled=0.5)
    assert b.with_sampled(0.5) is b
    v = b.with_sampled(0.25)
    assert (v.sampled, v.window_size, v.device) == (0.25, 64, b.device)
