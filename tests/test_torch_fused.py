"""Binned profiles (``core/reuse/fused.py``) and the profile helpers of
this slice (``log2_binned``, ``profile_from_distances_incremental``):
the port on the CPU against the JAX package on the same seeded inputs.

Distances stay below 2^13, under the first point where the reference's
float32 binning leaves the documented rule (ROADMAP C2), so the binned
profiles of the two packages are equal there.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.reuse import fused as ref_fused
from repro.core.reuse import profile as ref_profile
from repro.core.reuse.distance import reuse_distance_windows as ref_windows

from repro_torch.core.reuse import fused, profile
from repro_torch.core.reuse.distance import (
    reuse_distance_windows_device,
    reuse_distances,
)
from repro_torch.interop import profile_from_arrays
from repro_torch.kernels import reuse_hist as rh

torch.set_num_threads(1)

WINDOWS = [1, 7, 256, 1000, 4096]


def same(a, b):
    np.testing.assert_array_equal(a.distances, b.distances)
    np.testing.assert_array_equal(a.counts, b.counts)
    assert a.total == b.total


def trace(n, lines, seed):
    return np.random.default_rng(seed).integers(0, lines, n) * 8


def test_profile_from_binned_hist_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        counts = np.where(rng.random(64) < 0.5, 0,
                          rng.integers(1, 10_000, 64)).astype(np.float64)
        lo = np.array([0, 0] + [1 << (b - 1) for b in range(2, 64)], float)
        hi = np.array([0, 1] + [(1 << b) - 1 for b in range(2, 64)], float)
        rep = lo + rng.random(64) * (hi - lo)
        mass = counts * rep
        mass[0] = 0.0
        hist = np.stack([counts, mass])
        same(fused.profile_from_binned_hist(hist),
             ref_fused.profile_from_binned_hist(hist))


def test_bin_bounds_match_reference():
    for b in range(1, 64):
        assert fused._bin_bounds(b) == ref_fused._bin_bounds(b)


@pytest.mark.parametrize("n", [0, 1, 5, 1024, 2049, 8192])
def test_binned_profile_from_distances_matches_reference(n):
    d = np.random.default_rng(n).integers(-1, 1 << 13, n)
    got = fused.binned_profile_from_distances(torch.from_numpy(d))
    want = ref_fused.binned_profile_from_distances(d, interpret=True)
    same(got, want)
    same(fused.binned_profile_from_distances(d, device="cpu"), want)


@pytest.mark.parametrize("ws", WINDOWS)
def test_binned_profile_windows_matches_reference(ws):
    n = 600 if ws < 256 else 3000
    addrs = trace(n, 700, ws)
    got = fused.binned_profile_windows(addrs, 8, window_size=ws,
                                       device="cpu")
    want = ref_fused.binned_profile_windows(addrs, 8, window_size=ws,
                                            interpret=True)
    same(got, want)
    # and the streamed binned profile is the one-shot binned profile
    same(got, fused.binned_profile_from_distances(
        reuse_distances(addrs, 8, device="cpu")))


def test_fused_accumulator_folds_updates():
    rng = np.random.default_rng(5)
    parts = [rng.integers(-1, 5000, k) for k in (0, 17, 300, 1024)]
    acc = fused.FusedReuseHistogram("cpu")
    for p in parts:
        acc.update(p)
    whole = np.concatenate(parts)
    np.testing.assert_array_equal(
        acc.histogram(), rh.reuse_histogram_moments(torch.from_numpy(whole))
    )
    same(acc.profile(), fused.binned_profile_from_distances(whole,
                                                            device="cpu"))
    w = rng.random(whole.size).astype(np.float32)
    acc_w = fused.FusedReuseHistogram("cpu").update(whole, w)
    ref_w = ref_fused.FusedReuseHistogram(interpret=True).update(whole, w)
    np.testing.assert_allclose(acc_w.histogram(), ref_w.histogram(),
                               rtol=1e-6)


def test_accumulator_lives_on_its_device():
    acc = fused.FusedReuseHistogram("cpu")
    assert acc.device == torch.device("cpu")
    assert acc.histogram().shape == (2, rh.NUM_BINS)
    assert acc.profile().total == 0


def test_log2_binned_matches_reference():
    rng = np.random.default_rng(9)
    for seed in range(5):
        d = rng.integers(-1, 1 << 20, 4000)
        exact = profile.profile_from_distances(torch.from_numpy(d))
        ref_exact = ref_profile.profile_from_distances(d)
        same(profile.log2_binned(exact), ref_profile.log2_binned(ref_exact))
        same(profile.log2_binned(exact, 16),
             ref_profile.log2_binned(ref_exact, 16))


@pytest.mark.parametrize("ws", WINDOWS)
def test_incremental_profile_equals_monolithic(ws):
    addrs = trace(600 if ws < 256 else 3000, 500, 100 + ws)
    whole = profile.profile_from_distances(
        reuse_distances(addrs, 8, device="cpu"))
    got = profile.profile_from_distances_incremental(
        reuse_distance_windows_device(addrs, 8, window_size=ws,
                                      device="cpu"))
    same(got, whole)
    same(got, ref_profile.profile_from_distances_incremental(
        ref_windows(addrs, 8, window_size=ws)))


def test_incremental_profile_takes_arrays_and_skips_empty_windows():
    wins = [np.array([-1, 3, 3]), np.empty(0, np.int64), torch.tensor([0, 3])]
    got = profile.profile_from_distances_incremental(wins)
    same(got, profile_from_arrays([-1, 0, 3], [1, 1, 3]))
    assert profile.profile_from_distances_incremental([]).total == 0
