"""Kernels B2/B3 (the log2-binned reuse histogram): the port's wrappers
on the CPU (their plain PyTorch versions) against the JAX package's
Pallas kernels in interpret mode, on the same seeded numpy inputs.

The reference bins through a float32 log2 and lands one bin off at some
powers of two and at 2^k - 1 for k >= 21 (ROADMAP C2); the port bins by
the documented integer rule.  Counts are compared with the reference at
every other distance, and the port is held to the rule at those points.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.reuse_hist import reuse_hist_moments_ref
from repro.kernels.reuse_hist import reuse_histogram as ref_hist
from repro.kernels.reuse_hist import reuse_histogram_moments as ref_moments
from repro.kernels.reuse_hist.reuse_hist import NUM_BINS as REF_BINS
from repro.kernels.reuse_hist.reuse_hist import _bin_ids as ref_bin_ids

from repro_torch.kernels import reuse_hist as rh

torch.set_num_threads(1)

# the points where the reference's float32 log2 leaves the rule (C2)
C2_POINTS = [8192, 32768, 2097151, 4194303, 1 << 26, (1 << 30)]


def rule_bin(d: int) -> int:
    """The documented rule, in Python integers."""
    if d < 0:
        return 0
    return 1 if d == 0 else min(int(d).bit_length(), rh.NUM_BINS - 1)


def off_c2(d: np.ndarray) -> np.ndarray:
    """``d`` without the distances the reference bins off the rule."""
    ref = np.asarray(ref_bin_ids(jnp.asarray(d.astype(np.float32))))
    return d[ref == np.array([rule_bin(x) for x in d])]


def port_moments(d, w=None):
    return rh.reuse_histogram_moments(
        torch.from_numpy(np.asarray(d, dtype=np.int64)),
        None if w is None else torch.from_numpy(np.asarray(w, np.float32)),
    ).numpy()


def test_layout_matches_the_reference():
    assert rh.NUM_BINS == REF_BINS == 64


@pytest.mark.parametrize("n", [0, 1, 5, 1024, 2049, 8192])
def test_moments_match_reference(n):
    rng = np.random.default_rng(n)
    d = off_c2(rng.integers(-1, 1 << 20, size=n))
    got = port_moments(d)
    assert got.shape == (2, rh.NUM_BINS) and got.dtype == np.float64
    if d.size:
        want = np.asarray(ref_moments(jnp.asarray(d.astype(np.float32)),
                                      interpret=True))
    else:  # the Pallas wrapper needs one tile; its oracle takes n = 0
        want = np.asarray(reuse_hist_moments_ref(
            jnp.zeros(0, jnp.float32), jnp.zeros(0, jnp.float32)))
    np.testing.assert_array_equal(got[0], want[0])          # counts: exact
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)  # f32 mass
    assert got[0].sum() == d.size


@pytest.mark.parametrize("n", [1, 5, 1024, 2049, 8192])
def test_hist_is_row_0_and_matches_reference(n):
    rng = np.random.default_rng(100 + n)
    d = off_c2(rng.integers(-1, 1 << 20, size=n))
    w = rng.random(d.size).astype(np.float32)
    dt, wt = torch.from_numpy(d), torch.from_numpy(w)
    got = rh.reuse_histogram(dt).numpy()
    want = np.asarray(ref_hist(jnp.asarray(d.astype(np.float32)),
                               interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == d.size  # mass conservation
    np.testing.assert_array_equal(got, rh.reuse_histogram_moments(dt)[0])
    got_w = rh.reuse_histogram(dt, wt).numpy()
    want_w = np.asarray(ref_hist(jnp.asarray(d.astype(np.float32)),
                                 jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
    np.testing.assert_array_equal(got_w, rh.reuse_histogram_moments(dt, wt)[0])


def test_weighted_and_inf_mass():
    d = np.array([-1, 0, 1, 2, 1024])
    w = np.array([2.0, 3.0, 1.0, 1.0, 5.0], dtype=np.float32)
    got = port_moments(d, w)
    want = np.asarray(ref_moments(jnp.asarray(d.astype(np.float32)),
                                  jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert got[0][0] == 2.0           # INF mass
    assert got[1][0] == 0.0           # INF carries no distance mass
    assert got[0].sum() == w.sum()
    assert got[1].sum() == 1 * 1 + 1 * 2 + 5 * 1024


def test_bin_layout():
    # d=0 and d=1 -> bin 1; d=2,3 -> bin 2; d in [2^k, 2^(k+1)) -> bin k+1
    got = rh.reuse_histogram(torch.tensor([0, 1, 2, 3, 4, 7, 8])).numpy()
    assert got[1] == 2 and got[2] == 2 and got[3] == 2 and got[4] == 1


def test_c2_points_follow_the_documented_rule():
    d = np.array(C2_POINTS)
    ref = np.asarray(ref_bin_ids(jnp.asarray(d.astype(np.float32))))
    rule = np.array([rule_bin(x) for x in d])
    assert (ref != rule).all()  # the reference's fault, still there
    got = rh.bin_ids_plain(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, rule)
    hist = port_moments(d)
    np.testing.assert_array_equal(hist[0], np.bincount(rule, minlength=64))
    np.testing.assert_array_equal(hist[1], np.bincount(rule, weights=d,
                                                       minlength=64))


def test_bins_exact_at_every_bit_length():
    pts = [-5, -1, 0, 1] + [v for k in range(1, 63)
                            for v in ((1 << k) - 1, 1 << k, (1 << k) + 1)]
    pts.append((1 << 63) - 1)
    d = torch.tensor(pts, dtype=torch.int64)
    got = rh.bin_ids_plain(d).tolist()
    assert got == [rule_bin(x) for x in pts]
    assert max(got) == rh.NUM_BINS - 1  # the top bin is clamped


def test_float_and_int32_distances_are_cast():
    d = np.array([-1, 0, 3, 17, 4096])
    want = port_moments(d)
    for t in (torch.tensor(d, dtype=torch.float32),
              torch.tensor(d, dtype=torch.int32),
              torch.tensor(d).reshape(5, 1)):
        np.testing.assert_array_equal(rh.reuse_histogram_moments(t).numpy(),
                                      want)


def test_wrappers_check_their_inputs():
    d = torch.arange(4)
    with pytest.raises(TypeError):
        rh.reuse_histogram_moments(np.arange(4))
    with pytest.raises(TypeError):
        rh.reuse_histogram(d.bool())
    with pytest.raises(ValueError, match="entries"):
        rh.reuse_histogram_moments(d, torch.ones(3))
    with pytest.raises(TypeError):
        rh.reuse_histogram(d, [1.0] * 4)


def test_cpu_tensors_take_the_plain_version():
    before = dict(rh.LAUNCHES)
    d = torch.tensor([-1, 0, 5, 9])
    np.testing.assert_array_equal(rh.reuse_histogram_moments(d).numpy(),
                                  rh.reuse_histogram_moments_plain(d).numpy())
    assert rh.LAUNCHES == before


def integer_histogram(values):
    """Counts and finite-distance masses as Python integers per bin."""
    counts, sums = [0] * rh.NUM_BINS, [0] * rh.NUM_BINS
    for x in values:
        counts[rule_bin(x)] += 1
        sums[rule_bin(x)] += max(x, 0)
    return counts, sums


OVERFLOW_INPUTS = {
    # the clamped top bin: a u64 sum would wrap after two of these
    "top_bin": [1 << 62, (1 << 63) - 1] * 300 + [-1, 0, 5],
    # 20000 values near 2^40, each 3 mod 4: the sum passes 2^53 after
    # ~8000, and a float64 running sum then rounds every add the same way
    "many_2^40": [(1 << 40) + 4 * k + 3 for k in range(20000)],
    "both": [(1 << 40) + 3] * 9000 + [(1 << 63) - 1, (1 << 62) + 1] * 50,
}


@pytest.mark.parametrize("case", sorted(OVERFLOW_INPUTS))
def test_unit_sums_are_integer_sums_rounded_once(case):
    values = OVERFLOW_INPUTS[case]
    d = torch.tensor(values, dtype=torch.int64)
    got = rh.reuse_histogram_moments(d).numpy()
    counts, sums = integer_histogram(values)
    assert got[0].tolist() == [float(c) for c in counts]
    assert got[1].tolist() == [float(s) for s in sums]  # rounded once
    assert rh.reuse_histogram(d).tolist() == [float(c) for c in counts]
    # the case bites: a 64-bit integer sum wraps, or a float64 running
    # sum rounds on the way
    naive = np.bincount(rh.bin_ids_plain(d).numpy(),
                        weights=np.maximum(np.array(values), 0).astype(float),
                        minlength=rh.NUM_BINS)
    assert max(sums) >= 1 << 64 or not np.array_equal(naive, got[1])


def test_out_adds_in_place():
    d1, d2 = torch.tensor([-1, 0, 7, 9000]), torch.tensor([3, 3, 1 << 40])
    out = rh.reuse_histogram_moments(d1)
    got = rh.reuse_histogram_moments(d2, out=out)
    assert got is out
    assert torch.equal(out, rh.reuse_histogram_moments_plain(d1)
                       + rh.reuse_histogram_moments_plain(d2))
    with pytest.raises(ValueError):
        rh.reuse_histogram(d1, out=torch.zeros(2, rh.NUM_BINS,
                                               dtype=torch.float64))


def test_ctas_depend_on_n_alone():
    assert rh.ctas_for(1) == 1
    assert rh.ctas_for(1 << 12) == 1
    assert rh.ctas_for((1 << 12) + 1) == 2
    assert rh.ctas_for(1 << 30) == 1024
