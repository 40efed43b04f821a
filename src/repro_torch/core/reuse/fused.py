"""Fused device-binned reuse profiles — port of
``repro/core/reuse/fused.py``.

The exact profile path histograms every distinct distance; here the
distance stream stays on the device and feeds the hand-written
``kernels/reuse_hist`` kernel, accumulated in a float64 ``[2,
NUM_BINS]`` tensor on that device — row 0 the per-bin weighted counts,
row 1 the per-bin weighted distance mass.  Only the final 2x64 floats
cross back to the host, where they become a log2-binned
:class:`~repro_torch.core.reuse.profile.ReuseProfile` whose bin
representative is the weighted-mean distance of the bin (the same
representative convention as
:func:`~repro_torch.core.reuse.profile.log2_binned`).

Bin layout is the kernel's: bin 0 holds the D = inf (first-touch) mass,
bin b >= 1 holds finite D with ``1 + floor(log2(max(D, 1))) == b``,
clamped to ``NUM_BINS - 1`` — D = 0 and D = 1 share bin 1.  The port
computes that rule exactly on integers; the reference's float32 log2
lands one bin off at some powers of two >= 2^13 and at 2^k - 1 for
k >= 21 (ROADMAP C2), so at those distances the two packages' binned
profiles differ by design.

With the pipeline's unit weights each update's counts and masses are
exact integers rounded to double once, and the accumulator adds them in
double: exact below 2^53 per bin (the reference's float32 accumulator
is exact only to 2^24).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.reuse_hist import NUM_BINS, reuse_histogram_moments

from .distance import DEFAULT_WINDOW, INF_RD, reuse_distance_windows_device
from .profile import ReuseProfile, profile_from_pairs

__all__ = [
    "FusedReuseHistogram",
    "binned_profile_from_distances",
    "binned_profile_windows",
    "profile_from_binned_hist",
]


class FusedReuseHistogram:
    """Streaming accumulator for binned reuse profiles on ``device``.

    ``update`` takes any distance tensor or array and folds it into the
    float64 ``[2, NUM_BINS]`` tensor on the device (one kernel launch on
    the GPU, which adds into the tensor as it writes);
    ``profile()`` performs the only device->host transfer.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._hist = torch.zeros((2, NUM_BINS), dtype=torch.float64,
                                 device=self.device)

    def update(self, d, w=None) -> "FusedReuseHistogram":
        d = torch.as_tensor(d)
        if d.numel() == 0:
            return self
        if w is not None:
            w = torch.as_tensor(w).to(self.device)
        reuse_histogram_moments(d.to(self.device), w, out=self._hist)
        return self

    def histogram(self) -> np.ndarray:
        return self._hist.cpu().numpy()

    def profile(self) -> ReuseProfile:
        return profile_from_binned_hist(self.histogram())


def _bin_bounds(b: int) -> tuple[int, int]:
    """Inclusive [lo, hi] finite-distance range of bin b >= 1."""
    if b == 1:
        return 0, 1
    lo = 1 << (b - 1)
    if b == NUM_BINS - 1:  # top bin is clamped open-ended
        return lo, np.iinfo(np.int64).max
    return lo, (1 << b) - 1


def profile_from_binned_hist(hist: np.ndarray) -> ReuseProfile:
    """[2, NUM_BINS] count/mass histogram -> log2-binned ReuseProfile.

    Bin representatives are the per-bin weighted-mean distances
    (rounded, clamped into the bin); bin 0 becomes the ``INF_RD``
    bucket.  Counts are rounded to integers — the pipeline's weights
    are unit reference counts.
    """
    hist = np.asarray(hist, dtype=np.float64)
    counts = np.rint(hist[0]).astype(np.int64)
    mass = hist[1]
    out_d, out_c = [], []
    if counts[0] > 0:
        out_d.append(INF_RD)
        out_c.append(int(counts[0]))
    for b in range(1, NUM_BINS):
        c = int(counts[b])
        if c <= 0:
            continue
        lo, hi = _bin_bounds(b)
        rep = int(np.rint(mass[b] / c))
        out_d.append(int(np.clip(rep, lo, hi)))
        out_c.append(c)
    return profile_from_pairs(
        np.asarray(out_d, dtype=np.int64), np.asarray(out_c, dtype=np.int64)
    )


def binned_profile_from_distances(rds, weights=None, *, device=None
                                  ) -> ReuseProfile:
    """One-shot device-binned profile of a distance tensor or array; a
    tensor is binned on its own device, anything else on ``device``."""
    if device is None and isinstance(rds, torch.Tensor):
        device = rds.device
    acc = FusedReuseHistogram(device)
    acc.update(rds, weights)
    return acc.profile()


def binned_profile_windows(
    source,
    line_size: int = 1,
    *,
    window_size: int = DEFAULT_WINDOW,
    device=None,
) -> ReuseProfile:
    """Streaming fused profile build: windowed reuse distances ->
    reuse-histogram kernel, with every window's distances staying on
    the device.

    The binned counterpart of ``profile_from_distances_incremental(
    reuse_distance_windows_device(...))`` — same trace windows, same
    carried state, but the O(N) distance stream never reaches the host.
    """
    acc = FusedReuseHistogram(device)
    for rds in reuse_distance_windows_device(
        source, line_size, window_size=window_size, device=acc.device
    ):
        acc.update(rds)
    return acc.profile()
