"""Reuse profiles P(D) — port of ``repro/core/reuse/profile.py`` (paper
§2.3, Table 2, and §3.3.1).

A reuse profile is the histogram of reuse distances of a trace: the
distance values, their counts, and the empirical probability P(D).
``INF_RD`` (-1) carries the compulsory-miss mass (D = ∞).  The
histogram of a device distance tensor is taken on the device
(``torch.unique``); only the small profile comes back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

from .batched import INF_RD
from .distance import reuse_distances


@dataclass(frozen=True)
class ReuseProfile:
    """Histogram of reuse distances (host numpy arrays).

    Attributes
    ----------
    distances : sorted distinct distances; ``INF_RD`` first when present.
    counts    : occurrence count per distance.
    total     : total number of accesses (== counts.sum()).
    error_bound : declared sup-norm error of an approximate profile
        (``core.reuse.sampled``); ``None`` for exact profiles, ``0.0``
        for a sampled pass at rate 1.0.
    """

    distances: np.ndarray
    counts: np.ndarray
    total: int
    error_bound: float | None = None

    def with_error_bound(self, bound: float | None) -> "ReuseProfile":
        return ReuseProfile(self.distances, self.counts, self.total, bound)

    @property
    def probabilities(self) -> np.ndarray:
        return self.counts / max(self.total, 1)

    @property
    def inf_fraction(self) -> float:
        """Compulsory-miss mass P(D = ∞)."""
        mask = self.distances == INF_RD
        if not mask.any():
            return 0.0
        return float(self.counts[mask][0]) / max(self.total, 1)

    def merged_with(self, other: "ReuseProfile") -> "ReuseProfile":
        return ReuseProfile.merge([self, other])

    @staticmethod
    def merge(profiles) -> "ReuseProfile":
        """Sum any number of histograms (windows, shards, sampled
        replicas); the merged profile carries the loosest declared
        error bound of its parts."""
        profiles = list(profiles)
        if not profiles:
            return ReuseProfile(
                np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64), 0
            )
        dists = np.concatenate([p.distances for p in profiles])
        counts = np.concatenate([p.counts for p in profiles])
        merged = profile_from_pairs(dists, counts)
        bounds = [p.error_bound for p in profiles if p.error_bound is not None]
        return merged.with_error_bound(max(bounds)) if bounds else merged

    def scaled(self, factor: float) -> "ReuseProfile":
        """Scale counts (e.g. trace-sampling extrapolation)."""
        counts = np.maximum(np.round(self.counts * factor), 0).astype(np.int64)
        return ReuseProfile(
            self.distances, counts, int(counts.sum()), self.error_bound
        )


def profile_from_pairs(distances, counts) -> ReuseProfile:
    distances = np.asarray(distances, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    order = np.argsort(distances, kind="stable")
    distances, counts = distances[order], counts[order]
    uniq, start = np.unique(distances, return_index=True)
    summed = np.add.reduceat(counts, start) if len(distances) else counts[:0]
    return ReuseProfile(uniq, summed.astype(np.int64), int(summed.sum()))


def profile_from_distances(rds: torch.Tensor) -> ReuseProfile:
    """Build a reuse profile from a reuse-distance tensor (Table 2).

    The histogram runs on the tensor's device; the distinct distances
    and their counts come back as host int64 arrays.
    """
    rds = torch.as_tensor(rds).to(torch.int64)
    uniq, counts = torch.unique(rds, sorted=True, return_counts=True)  # repro-lint: disable=TS102 -- ROADMAP "Profile builds sync once per cell"
    return ReuseProfile(
        uniq.cpu().numpy(), counts.to(torch.int64).cpu().numpy(),  # repro-lint: disable=TS102 -- ROADMAP "Profile builds sync once per cell"
        int(rds.numel()),
    )


def profile_from_trace(addresses, line_size: int = 1, *,
                       device=None) -> ReuseProfile:
    """Reuse profile of a trace, its distances computed on ``device``."""
    return profile_from_distances(
        reuse_distances(addresses, line_size, device=resolve_device(device)))


def profile_from_distances_incremental(rd_windows) -> ReuseProfile:
    """Fold an iterable of reuse-distance windows into one profile.

    The streaming accumulator: each window (a tensor on any device, or
    an array) is histogrammed where it lies and merged into the running
    (distances, counts) pair on the host, so peak memory is
    O(distinct distances + window) — the O(N) distance array never
    exists.  Feed it ``reuse_distance_windows_device(...)``.
    """
    acc_d = np.empty(0, dtype=np.int64)
    acc_c = np.empty(0, dtype=np.int64)
    for rds in rd_windows:
        rds = torch.as_tensor(rds).to(torch.int64)
        if rds.numel() == 0:
            continue
        u, c = torch.unique(rds, sorted=True, return_counts=True)  # repro-lint: disable=TS102 -- ROADMAP "Streaming profiles sync once per window"
        merged = profile_from_pairs(
            np.concatenate([acc_d, u.cpu().numpy()]),  # repro-lint: disable=TS102 -- ROADMAP "Streaming profiles sync once per window"
            np.concatenate([acc_c, c.to(torch.int64).cpu().numpy()]),  # repro-lint: disable=TS102 -- ROADMAP "Streaming profiles sync once per window"
        )
        acc_d, acc_c = merged.distances, merged.counts
    return ReuseProfile(acc_d, acc_c, int(acc_c.sum()))


def log2_binned(profile: ReuseProfile, num_bins: int = 64) -> ReuseProfile:
    """Coarsen a profile into log2 bins (keeps SDCM accuracy, shrinks size).

    Bin representative = the count-weighted mean distance of the bin;
    the ∞ bucket is kept.  Host numpy, as in the reference.
    """
    dists, counts = profile.distances, profile.counts
    inf_mask = dists == INF_RD
    fin_d, fin_c = dists[~inf_mask], counts[~inf_mask]
    out_d, out_c = [], []
    if inf_mask.any():
        out_d.append(INF_RD)
        out_c.append(int(counts[inf_mask].sum()))
    if fin_d.size:
        bins = np.zeros_like(fin_d)
        pos = fin_d > 0
        bins[pos] = np.floor(np.log2(fin_d[pos])).astype(np.int64) + 1
        bins = np.minimum(bins, num_bins - 1)
        for b in np.unique(bins):
            sel = bins == b
            w = fin_c[sel].astype(np.float64)
            rep = int(round(float(np.average(fin_d[sel], weights=w))))
            out_d.append(rep)
            out_c.append(int(w.sum()))
    return profile_from_pairs(np.array(out_d), np.array(out_c))
