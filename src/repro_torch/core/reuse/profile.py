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

from .batched import INF_RD


@dataclass(frozen=True)
class ReuseProfile:
    """Histogram of reuse distances (host numpy arrays).

    Attributes
    ----------
    distances : sorted distinct distances; ``INF_RD`` first when present.
    counts    : occurrence count per distance.
    total     : total number of accesses (== counts.sum()).
    """

    distances: np.ndarray
    counts: np.ndarray
    total: int

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
    uniq, counts = torch.unique(rds, sorted=True, return_counts=True)
    return ReuseProfile(
        uniq.cpu().numpy(), counts.to(torch.int64).cpu().numpy(),
        int(rds.numel()),
    )
