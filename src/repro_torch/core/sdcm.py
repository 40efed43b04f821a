"""SDCM — the Brehob–Enbody analytical cache model (paper Eq. 1–3);
port of the float64 oracle half of ``repro/core/sdcm.py``.

Conditional hit probability of an access with reuse distance D on an
A-way associative cache of B blocks:

    P(h | D) = sum_{a=0}^{A-1} C(D, a) (A/B)^a ((B-A)/B)^(D-a)      (Eq. 1)

i.e. the CDF of Binomial(D, A/B) at A-1.  The unconditional program hit
rate folds the reuse profile (Eq. 3):  P(h) = sum_i P(D_i) · P(h | D_i).

``phit_given_d_np`` and ``hit_rate`` are copied from the reference so
they give the same bits (the ``AnalyticalSDCM(backend="numpy")``
path).  The device evaluation is the hand-written kernel in
``kernels/sdcm`` behind ``api/batched.py``.
"""
from __future__ import annotations

import math

import numpy as np

from .reuse.batched import INF_RD
from .reuse.profile import ReuseProfile


def phit_given_d_np(d, assoc: int, blocks: int) -> np.ndarray:
    """Float64 oracle: direct log-space summation of Eq. 1."""
    d = np.asarray(d, dtype=np.int64)
    out = np.zeros(d.shape, dtype=np.float64)
    a_total, b_total = float(assoc), float(blocks)
    if assoc >= blocks:
        out = np.where((d >= 0) & (d < blocks), 1.0, 0.0)
        return np.where(d == INF_RD, 0.0, out)
    p = a_total / b_total
    logp, log1mp = math.log(p), math.log1p(-p)
    for i, dv in np.ndenumerate(d):
        if dv == INF_RD:
            out[i] = 0.0
        elif dv <= assoc - 1:
            out[i] = 1.0
        else:
            s = 0.0
            for k in range(assoc):
                lg = (
                    math.lgamma(dv + 1)
                    - math.lgamma(k + 1)
                    - math.lgamma(dv - k + 1)
                    + k * logp
                    + (dv - k) * log1mp
                )
                s += math.exp(lg)
            out[i] = min(1.0, s)
    return out


def hit_rate(profile: ReuseProfile, assoc: int, blocks: int) -> float:
    """Unconditional P(h) (Eq. 3) from a reuse profile."""
    if profile.total == 0:
        return 0.0
    ph = phit_given_d_np(profile.distances, assoc, blocks)
    return float(np.dot(profile.probabilities, ph))
