"""SHARDS-style sampled reuse profiles — port of
``repro/core/reuse/sampled.py``: constant memory, bounded error.

1. **Spatial sampling.**  A cache line is *sampled* iff a deterministic
   64-bit hash of its line id (keyed by ``seed``) falls below
   ``rate * 2**64``.  Every reference to a sampled line is kept, every
   reference to an unsampled line dropped — so the sampled subtrace
   keeps the full reuse structure *of the sampled lines*.
2. **Exact distances on the subtrace**, on the device (the port's
   offline engine, in memory or window by window).  The measured
   distance ``d`` is a binomial thinning of the true ``D``, so ``d / R``
   estimates ``D`` without bias.
3. **Rescaling.**  Finite distances ``d -> round(d / R)``; counts
   ``c -> round(c / R)``.  ``INF_RD`` mass keeps its distance and
   rescales its count only.

At ``rate == 1.0`` every line is sampled and rescaling is skipped, so
the result is bit-identical to the exact pass.  The declared
``error_bound`` is the reference's Bernstein sup-norm bound on the
Horvitz-Thompson CDF estimate with the Hajek ratio correction
(``sampling_error_bound``); it holds with probability
``>= 1 - SAMPLE_BOUND_DELTA``.

The hash, the line masses and the rescaling stay host numpy in
``uint64``/``float64``, as in the reference: torch has no unsigned
64-bit type whose shifts and compares match, and the mask and the bound
must be bit-identical.  Only the kept lines reach the device.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.device import resolve_device

from .distance import (
    DEFAULT_WINDOW,
    iter_address_windows,
    reuse_distance_windows_device,
    reuse_distances,
)
from .profile import (
    ReuseProfile,
    profile_from_distances,
    profile_from_distances_incremental,
    profile_from_pairs,
)

__all__ = [
    "SAMPLE_BOUND_DELTA",
    "sample_lines_mask",
    "sampling_error_bound",
    "sampled_reuse_profile",
    "sampled_profile_windows",
]

# Confidence parameter of the bound: it holds with probability
# >= 1 - SAMPLE_BOUND_DELTA over the hash seed (the reference's value).
SAMPLE_BOUND_DELTA = 1e-6

# splitmix64 finalizer constants — a well-mixed 64-bit permutation, so
# thresholding the hash is equivalent to Bernoulli(rate) line sampling.
_MIX_GAMMA = 0x9E3779B97F4A7C15
_MIX_MULT_1 = 0xBF58476D1CE4E5B9
_MIX_MULT_2 = 0x94D049BB133111EB
_U64 = np.uint64


def _hash_lines(lines: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic 64-bit spatial hash of line ids, keyed by seed."""
    with np.errstate(over="ignore"):
        z = lines.astype(np.int64).view(_U64) + _U64(
            (int(seed) * _MIX_GAMMA) & 0xFFFFFFFFFFFFFFFF
        )
        z = (z ^ (z >> _U64(30))) * _U64(_MIX_MULT_1)
        z = (z ^ (z >> _U64(27))) * _U64(_MIX_MULT_2)
        return z ^ (z >> _U64(31))


def sample_lines_mask(lines, *, rate: float, seed: int = 0) -> np.ndarray:
    """Boolean keep-mask over line ids: hash(line, seed) < rate * 2^64.

    Spatial, not temporal: every occurrence of a line shares one verdict,
    which is what preserves reuse structure within the sample.
    """
    _check_rate(rate)
    lines = np.asarray(lines, dtype=np.int64)
    if rate >= 1.0:
        return np.ones(lines.shape, dtype=bool)
    threshold = _U64(min(int(rate * 2.0**64), 2**64 - 1))
    return _hash_lines(lines, seed) < threshold


def sampling_error_bound(
    rate: float, n_refs: int, *,
    sq_line_mass: float | None = None,
    max_line_mass: float | None = None,
    kept_refs: int | None = None,
) -> float:
    """Bernstein sup-norm bound on the sampled profile's CDF (and hence
    on downstream SDCM hit-rate deviation); 0.0 when the pass is exact.

    ``sq_line_mass`` / ``max_line_mass`` are (estimates of) the full
    trace's ``sum_l w_l^2`` and largest per-line mass; omitted, the
    trace is taken as uniform (``w_l == 1``).  ``kept_refs`` adds the
    Hajek ratio term ``|n - S_hat| / S_hat`` with ``S_hat = kept / R``.
    """
    _check_rate(rate)
    if rate >= 1.0:
        return 0.0
    n = max(int(n_refs), 1)
    ssq = float(n) if sq_line_mass is None else max(float(sq_line_mass), 1.0)
    wmax = 1.0 if max_line_mass is None else max(float(max_line_mass), 1.0)
    log_term = math.log(2.0 * (n + 1) / SAMPLE_BOUND_DELTA)
    variance = (1.0 - rate) * ssq / (rate * float(n) ** 2)
    eps = math.sqrt(2.0 * variance * log_term) + wmax * log_term / (3.0 * rate * n)
    if kept_refs is None:
        return min(1.0, eps)
    s_hat = float(kept_refs) / rate
    if s_hat <= 0.0:
        return 1.0
    return min(1.0, eps * (n / s_hat) + abs(n - s_hat) / s_hat)


def _check_rate(rate: float) -> None:
    if not (0.0 < float(rate) <= 1.0):
        raise ValueError(f"sampling rate must be in (0, 1], got {rate!r}")


def _mass_moments(counts: np.ndarray, rate: float) -> tuple[float, float]:
    """HT estimates of (sum_l w_l^2, w_max) over the FULL trace from the
    sampled lines' (exact) masses."""
    if counts.size == 0:
        return 0.0, 1.0
    c = counts.astype(np.float64)
    return float((c * c).sum() / rate), float(c.max())


def _rescale(profile: ReuseProfile, rate: float, bound: float) -> ReuseProfile:
    """d -> round(d / R), counts -> round(c / R); INF_RD mass keeps its
    marker distance.  Attaches the declared error bound."""
    inv = 1.0 / rate
    dists = profile.distances.astype(np.float64)
    finite = profile.distances >= 0
    dists = np.where(finite, np.round(dists * inv), profile.distances)
    counts = np.maximum(np.round(profile.counts * inv), 1).astype(np.int64)
    rescaled = profile_from_pairs(dists.astype(np.int64), counts)
    return rescaled.with_error_bound(bound)


def sampled_reuse_profile(
    addresses, line_size: int = 1, *, rate: float, seed: int = 0,
    device=None,
) -> ReuseProfile:
    """Sampled reuse profile of an in-memory trace; the kept subtrace's
    distances are computed on ``device``.

    Bit-identical to ``profile_from_distances(reuse_distances(...))``
    at ``rate == 1.0`` (with ``error_bound == 0.0`` attached).
    """
    _check_rate(rate)
    dev = resolve_device(device)
    arr = np.asarray(addresses, dtype=np.int64)
    if line_size > 1:
        arr = arr // line_size
    n_refs = int(arr.size)
    if rate >= 1.0:
        exact = profile_from_distances(reuse_distances(arr, device=dev))
        return exact.with_error_bound(0.0)
    kept = arr[sample_lines_mask(arr, rate=rate, seed=seed)]
    ssq, wmax = _mass_moments(
        np.unique(kept, return_counts=True)[1], rate
    )
    sub = profile_from_distances(reuse_distances(kept, device=dev))
    return _rescale(sub, rate, sampling_error_bound(
        rate, n_refs, sq_line_mass=ssq, max_line_mass=wmax,
        kept_refs=int(kept.size),
    ))


def _rebatch(chunks, window_size: int):
    """Regroup variable-length chunks into uniform ``window_size``
    windows (plus one final partial) without ever holding more than
    one window's worth of buffered refs."""
    buf: list[np.ndarray] = []
    have = 0
    for c in chunks:
        if c.size == 0:
            continue
        buf.append(c)
        have += int(c.size)
        if have >= window_size:
            flat = np.concatenate(buf)
            off = 0
            while flat.size - off >= window_size:
                yield flat[off:off + window_size]
                off += window_size
            rest = flat[off:]
            buf = [rest] if rest.size else []
            have = int(rest.size)
    if have:
        yield np.concatenate(buf)


def sampled_profile_windows(
    source,
    line_size: int = 1,
    *,
    rate: float,
    seed: int = 0,
    window_size: int = DEFAULT_WINDOW,
    device=None,
) -> ReuseProfile:
    """Streaming sampled profile — the trace never exists in memory.

    Each address window is hash-filtered on the host before its kept
    lines reach the streaming pass on ``device``, so the scan state
    tracks only sampled lines.  Identical to
    :func:`sampled_reuse_profile` on the same trace.
    """
    _check_rate(rate)
    dev = resolve_device(device)
    n_refs = 0
    # per-sampled-line masses for the bound's HT moments, in the
    # reference's insertion order (the float sum must match bit for bit)
    mass: dict[int, int] = {}

    def counted():
        nonlocal n_refs
        for win in iter_address_windows(
            source, window_size=window_size, line_size=line_size
        ):
            n_refs += int(win.size)
            kept = win[sample_lines_mask(win, rate=rate, seed=seed)]
            if rate < 1.0 and kept.size:
                vals, cnts = np.unique(kept, return_counts=True)
                for v, c in zip(vals.tolist(), cnts.tolist()):
                    mass[v] = mass.get(v, 0) + c
            yield kept

    if rate >= 1.0:
        prof = profile_from_distances_incremental(
            reuse_distance_windows_device(
                counted(), window_size=window_size, device=dev)
        )
        return prof.with_error_bound(0.0)
    # re-chunk the (variable-length, often tiny) filtered windows to the
    # full width: the pass is bit-identical across window boundaries, and
    # full windows mean ~R times fewer passes, each with its fixed cost
    sub = profile_from_distances_incremental(
        reuse_distance_windows_device(
            _rebatch(counted(), window_size), window_size=window_size,
            device=dev,
        )
    )
    ssq, wmax = _mass_moments(
        np.fromiter(mass.values(), dtype=np.int64, count=len(mass)), rate
    )
    return _rescale(sub, rate, sampling_error_bound(
        rate, n_refs, sq_line_mass=ssq, max_line_mass=wmax,
        kept_refs=sum(mass.values()),
    ))
