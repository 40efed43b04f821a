"""Batched reuse-distance engines on the device — port of
``repro/core/reuse/batched.py``.

The reference computes exact reuse distances with no sequential scan,
via the order-statistics identity

    rd[t] = #{s < t : prev[s] <= prev[t]} - prev[t] - 1

(prev = previous occurrence of the same line, -1 for first touch).  The
count-smaller-before-self term is a bottom-up mergesort: log2(N) rounds
of ``searchsorted`` over composite ``pair * stride + value`` int64 keys.
Here the same rounds are torch ops on the tensor's device — a stable
``torch.argsort`` for ``prev`` and ``torch.searchsorted`` for the
counts — so on the GPU the whole pass stays in device memory and only
the small histogram comes back (``core/reuse/profile.py``).

The reference's own contract (``tests/core/test_batched_rd.py``) is that
this engine is bit-identical to the Fenwick ``lax.scan`` of
``core/reuse/distance.py`` and to the vmapped multi-segment Fenwick
engine, so the port runs it for every ``engine`` value:
:func:`reuse_distances_batched` evaluates all segments in ONE offline
pass over their stable concatenation (the reference's
``_offline_segments`` form).  ``engine``, ``window`` and ``num_shards``
are accepted for the reference's signatures and change nothing: the
reference's Fenwick buckets and per-device shards are not copied, and
every value gives the same integers.
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.device import resolve_device

INF_RD: int = -1  # kept in step with core/reuse/distance.py

# The reference's default window of the vmapped Fenwick engine; accepted
# for signature parity (the port's engine has no window).
DEFAULT_SEGMENT_WINDOW = 512

#: Number of reuse-distance passes per device type ("cuda", "cpu"): one
#: per offline pass over a trace or a group of segments (counted in
#: :func:`_offline_pass`), one per streamed trace (counted by
#: ``distance.reuse_distance_windows_device``) — lets a run show where,
#: and how often, its distances were computed.
PASSES: collections.Counter = collections.Counter()

__all__ = [
    "count_leq_before",
    "reuse_distances_batched",
    "reuse_distances_offline",
]


def _prev_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Index of the previous occurrence of each key (-1 = first touch)."""
    n = keys.numel()
    order = torch.argsort(keys, stable=True)
    sv = keys[order]
    same = torch.zeros(n, dtype=torch.bool, device=keys.device)
    same[1:] = sv[1:] == sv[:-1]
    prev = torch.empty(n, dtype=torch.int64, device=keys.device)
    # order.roll(1)[i] = order[i - 1]; same[0] is False, so the wrapped
    # entry is never taken
    prev[order] = torch.where(same, order.roll(1), torch.full_like(order, -1))
    return prev


def count_leq_before(values: torch.Tensor, *,
                     num_shards: int | None = None) -> torch.Tensor:
    """A[t] = #{s < t : values[s] <= values[t]}, on ``values``' device.

    Bottom-up mergesort, as in the reference: at each level, blocks of
    width ``w`` are sorted by value (stable in the original index);
    every right-block element counts its left-block peers with one
    ``searchsorted``, and the merged order follows from the same ranks
    (left rank i goes to i + #right strictly smaller, right rank j to
    j + its count: a stable merge).  The reference searches composite
    ``pair * stride + value`` keys over ragged boolean selections; here
    ``n`` is padded to a power of two, so every level is a fixed
    ``[pairs, 2, w]`` view and one batched ``searchsorted`` per half.
    Every size is known from ``n`` on the host: no selection, no read of
    the data, no host synchronisation.  The padding sits after every
    real element, so a block that holds padding has only padding to its
    right and no real element ever counts it, whatever its value.

    ``num_shards`` is accepted for the reference's signature; the count
    is one pass for every value (the reference's chunked form is an
    exact identity, so the integers are the same).
    """
    p = torch.as_tensor(values).to(torch.int64)
    n = p.numel()
    dev = p.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    size = 1 << (n - 1).bit_length()
    vals = torch.full((size,), torch.iinfo(torch.int64).max,
                      dtype=torch.int64, device=dev)
    vals[:n] = p
    idx = torch.arange(size, dtype=torch.int64, device=dev)
    out = torch.zeros(size, dtype=torch.int64, device=dev)
    width = 1
    while width < size:
        pairs = size // (2 * width)
        v = vals.view(pairs, 2, width)
        left, right = v[:, 0].contiguous(), v[:, 1].contiguous()
        # right elements count left peers with value <= theirs (ties
        # count: left indices precede right ones)
        cnt_r = torch.searchsorted(left, right, right=True)
        cnt_l = torch.searchsorted(right, left)
        out.index_add_(0, idx.view(pairs, 2, width)[:, 1].reshape(-1),
                       cnt_r.reshape(-1))
        rank = torch.arange(width, dtype=torch.int64, device=dev)
        base = torch.arange(0, size, 2 * width, dtype=torch.int64,
                            device=dev).view(pairs, 1, 1)
        pos = (torch.stack([cnt_l, cnt_r], dim=1) + rank + base).view(-1)
        vals = torch.empty_like(vals).scatter_(0, pos, vals)
        idx = torch.empty_like(idx).scatter_(0, pos, idx)
        width *= 2
    return out[:n]


def _offline_pass(keys: torch.Tensor, starts: torch.Tensor | None = None,
                  *, counted: bool = True) -> torch.Tensor:
    """Every reuse-distance pass of the port goes through here; it adds
    one to :data:`PASSES` unless the caller counts its passes itself
    (a streamed trace counts once, not once per window).

    With ``starts`` (``starts[t]`` = first position of ``t``'s segment),
    contiguous segments of ``keys`` are scanned each as if alone.  The
    reference's ``_offline_segments`` keys each reference by
    ``segment * stride + id``; the same ``prev`` array comes from the
    plain line ids with every previous occurrence that lies before its
    segment's start cut to -1 (segments are contiguous, so the latest
    earlier occurrence of a line is in the same segment or in none).
    ``prev`` offsets then cancel per segment: every reference of an
    earlier segment has ``prev < segment offset <= prev[t]`` for any
    finite-rd ``t``.
    """
    if counted:
        PASSES[keys.device.type] += 1
    prev = _prev_occurrence(keys.to(torch.int64))
    if starts is not None:
        prev = torch.where(prev < starts, torch.full_like(prev, -1), prev)
    rd = count_leq_before(prev) - prev - 1
    return torch.where(prev < 0, torch.full_like(rd, INF_RD), rd)


def reuse_distances_offline(keys: torch.Tensor, *,
                            num_shards: int | None = None) -> torch.Tensor:
    """Exact reuse distances of one key sequence, no sequential scan.

    ``rd[t] = #{s < t : prev[s] <= prev[t]} - prev[t] - 1`` — every
    earlier position with an earlier-or-equal previous occurrence is
    either a distinct line in the reuse window or accounted for by the
    ``prev[t] + 1`` correction.  int64 on ``keys``' device.
    ``num_shards`` changes nothing (:func:`count_leq_before`).
    """
    keys = torch.as_tensor(keys)
    if keys.numel() == 0:
        return torch.empty(0, dtype=torch.int64, device=keys.device)
    return _offline_pass(keys)


def _as_lines(segment, line_size: int) -> np.ndarray:
    arr = getattr(segment, "addresses", segment)
    arr = np.asarray(arr, dtype=np.int64)
    return arr // line_size if line_size > 1 else arr


def reuse_distances_batched(
    segments,
    line_size: int = 1,
    *,
    engine: str = "auto",
    window: int = DEFAULT_SEGMENT_WINDOW,
    num_shards: int | None = None,
    device=None,
) -> list[torch.Tensor]:
    """Exact reuse distances of many independent segments, batched.

    Each segment (an address array or anything with ``.addresses``) is
    scanned as if alone — bit-identical, per segment, to
    ``reuse_distances(segment, line_size)`` — and comes back as an int64
    tensor on ``device``.  Every ``engine`` value (``auto``, ``fenwick``,
    ``offline``) runs the offline pass (module docstring); ``window``
    sizes only the reference's Fenwick engine.

    ``num_shards`` is accepted for the reference's signature.  All
    non-empty segments go through one pass over their stable
    concatenation, whatever ``engine`` and ``num_shards`` say.
    """
    if engine not in ("auto", "fenwick", "offline"):
        raise ValueError(f"unknown batched RD engine: {engine}")
    dev = resolve_device(device)
    segs = [_as_lines(s, line_size) for s in segments]
    out = [torch.empty(0, dtype=torch.int64, device=dev) for _ in segs]
    todo = [i for i, s in enumerate(segs) if s.size]
    if not todo:
        return out
    lens = [int(segs[i].size) for i in todo]
    flat = torch.from_numpy(np.concatenate([segs[i] for i in todo])).to(dev)
    starts = torch.from_numpy(
        np.repeat(np.cumsum([0] + lens[:-1]), lens)).to(dev)
    for i, rd in zip(todo, torch.split(_offline_pass(flat, starts), lens)):
        out[i] = rd
    return out
