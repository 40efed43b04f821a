"""Offline reuse-distance engine on the device — port of the offline
half of ``repro/core/reuse/batched.py``.

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
``core/reuse/distance.py``, so the port runs it at every trace size.
Not ported yet (ROADMAP queue A): the vmapped multi-segment Fenwick
engine, ``num_shards`` chunking, and the streaming windows.
"""
from __future__ import annotations

import torch

INF_RD: int = -1  # kept in step with core/reuse/distance.py

__all__ = ["count_leq_before", "reuse_distances_offline"]


def _prev_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Index of the previous occurrence of each key (-1 = first touch)."""
    n = keys.numel()
    order = torch.argsort(keys, stable=True)
    sv = keys[order]
    same = torch.zeros(n, dtype=torch.bool, device=keys.device)
    same[1:] = sv[1:] == sv[:-1]
    shifted = torch.empty_like(order)
    if n:
        shifted[0] = 0
        shifted[1:] = order[:-1]
    prev = torch.empty(n, dtype=torch.int64, device=keys.device)
    prev[order] = torch.where(same, shifted, torch.full_like(order, -1))
    return prev


def count_leq_before(values: torch.Tensor) -> torch.Tensor:
    """A[t] = #{s < t : values[s] <= values[t]}, on ``values``' device.

    Bottom-up mergesort: at each level, blocks of width ``w`` are sorted
    by value (stable in the original index); every right-block element
    counts its left-block peers via one ``torch.searchsorted`` over
    composite ``pair * stride + value`` keys, and the merged order is
    rebuilt from searchsorted ranks (no per-level sort).
    """
    p = values.to(torch.int64)
    n = p.numel()
    dev = p.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    if n >= (1 << 31):  # composite pair*stride keys would overflow int64
        raise ValueError("count_leq_before supports < 2^31 elements")
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    stride = n + 2
    # every value must fit under the composite-key stride; prev arrays
    # (the hot path) are already in [-1, n) and skip the compression
    if -1 <= int(p.min()) and int(p.max()) < n:
        vals = p + 1
    else:  # rank-compress, order-preserving (ties share a rank)
        _, inv = torch.unique(p, return_inverse=True)
        vals = inv.to(torch.int64) + 1
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    width = 1
    while width < n:
        pair = idx // (2 * width)
        is_right = ((idx // width) & 1).bool()
        is_left = ~is_right
        v = vals[idx]
        left_pair = pair[is_left]            # ascending (blocks in order)
        comp_left = left_pair * stride + v[is_left]
        starts = torch.searchsorted(left_pair, pair)
        # right elements: count left peers with value <= theirs (ties
        # count — the predicate is <=, and left indices precede right)
        right_pair = pair[is_right]
        q_right = right_pair * stride + v[is_right]
        cnt = torch.searchsorted(comp_left, q_right, right=True)
        cnt -= starts[is_right]
        out[idx[is_right]] += cnt
        # merge: left rank i goes to i + #right strictly smaller (ties
        # keep the left/lower-index element first); right rank j goes to
        # j + cnt (its <= count).  Ranks are local to each pair block.
        rstarts = torch.searchsorted(right_pair, pair)
        cnt_l = torch.searchsorted(q_right, comp_left)
        cnt_l -= rstarts[is_left]
        local_rank = pos - (pos // width) * width
        pair_base = pair * (2 * width)
        new_pos = torch.empty(n, dtype=torch.int64, device=dev)
        new_pos[is_left] = pair_base[is_left] + local_rank[is_left] + cnt_l
        new_pos[is_right] = pair_base[is_right] + local_rank[is_right] + cnt
        merged = torch.empty(n, dtype=torch.int64, device=dev)
        merged[new_pos] = idx  # a permutation: stable merge per pair
        idx = merged
        width *= 2
    return out


def reuse_distances_offline(keys: torch.Tensor) -> torch.Tensor:
    """Exact reuse distances of one key sequence, no sequential scan.

    ``rd[t] = #{s < t : prev[s] <= prev[t]} - prev[t] - 1`` — every
    earlier position with an earlier-or-equal previous occurrence is
    either a distinct line in the reuse window or accounted for by the
    ``prev[t] + 1`` correction.  int64 on ``keys``' device.
    """
    if keys.numel() == 0:
        return torch.empty(0, dtype=torch.int64, device=keys.device)
    prev = _prev_occurrence(keys.to(torch.int64))
    rd = count_leq_before(prev) - prev - 1
    return torch.where(prev < 0, torch.full_like(rd, INF_RD), rd)
