"""Reuse (LRU stack) distances — port of ``repro/core/reuse/distance.py``
(paper §2.3 / §3.3.1).

Conventions
-----------
* A reuse distance of ``INF_RD`` (= -1 sentinel) marks a first-touch
  (compulsory) access, the paper's ``D = ∞``.
* Distances are measured in *distinct elements* (addresses or cache
  lines) accessed strictly between two uses of the same element
  (Table 1 of the paper).

The reference routes short traces through a jitted Fenwick
``lax.scan`` and long ones through its offline engine; the two are
bit-identical by the reference's own contract
(``tests/core/test_batched_rd.py``), so :func:`reuse_distances` here
runs the offline engine (:mod:`.batched`) as torch ops on the
requested device for every ``method``.

Per-set distances (:func:`per_set_reuse_distances`, the exact-LRU
simulator's input) stay on the device as well: one offline pass over
the lines in stable per-set order, for every ``method``.

The streaming windows (:func:`reuse_distance_windows_device` and the
functions over it) run the same engine window by window.  The
reference carries a Fenwick tree over a compacted timeline from one
window to the next; here the carried state is the live lines ordered
by last occurrence (the reference's own compaction), because a
distance depends only on the relative order of last occurrences.  Each
window runs the offline engine over ``[live lines] ++ [window]`` and
keeps the last ``w`` outputs: bit-identical to the in-memory pass at
every window size, with peak memory bounded by the window plus the
distinct lines seen so far.
"""
from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

from .batched import INF_RD, PASSES, _offline_pass, reuse_distances_offline

# Streaming window default (the reference's).
DEFAULT_WINDOW: int = 1 << 14

# The reference's routing sizes, kept for its names.  Its
# ``reuse_distances`` leaves the Fenwick scan for the offline engine at
# RD_OFFLINE_THRESHOLD references, and its ``per_set_reuse_distances``
# switches from the monolithic scan to the batched engine at
# PER_SET_BATCH_THRESHOLD.  The port runs one offline pass for every
# method, so neither routes anything here.
RD_OFFLINE_THRESHOLD: int = 1 << 13
PER_SET_BATCH_THRESHOLD: int = 1 << 15

#: Number of windows scanned per device type by the streaming passes.
WINDOWS: collections.Counter = collections.Counter()

#: Host seconds of the streaming passes, split: "iterate" (the window
#: iterator and the copy to the device), "offline" (the offline pass
#: over live lines + window) and "live_set" (the live-set update).
WINDOW_SECONDS: collections.Counter = collections.Counter()


def reuse_distances_ref(addresses) -> np.ndarray:
    """O(N·M) LRU-stack reuse distances.  Ground-truth oracle for tests.

    Reproduces Table 1 of the paper exactly (first touch -> INF_RD).
    """
    stack: list = []  # stack[0] is most-recently-used
    out = np.empty(len(addresses), dtype=np.int64)
    for t, a in enumerate(addresses):
        try:
            d = stack.index(a)
            out[t] = d
            stack.pop(d)
        except ValueError:
            out[t] = INF_RD
        stack.insert(0, a)
    return out


def compact_ids(addresses) -> np.ndarray:
    """Map arbitrary (possibly 64-bit) addresses to dense int32 ids."""
    arr = np.asarray(addresses)
    _, inv = np.unique(arr, return_inverse=True)
    return inv.astype(np.int32)


def as_device_lines(addresses, line_size: int,
                    dev: torch.device) -> torch.Tensor:
    """An address array or tensor as int64 line ids on ``dev``."""
    if isinstance(addresses, torch.Tensor):
        arr = addresses.to(dev, torch.int64)  # repro-lint: disable=TS103 -- ROADMAP "Profile builds sync once per cell"
    else:
        arr = torch.from_numpy(np.asarray(addresses, dtype=np.int64)).to(dev)  # repro-lint: disable=TS103 -- ROADMAP "Profile builds sync once per cell"
    return arr // line_size if line_size > 1 else arr


def reuse_distances(addresses, line_size: int = 1, *,
                    method: str = "auto", device) -> torch.Tensor:
    """Reuse distances of a trace as an int64 tensor on ``device``.

    ``line_size > 1`` maps addresses to lines first (cache prediction
    operates on line reuse, paper §3.3.2).  ``method`` is the
    reference's engine choice (``auto``/``scan``/``offline``); every
    value gives the same integers, and every value runs the offline
    engine here.
    """
    if method not in ("auto", "scan", "offline"):
        raise ValueError(f"unknown reuse-distance method: {method}")
    dev = torch.device(device)
    return reuse_distances_offline(as_device_lines(addresses, line_size, dev))


def split_by_set(
    addresses, *, line_size: int, num_sets: int
) -> tuple[list[np.ndarray], np.ndarray]:
    """Stable per-set decomposition of a trace (host numpy).

    Returns the per-set line-id segments (sets in ascending order,
    program order preserved within each set) and the stable sort
    ``order`` mapping concatenated segment positions back to original
    trace positions (``out[order] = concat(per_segment_results)``).
    """
    arr = np.asarray(addresses, dtype=np.int64)
    lines = arr // line_size
    sets = lines % num_sets
    order = np.argsort(sets, kind="stable")
    cuts = np.flatnonzero(np.diff(sets[order])) + 1
    return np.split(lines[order], cuts), order


def per_set_reuse_distances(
    addresses, *, line_size: int, num_sets: int, method: str = "auto",
    device=None,
) -> torch.Tensor:
    """Per-set reuse distances for set-associative LRU simulation, as an
    int64 tensor on ``device``.

    An access hits an ``A``-way set-associative LRU cache iff the number
    of *distinct same-set lines* touched since the last use of its line
    is < A.  The lines are reordered stably by set on the device; within
    that order the window between two occurrences of a line holds only
    same-set accesses, so one offline pass over it gives every set's
    distances.  That is what the reference's ``monolithic`` method
    scans, and its ``batched`` method cuts the same order into per-set
    segments, each of which already holds every earlier occurrence of
    its lines: ``method`` (``auto``/``monolithic``/``batched``) is
    checked and the one pass runs for every value.  Bit-identical to
    the reference's.
    """
    if method not in ("auto", "monolithic", "batched"):
        raise ValueError(f"unknown per-set method: {method}")
    dev = resolve_device(device)
    lines = as_device_lines(addresses, line_size, dev)
    if lines.numel() == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    order = torch.argsort(lines % num_sets, stable=True)
    out = torch.empty_like(lines)
    out[order] = _offline_pass(lines[order])
    return out


def iter_address_windows(
    source, *, window_size: int = DEFAULT_WINDOW, line_size: int = 1
) -> Iterator[np.ndarray]:
    """Normalize any trace-like input into int64 line-id windows.

    Accepts a ``ChunkedTraceSource`` (anything with ``.windows()``,
    including ``LabeledTrace``), a flat address array, or an iterable of
    already-windowed pieces (``LabeledTrace`` windows or arrays).
    """
    if hasattr(source, "windows"):
        pieces: Iterable = source.windows(window_size)
    elif isinstance(source, np.ndarray) or (
        isinstance(source, (list, tuple))
        and (
            len(source) == 0
            or (
                not hasattr(source[0], "addresses")
                and np.ndim(source[0]) == 0
            )
        )
    ):
        arr = np.asarray(source, dtype=np.int64)
        pieces = (
            arr[i: i + window_size] for i in range(0, arr.size, window_size)
        )
    else:  # an iterator/iterable of windows
        pieces = source
    for piece in pieces:
        a = piece.addresses if hasattr(piece, "addresses") else piece
        a = np.asarray(a, dtype=np.int64)
        if line_size > 1:
            a = a // line_size
        yield a


def _last_occurrence_order(seq: torch.Tensor) -> torch.Tensor:
    """The distinct keys of ``seq``, ordered by their last occurrence."""
    order = torch.argsort(seq, stable=True)
    sv = seq[order]
    last = torch.ones(seq.numel(), dtype=torch.bool, device=seq.device)
    last[:-1] = sv[:-1] != sv[1:]
    return seq[torch.sort(order[last]).values]  # repro-lint: disable=TS102 -- ROADMAP "Streaming profiles sync once per window"


def reuse_distance_windows_device(
    source,
    line_size: int = 1,
    *,
    window_size: int = DEFAULT_WINDOW,
    device=None,
) -> Iterator[torch.Tensor]:
    """Per-window reuse distances as int64 tensors on ``device``.

    Bit-identical, window by window, to :func:`reuse_distances` over the
    concatenated trace.  The binned profile path
    (:mod:`repro_torch.core.reuse.fused`) feeds these straight into the
    ``kernels/reuse_hist`` histogram, so a streaming profile build never
    copies distances to the host.
    """
    if window_size < 1:
        raise ValueError("window_size must be >= 1")
    dev = resolve_device(device)
    PASSES[dev.type] += 1  # one per streamed trace; windows are uncounted
    live = torch.empty(0, dtype=torch.int64, device=dev)
    windows = iter_address_windows(
        source, window_size=window_size, line_size=line_size
    )
    while True:
        t0 = time.perf_counter()
        awin = next(windows, None)
        if awin is None:
            return
        WINDOWS[dev.type] += 1
        if awin.size == 0:
            yield torch.empty(0, dtype=torch.int64, device=dev)
            continue
        seq = torch.cat([live, torch.from_numpy(awin).to(dev)])  # repro-lint: disable=TS103 -- ROADMAP "Streaming profiles sync once per window"
        t1 = time.perf_counter()
        rds = _offline_pass(seq, counted=False)[live.numel():]
        t2 = time.perf_counter()
        live = _last_occurrence_order(seq)
        t3 = time.perf_counter()
        WINDOW_SECONDS["iterate"] += t1 - t0
        WINDOW_SECONDS["offline"] += t2 - t1
        WINDOW_SECONDS["live_set"] += t3 - t2
        yield rds


def reuse_distance_windows(
    source,
    line_size: int = 1,
    *,
    window_size: int = DEFAULT_WINDOW,
    device=None,
) -> Iterator[np.ndarray]:
    """Per-window reuse distances of a (possibly huge) trace as host
    int64 arrays, computed on ``device``; bit-identical, window by
    window, to :func:`reuse_distances` over the concatenated trace.
    Feed them to ``profile_from_distances_incremental``."""
    for rds in reuse_distance_windows_device(
        source, line_size, window_size=window_size, device=device
    ):
        yield rds.cpu().numpy()  # repro-lint: disable=TS102 -- host-window API: a host array per window is its contract


def reuse_distances_streaming(
    source,
    line_size: int = 1,
    *,
    window_size: int = DEFAULT_WINDOW,
    device=None,
) -> torch.Tensor:
    """Streaming counterpart of :func:`reuse_distances`: an int64 tensor
    on ``device``, bit-identical to the in-memory pass for every window
    size; the scan state is bounded by the window and the lines seen."""
    dev = resolve_device(device)
    parts = list(reuse_distance_windows_device(
        source, line_size, window_size=window_size, device=dev
    ))
    if not parts:
        return torch.empty(0, dtype=torch.int64, device=dev)
    return torch.cat(parts)
