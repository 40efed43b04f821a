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
always runs the offline engine (:mod:`.batched`) as torch ops on the
requested device.

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

Not ported yet (ROADMAP queue A): the Fenwick scan as an engine of its
own, ``per_set_reuse_distances`` and ``reuse_distances_batched``.
"""
from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

from .batched import INF_RD, reuse_distances_offline

# Streaming window default (the reference's).
DEFAULT_WINDOW: int = 1 << 14

#: Number of reuse-distance passes per device type ("cuda", "cpu"): one
#: per :func:`reuse_distances` call and one per streamed trace — lets a
#: run show where its distances were computed.
PASSES: collections.Counter = collections.Counter()

#: Number of windows scanned per device type by the streaming passes.
WINDOWS: collections.Counter = collections.Counter()


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


def reuse_distances(addresses, line_size: int = 1, *,
                    device) -> torch.Tensor:
    """Reuse distances of a trace as an int64 tensor on ``device``.

    ``line_size > 1`` maps addresses to lines first (cache prediction
    operates on line reuse, paper §3.3.2).  Bit-identical to every
    engine of the reference's ``reuse_distances``.
    """
    dev = torch.device(device)
    arr = torch.as_tensor(np.asarray(addresses, dtype=np.int64)).to(dev)
    PASSES[dev.type] += 1
    if line_size > 1:
        arr = arr // line_size
    return reuse_distances_offline(arr)


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
    return seq[torch.sort(order[last]).values]


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
    PASSES[dev.type] += 1
    live = torch.empty(0, dtype=torch.int64, device=dev)
    for awin in iter_address_windows(
        source, window_size=window_size, line_size=line_size
    ):
        WINDOWS[dev.type] += 1
        if awin.size == 0:
            yield torch.empty(0, dtype=torch.int64, device=dev)
            continue
        seq = torch.cat([live, torch.from_numpy(awin).to(dev)])
        rds = reuse_distances_offline(seq)[live.numel():]
        live = _last_occurrence_order(seq)
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
        yield rds.cpu().numpy()


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
