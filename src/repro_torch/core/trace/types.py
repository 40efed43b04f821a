"""Labeled memory traces — port of ``repro/core/trace/types.py``, the
framework's analog of the paper's basic-block-labeled Byfl trace
(§3.2, Fig. 4).  Traces are host numpy arrays, generated bit for bit
as the reference generates them; only the reuse-distance pass moves
them to the device.

A :class:`LabeledTrace` is a flat sequence of memory references, each
annotated with

* ``bb_ids``      — id of the basic block (straight-line region) the
                    reference was issued from; on the LM side this is the
                    HLO instruction index;
* ``inst_ids``    — id of the *dynamic instance* of that block (the
                    paper's BB_START/BB_END markers delimit instances;
                    consecutive instances of the same block are distinct);
* ``shared_mask`` — True for references to *shared variables* (the
                    paper's ``shared_var_trace`` label; on the LM side,
                    replicated buffers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Protocol, runtime_checkable

import numpy as np


def _runs(ids: np.ndarray) -> np.ndarray:
    """Default instance ids: maximal runs of equal bb ids."""
    n = len(ids)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.ones(n, dtype=bool)
    starts[1:] = ids[1:] != ids[:-1]
    return (np.cumsum(starts) - 1).astype(np.int64)


@dataclass
class LabeledTrace:
    addresses: np.ndarray          # int64 [N]
    bb_ids: np.ndarray             # int32 [N]
    shared_mask: np.ndarray        # bool  [N]
    inst_ids: np.ndarray | None = None  # int64 [N], unique per dynamic instance
    bb_names: dict[int, str] = field(default_factory=dict)

    def __post_init__(self):
        self.addresses = np.asarray(self.addresses, dtype=np.int64)
        self.bb_ids = np.asarray(self.bb_ids, dtype=np.int32)
        self.shared_mask = np.asarray(self.shared_mask, dtype=bool)
        n = len(self.addresses)
        if self.inst_ids is None:
            self.inst_ids = _runs(self.bb_ids)
        else:
            self.inst_ids = np.asarray(self.inst_ids, dtype=np.int64)
        if not (len(self.bb_ids) == len(self.shared_mask) == len(self.inst_ids) == n):
            raise ValueError("trace fields must have equal length")

    def __len__(self) -> int:
        return len(self.addresses)

    def _instance_firsts(self) -> np.ndarray:
        """Indices of the first reference of every instance, in order."""
        n = len(self)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        starts = np.ones(n, dtype=bool)
        starts[1:] = self.inst_ids[1:] != self.inst_ids[:-1]
        return np.flatnonzero(starts)

    @property
    def bb_counts(self) -> dict[int, int]:
        """Number of dynamic instances of each basic block (Alg. 1 input)."""
        firsts = self._instance_firsts()
        if len(firsts) == 0:
            return {}
        uniq, counts = np.unique(self.bb_ids[firsts], return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, counts)}

    def instance_index(self) -> np.ndarray:
        """Per-reference rank of its instance among same-block instances
        (0-based) — drives Algorithm 1's even split."""
        n = len(self)
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        firsts = self._instance_firsts()
        first_bbs = self.bb_ids[firsts]
        order = np.argsort(first_bbs, kind="stable")
        sorted_bbs = first_bbs[order]
        grp_start = np.ones(len(firsts), dtype=bool)
        grp_start[1:] = sorted_bbs[1:] != sorted_bbs[:-1]
        grp_idx = np.cumsum(grp_start) - 1
        first_pos_of_grp = np.flatnonzero(grp_start)
        ranks = np.empty(len(firsts), dtype=np.int64)
        ranks[order] = np.arange(len(firsts)) - first_pos_of_grp[grp_idx]
        # broadcast instance rank to every reference of the instance
        starts = np.ones(n, dtype=bool)
        starts[1:] = self.inst_ids[1:] != self.inst_ids[:-1]
        inst_of_ref = np.cumsum(starts) - 1
        return ranks[inst_of_ref]

    def slice(self, start: int, stop: int) -> "LabeledTrace":
        """Contiguous sub-trace [start, stop) — views, no copies."""
        return LabeledTrace(
            self.addresses[start:stop],
            self.bb_ids[start:stop],
            self.shared_mask[start:stop],
            self.inst_ids[start:stop],
            self.bb_names,
        )

    def windows(self, window_size: int) -> Iterator["LabeledTrace"]:
        """Fixed-size windows (last one may be short) — makes every
        in-memory trace a :class:`ChunkedTraceSource`."""
        if window_size < 1:
            raise ValueError("window_size must be >= 1")
        for i in range(0, len(self), window_size):
            yield self.slice(i, i + window_size)


def rebatch_windows(
    pieces: Iterator[LabeledTrace] | list, window_size: int
) -> Iterator[LabeledTrace]:
    """Re-chunk arbitrarily-sized LabeledTrace pieces into fixed
    ``window_size`` windows (last one may be short).

    The single pend-buffer loop shared by every streaming producer (the
    interleaver's merged batches) — emitted windows carry window-local
    instance ids.
    """
    if window_size < 1:
        raise ValueError("window_size must be >= 1")
    pend_a = np.empty(0, dtype=np.int64)
    pend_b = np.empty(0, dtype=np.int32)
    pend_s = np.empty(0, dtype=bool)
    names: dict[int, str] = {}
    it = iter(pieces)
    done = False
    while not done:
        try:
            t = next(it)
            names.update(t.bb_names)
            pend_a = np.concatenate([pend_a, t.addresses])
            pend_b = np.concatenate([pend_b, t.bb_ids])
            pend_s = np.concatenate([pend_s, t.shared_mask])
        except StopIteration:
            done = True
        while len(pend_a) >= window_size or (done and len(pend_a)):
            n = min(window_size, len(pend_a))
            yield LabeledTrace(pend_a[:n], pend_b[:n], pend_s[:n], None, names)
            pend_a, pend_b, pend_s = pend_a[n:], pend_b[n:], pend_s[n:]


@runtime_checkable
class ChunkedTraceSource(Protocol):
    """A trace that can be consumed as fixed-size windows.

    The streaming pipeline (``reuse_distance_windows``,
    ``interleave_windows``, ``Session(window_size=...)``) never asks for
    the whole trace — only for windows.  ``LabeledTrace`` satisfies the
    protocol structurally.
    """

    def __len__(self) -> int: ...

    def windows(self, window_size: int) -> Iterator[LabeledTrace]: ...


def trace_from_blocks(blocks: list[tuple[str, np.ndarray, np.ndarray]]) -> LabeledTrace:
    """Build a trace from (bb_name, addresses, shared_mask) instances.

    Every tuple is ONE dynamic instance (a BB_START..BB_END region);
    repeated bb_names share a bb id but get distinct instance ids.
    """
    name_to_id: dict[str, int] = {}
    addr_parts, id_parts, shared_parts, inst_parts = [], [], [], []
    for inst, (name, addrs, shared) in enumerate(blocks):
        bb = name_to_id.setdefault(name, len(name_to_id))
        addrs = np.asarray(addrs, dtype=np.int64)
        shared = np.broadcast_to(np.asarray(shared, dtype=bool), addrs.shape)
        addr_parts.append(addrs)
        id_parts.append(np.full(len(addrs), bb, dtype=np.int32))
        shared_parts.append(shared.copy())
        inst_parts.append(np.full(len(addrs), inst, dtype=np.int64))
    if not addr_parts:
        return LabeledTrace(
            np.empty(0, np.int64), np.empty(0, np.int32), np.empty(0, bool)
        )
    return LabeledTrace(
        np.concatenate(addr_parts),
        np.concatenate(id_parts),
        np.concatenate(shared_parts),
        np.concatenate(inst_parts),
        {v: k for k, v in name_to_id.items()},
    )
