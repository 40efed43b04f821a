"""Algorithm 2 — interleaving private traces into the shared trace
(paper §3.2.1); port of ``repro/core/trace/interleave.py``, host numpy,
bit-identical (``uniform`` draws from ``np.random.default_rng(seed)``),
with the streaming :func:`interleave_windows` for the deterministic
strategies.

Strategies:

* ``round_robin`` — one reference per core in turn, exhausted cores are
  skipped (the paper's primary strategy; deterministic, and the natural
  analog of XLA's static schedule on the TPU side);
* ``uniform``     — at every step a uniformly-random *non-exhausted*
  core is chosen (exact, implemented phase-vectorized);
* ``chunked``     — round-robin over chunks of ``chunk_size`` references
  (models coarser timeslices).

All strategies preserve per-core program order (a trace is a FIFO), and
the interleaved trace is a permutation of the concatenation of inputs —
both properties are enforced by tests.
"""
from __future__ import annotations

import numpy as np

from .types import LabeledTrace, rebatch_windows


def _merge_by_key(traces: list[LabeledTrace], keys: list[np.ndarray]) -> LabeledTrace:
    addr = np.concatenate([t.addresses for t in traces])
    bb = np.concatenate([t.bb_ids for t in traces])
    shared = np.concatenate([t.shared_mask for t in traces])
    shift, inst_parts = 0, []
    for t in traces:
        inst_parts.append(t.inst_ids + shift)
        shift += int(t.inst_ids.max()) + 1 if len(t) else 0
    inst = np.concatenate(inst_parts)
    core = np.concatenate(
        [np.full(len(t), c, dtype=np.int32) for c, t in enumerate(traces)]
    )
    key = np.concatenate(keys)
    order = np.lexsort((core, key))
    names: dict[int, str] = {}
    for t in traces:
        names.update(t.bb_names)
    return LabeledTrace(addr[order], bb[order], shared[order], inst[order], names)


def _round_robin_keys(traces: list[LabeledTrace], chunk: int = 1) -> list[np.ndarray]:
    # sort by (position // chunk, core): chunk=1 is exact Algorithm 2
    # round-robin (exhausted cores naturally drop out of later rounds).
    return [np.arange(len(t), dtype=np.int64) // chunk for t in traces]


def _uniform_choice_sequence(
    lengths: list[int], rng: np.random.Generator
) -> np.ndarray:
    """Exact Algorithm-2 uniform interleaving, phase-vectorized.

    Each step picks uniformly among cores that still have references.
    We sample in bulk and cut each phase at the first exhaustion, which
    is distribution-identical to the per-step loop.
    """
    remaining = np.array(lengths, dtype=np.int64)
    alive = np.flatnonzero(remaining > 0)
    chosen = np.empty(int(remaining.sum()), dtype=np.int64)
    pos = 0
    while alive.size:
        budget = int(remaining[alive].sum())
        draw = alive[rng.integers(0, alive.size, size=budget)]
        # cut the phase at the first index where some core's cumulative
        # count hits its remaining quota (that core exhausts there)
        cut = budget
        for c in alive:
            idx = np.flatnonzero(draw == c)
            if idx.size >= remaining[c]:
                cut = min(cut, int(idx[remaining[c] - 1]) + 1)
        take = draw[:cut]
        chosen[pos : pos + cut] = take
        pos += cut
        uniq, cnt = np.unique(take, return_counts=True)
        remaining[uniq] -= cnt
        alive = np.flatnonzero(remaining > 0)
    return chosen[:pos]


def _uniform_keys(
    traces: list[LabeledTrace], rng: np.random.Generator
) -> list[np.ndarray]:
    choice = _uniform_choice_sequence([len(t) for t in traces], rng)
    step = np.arange(len(choice), dtype=np.int64)
    keys = []
    for c in range(len(traces)):
        keys.append(step[choice == c])
    return keys


def interleave_traces(
    traces: list[LabeledTrace],
    strategy: str = "round_robin",
    *,
    chunk_size: int = 1,
    seed: int = 0,
) -> LabeledTrace:
    """Algorithm 2: merge private traces into the shared-cache trace."""
    if not traces:
        raise ValueError("need at least one trace")
    if strategy == "round_robin":
        keys = _round_robin_keys(traces, 1)
    elif strategy == "chunked":
        keys = _round_robin_keys(traces, max(chunk_size, 1))
    elif strategy == "uniform":
        keys = _uniform_keys(traces, np.random.default_rng(seed))
    else:
        raise ValueError(f"unknown interleaving strategy: {strategy}")
    return _merge_by_key(traces, keys)


# ---------------------------------------------------------------------------
# Streaming interleaver — Algorithm 2 over windows.
# ---------------------------------------------------------------------------


class _CoreBuffer:
    """Bounded per-core read buffer over a ChunkedTraceSource."""

    def __init__(self, source, window_size: int):
        self._iter = iter(source.windows(window_size))
        self.addr = np.empty(0, dtype=np.int64)
        self.bb = np.empty(0, dtype=np.int32)
        self.shared = np.empty(0, dtype=bool)
        self.start = 0          # absolute per-core position of addr[0]
        self.done = False

    def pull(self) -> bool:
        try:
            t = next(self._iter)
        except StopIteration:
            self.done = True
            return False
        self.addr = np.concatenate([self.addr, t.addresses])
        self.bb = np.concatenate([self.bb, t.bb_ids])
        self.shared = np.concatenate([self.shared, t.shared_mask])
        return True

    def frontier_key(self, chunk: int) -> float:
        """Chunk key of the first position NOT yet buffered."""
        if self.done:
            return float("inf")
        return (self.start + len(self.addr)) // chunk

    def take_until(self, key_limit: float, chunk: int):
        """Split off the prefix whose chunk keys are < key_limit."""
        if key_limit == float("inf"):
            cut = len(self.addr)
        else:
            cut = int(min(len(self.addr),
                          max(key_limit * chunk - self.start, 0)))
        keys = (self.start + np.arange(cut, dtype=np.int64)) // chunk
        taken = (self.addr[:cut], self.bb[:cut], self.shared[:cut], keys)
        self.addr = self.addr[cut:]
        self.bb = self.bb[cut:]
        self.shared = self.shared[cut:]
        self.start += cut
        return taken


def interleave_windows(
    traces,
    strategy: str = "round_robin",
    *,
    window_size: int = 1 << 14,
    chunk_size: int = 1,
    seed: int = 0,
):
    """Streaming Algorithm 2: yield ``window_size``-sized windows of the
    interleaved shared trace without concatenating whole traces.

    Accepts any ``ChunkedTraceSource`` per core (``LabeledTrace``
    qualifies).  Peak memory is O(cores x (chunk + window)).  Emitted
    reference order is identical to ``interleave_traces`` for the
    deterministic strategies; ``uniform`` needs the global random choice
    sequence and stays in-memory-only.

    Windows carry window-local instance ids (the global renumbering of
    ``_merge_by_key`` needs the whole trace); the streaming consumers —
    reuse-distance and profile accumulation — only read addresses.
    """
    if strategy == "round_robin":
        chunk = 1
    elif strategy == "chunked":
        chunk = max(chunk_size, 1)
    elif strategy == "uniform":
        raise ValueError(
            "uniform interleaving draws one global random sequence over "
            "all trace lengths and cannot stream; use interleave_traces"
        )
    else:
        raise ValueError(f"unknown interleaving strategy: {strategy}")
    del seed  # deterministic strategies ignore it (signature parity)
    sources = list(traces)
    if not sources:
        raise ValueError("need at least one trace")
    names: dict[int, str] = {}
    for s in sources:
        names.update(getattr(s, "bb_names", {}))
    bufs = [_CoreBuffer(s, window_size) for s in sources]

    def merged_batches():
        """Key-ordered batches, each cut at a safe chunk boundary."""
        target = 0.0
        while True:
            for buf in bufs:
                while not buf.done and buf.frontier_key(chunk) <= target:
                    buf.pull()
            safe = min(buf.frontier_key(chunk) for buf in bufs)
            parts = [buf.take_until(safe, chunk) for buf in bufs]
            core_ids = np.concatenate(
                [np.full(len(p[0]), c, dtype=np.int64)
                 for c, p in enumerate(parts)]
            )
            keys = np.concatenate([p[3] for p in parts])
            order = np.lexsort((core_ids, keys))
            yield LabeledTrace(
                np.concatenate([p[0] for p in parts])[order],
                np.concatenate([p[1] for p in parts])[order],
                np.concatenate([p[2] for p in parts])[order],
                None,
                names,
            )
            if safe == float("inf"):
                return
            target = safe

    yield from rebatch_windows(merged_batches(), window_size)
