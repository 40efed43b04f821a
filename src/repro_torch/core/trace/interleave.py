"""Algorithm 2 — interleaving private traces into the shared trace
(paper §3.2.1); port of ``repro/core/trace/interleave.py``, host numpy,
bit-identical (``uniform`` draws from ``np.random.default_rng(seed)``).
The streaming ``interleave_windows`` is not ported yet (ROADMAP queue A).

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

from .types import LabeledTrace


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
