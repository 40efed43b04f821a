"""Algorithm 1 — private memory trace generation (paper §3.2); port of
``repro/core/trace/mimic.py``, host numpy, bit-identical.

From ONE sequential basic-block-labeled trace, synthesize the private
trace of each core as if the parallel section ran on ``num_cores``
cores with OpenMP static scheduling:

* blocks executed fewer times than there are cores (entry/exit blocks,
  per-thread prologues) are **copied** to every core;
* blocks with >= num_cores instances (loop bodies) are **split evenly**
  (optionally with a chunk size, like ``schedule(static, chunk)``);
* every non-shared reference gets a per-core address offset so mimicked
  references are distinct across cores; references to shared variables
  (the ``shared_var_trace`` label) keep their address on every core.

Disambiguation vs. the paper's pseudocode: when ``bb_count == num_cores``
the pseudocode's ``bb_count_per_core == 1`` test would hit the *copy*
branch even though the split branch computed the value; we key the copy
branch on ``bb_count < num_cores`` (the line-6 condition), which is the
stated intent ("Each core gets a copy of BB" only for under-replicated
blocks).
"""
from __future__ import annotations

import numpy as np

from .types import LabeledTrace


def choose_offset(addresses: np.ndarray, alignment: int = 4096) -> int:
    """Per-core address offset: larger than the trace's footprint and
    aligned, so mimicked references never collide with the originals
    (§3.2: "We choose the offset so that the mimicked memory references
    do not match the original")."""
    if len(addresses) == 0:
        return alignment
    span = int(addresses.max()) + 1
    return -(-span // alignment) * alignment  # ceil to alignment


def core_assignment(
    trace: LabeledTrace, num_cores: int, chunk_size: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """(replicate_mask, core_of_ref) for every reference.

    ``replicate_mask[i]`` — reference i is copied to every core.
    ``core_of_ref[i]``    — owning core otherwise.
    """
    counts_by_bb = trace.bb_counts
    max_bb = int(trace.bb_ids.max()) + 1 if len(trace) else 0
    counts = np.zeros(max_bb, dtype=np.int64)
    for bb, c in counts_by_bb.items():
        counts[bb] = c
    ref_counts = counts[trace.bb_ids] if len(trace) else np.zeros(0, np.int64)
    replicate = ref_counts < num_cores

    inst = trace.instance_index()
    if chunk_size is not None and chunk_size > 0:
        core = (inst // chunk_size) % num_cores
    else:
        per_core = np.maximum(ref_counts // num_cores, 1)
        core = np.minimum(inst // per_core, num_cores - 1)
    return replicate, core.astype(np.int64)


def gen_private_traces(
    trace: LabeledTrace,
    num_cores: int,
    *,
    chunk_size: int | None = None,
    offset: int | None = None,
) -> list[LabeledTrace]:
    """Algorithm 1: the mimicked private trace of each core."""
    if num_cores < 1:
        raise ValueError("num_cores must be >= 1")
    if num_cores == 1:
        return [trace]
    if offset is None:
        offset = choose_offset(trace.addresses)
    replicate, core_of_ref = core_assignment(trace, num_cores, chunk_size)

    out: list[LabeledTrace] = []
    for core in range(num_cores):
        sel = replicate | (core_of_ref == core)
        addrs = trace.addresses[sel].copy()
        shared = trace.shared_mask[sel]
        # offset non-shared references for cores other than the master
        if core > 0:
            addrs = np.where(shared, addrs, addrs + offset * core)
        out.append(
            LabeledTrace(
                addrs,
                trace.bb_ids[sel],
                shared,
                trace.inst_ids[sel],
                dict(trace.bb_names),
            )
        )
    return out
