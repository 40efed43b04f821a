"""HLO -> basic-block-labeled memory trace — the paper's pipeline
pointed at the compiled XLA program; port of
``repro/analysis/hlo_trace.py`` (bit-identical traces on the same text).

PPT-Multicore's front end turns a ROSE-translated binary into a
BB-labeled memory trace via Byfl, then predicts cache behaviour from
reuse profiles.  Here the "program" is the post-SPMD HLO module: every
instruction is a single-entry/single-exit block (the BB analog), its
operand/result buffers are the memory references, while-loop trip
counts are the BB execution counts, and the *shared vs private* label
maps to replicated (weights) vs partitioned (activations) buffers.

The trace feeds the same PRD/CRD -> SDCM machinery to estimate the
VMEM residency of the compiled step (VMEM modeled as the paper's LLC,
see hw.targets.TPUTarget.vmem_cache_config), giving a reuse-aware
refinement of the roofline memory term: HBM traffic ~= (1 - P(hit)) x
touched bytes.

Tractability knobs (documented approximations):
* buffers emit at most ``refs_cap`` strided references (granule grows
  with buffer size) — same spirit as the paper's sampled traces;
* loops emit ``loop_cap`` iterations and the profile is scaled by
  trips/loop_cap (iterations are periodic; the first is cold).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.analysis.hlo_cost import (
    HloCostModel, _BODY_RE, _OPERANDS_RE, _TRIP_RE,
    _shape_elems_bytes,
)
from repro_torch.core.trace.types import LabeledTrace, trace_from_blocks


@dataclass
class _Buffer:
    base: int
    nbytes: int
    shared: bool  # replicated/parameter-like = shared (paper semantics)


class _TraceState:
    def __init__(self, granule: int, refs_cap: int):
        self.granule = granule
        self.refs_cap = refs_cap
        self.buffers: dict[str, _Buffer] = {}
        self.next_base = 1 << 12
        self.blocks: list[tuple[str, np.ndarray, np.ndarray]] = []
        self.touched_bytes = 0.0

    def buffer(self, name: str, nbytes: int, shared: bool) -> _Buffer:
        buf = self.buffers.get(name)
        if buf is None:
            base = self.next_base
            self.next_base += max(
                self.granule,
                ((nbytes + self.granule - 1) // self.granule) * self.granule,
            )
            buf = _Buffer(base, nbytes, shared)
            self.buffers[name] = buf
        return buf

    def refs_for(self, buf: _Buffer) -> np.ndarray:
        lines = max(1, buf.nbytes // self.granule)
        take = min(lines, self.refs_cap)
        idx = np.linspace(0, lines - 1, take).astype(np.int64)
        return buf.base + idx * self.granule


def hlo_to_trace(
    hlo_text: str,
    granule: int = 512,
    refs_cap: int = 16,
    loop_cap: int = 2,
    max_refs: int = 400_000,
) -> tuple[LabeledTrace, dict]:
    """Build the labeled trace of one executable step.

    Returns (trace, info) where info holds touched_bytes, the loop
    scaling factor applied, and per-label counts."""
    model = HloCostModel(hlo_text)
    state = _TraceState(granule, refs_cap)
    total_scale = {"applied": 1.0}

    entry_comp = model.comps.get(model.entry)
    entry_params = {
        ins.name for ins in (entry_comp.instrs if entry_comp else [])
        if ins.op == "parameter"
    }

    def emit(comp_name: str, prefix: str, depth: int):
        comp = model.comps.get(comp_name)
        if comp is None:
            return
        for ins in comp.instrs:
            if len(state.blocks) * refs_cap > max_refs:
                return
            if ins.op in ("parameter", "constant", "get-tuple-element",
                          "tuple", "bitcast", "after-all"):
                continue
            if ins.op == "while":
                body = _BODY_RE.search(ins.rest)
                mt = _TRIP_RE.search(ins.rest)
                trips = int(mt.group(1)) if mt else 1
                reps = min(trips, loop_cap)
                if body:
                    for it in range(reps):
                        emit(body.group(1), f"{prefix}/{ins.name}@{it}",
                             depth + 1)
                    if reps:
                        total_scale["applied"] = max(
                            total_scale["applied"], trips / reps)
                continue
            if ins.op in ("fusion", "call"):
                pass  # boundary refs below; internals don't touch HBM
            addrs, shared_mask = [], []
            operands = _OPERANDS_RE.findall(ins.rest.split(")")[0])
            for opnd in operands[:6]:
                shape_txt = comp.shapes.get(opnd, "")
                _, nbytes = _shape_elems_bytes(shape_txt)
                if nbytes <= 0:
                    continue
                shared = opnd in entry_params
                buf = state.buffer(f"{comp_name}/{opnd}", nbytes, shared)
                r = state.refs_for(buf)
                addrs.append(r)
                shared_mask.append(np.full(len(r), shared))
                state.touched_bytes += nbytes
            if ins.bytes > 0:
                buf = state.buffer(f"{comp_name}/{ins.name}", ins.bytes,
                                   False)
                r = state.refs_for(buf)
                addrs.append(r)
                shared_mask.append(np.full(len(r), False))
                state.touched_bytes += ins.bytes
            if addrs:
                state.blocks.append((
                    f"{ins.op}:{prefix}",
                    np.concatenate(addrs),
                    np.concatenate(shared_mask),
                ))

    emit(model.entry, "main", 0)
    trace = trace_from_blocks(state.blocks)
    info = {
        "touched_bytes": state.touched_bytes,
        "loop_scale": total_scale["applied"],
        "num_buffers": len(state.buffers),
        "num_blocks": len(state.blocks),
        "granule": granule,
    }
    return trace, info


def vmem_hit_rate(trace: LabeledTrace, granule: int = 512, *,
                  device=None) -> float:
    """SDCM hit rate of the step's trace against the VMEM-as-LLC model;
    the reuse distances are computed on ``device`` (the card unless
    ``"cpu"`` is asked for), the hit rate by the float64 oracle."""
    from repro_torch.core import sdcm
    from repro_torch.core.reuse.profile import profile_from_trace
    from repro_torch.hw.targets import TPU_V5E

    prof = profile_from_trace(trace.addresses, granule, device=device)
    blocks = max(1, TPU_V5E.vmem_bytes // granule)
    return sdcm.hit_rate(prof, blocks, blocks)  # fully associative


def refined_memory_term(
    hbm_bytes: float, trace: LabeledTrace, granule: int = 512, *,
    device=None,
) -> dict:
    """Reuse-aware memory term: the flat roofline charges every touched
    byte to HBM; the paper's model discounts VMEM-resident reuse."""
    from repro_torch.hw.targets import TPU_V5E

    p_hit = vmem_hit_rate(trace, granule, device=device)
    effective = hbm_bytes * (1.0 - p_hit) + hbm_bytes * p_hit * (
        TPU_V5E.hbm_bandwidth / 1e13)  # VMEM-hit bytes ~free vs HBM
    return {
        "vmem_hit_rate": p_hit,
        "flat_memory_s": hbm_bytes / TPU_V5E.hbm_bandwidth,
        "refined_memory_s": effective / TPU_V5E.hbm_bandwidth,
    }
