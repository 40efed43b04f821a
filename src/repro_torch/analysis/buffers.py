"""Buffer forensics: largest per-partition tensors in an HLO module —
port of ``repro/analysis/buffers.py`` (the same outputs on the same text).

The dry-run's ``memory_analysis()`` gives only totals; when a cell
busts the 16 GB/chip budget this ranks the individual instruction
results so the offending tensor (and the sharding rule that failed to
divide it) is identifiable.  Used by the §Perf memory iterations.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

from repro_torch.analysis.hlo_cost import parse_computations, _shape_elems_bytes


_OPNAME_RE = re.compile(r'op_name="([^"]*)"')


@dataclass(frozen=True)
class BufferInfo:
    bytes: int
    op: str
    name: str
    shape: str
    computation: str
    op_name: str = ""


def largest_buffers(hlo_text: str, top: int = 20,
                    min_bytes: int = 64 * 2**20) -> list[BufferInfo]:
    comps = parse_computations(hlo_text)
    out: list[BufferInfo] = []
    for comp in comps.values():
        for ins in comp.instrs:
            if ins.op in ("parameter", "get-tuple-element", "tuple",
                          "bitcast"):
                continue
            if ins.bytes >= min_bytes:
                m = _OPNAME_RE.search(ins.rest)
                out.append(BufferInfo(
                    ins.bytes, ins.op, ins.name,
                    ins.shape_txt.strip()[:70], comp.name[:28],
                    m.group(1)[-90:] if m else "",
                ))
    out.sort(key=lambda b: -b.bytes)
    return out[:top]


def format_buffers(buffers: list[BufferInfo]) -> str:
    lines = []
    for b in buffers:
        lines.append(f"{b.bytes / 2**30:8.2f} GiB  {b.op:<20} "
                     f"{b.shape:<60} {b.computation}\n"
                     f"            ~ {b.op_name}")
    return "\n".join(lines)


def bf16_legalization_overhead(hlo_text: str,
                               min_bytes: int = 8 * 2**20) -> int:
    """Bytes the CPU backend *adds* by legalizing bf16 compute to f32.

    xla:cpu emulates bf16: internal bf16 values are upcast to f32
    (convert pairs at fusion boundaries), so bf16 temporaries occupy 2x
    their TPU size in the dry-run's memory_analysis.  This estimates the
    overstatement as half the bytes of every f32 tensor that is a
    ``convert`` of a bf16 operand, or a fusion whose fused computation
    converts a same-shaped bf16 input (the DUS-stack pattern).  The
    dry-run records both raw and adjusted figures (EXPERIMENTS.md
    §Dry-run documents the artifact with the probe).
    """
    comps = parse_computations(hlo_text)
    fusion_bodies = set()
    for comp in comps.values():
        for ins in comp.instrs:
            if ins.op == "fusion":
                m = re.search(r"calls=%?([^\s,)]+)", ins.rest)
                if m:
                    fusion_bodies.add(m.group(1))
    overhead = 0
    for comp in comps.values():
        if comp.name in fusion_bodies:
            continue  # fusion internals are not allocations
        for ins in comp.instrs:
            if ins.bytes < min_bytes or "f32[" not in ins.shape_txt:
                continue
            if ins.op == "convert":
                ops = re.findall(r"%([A-Za-z0-9_.\-]+)", ins.rest)
                if ops and "bf16[" in comp.shapes.get(ops[0], ""):
                    overhead += ins.bytes // 2
            elif ins.op == "fusion":
                m = re.search(r"calls=%?([^\s,)]+)", ins.rest)
                body = comps.get(m.group(1)) if m else None
                if body is None:
                    continue
                dims = ins.shape_txt.split("[")[-1].split("]")[0]
                for sub in body.instrs:
                    if (sub.op == "convert"
                            and f"f32[{dims}]" in sub.shape_txt):
                        ops = re.findall(r"%([A-Za-z0-9_.\-]+)", sub.rest)
                        if ops and "bf16[" in body.shapes.get(ops[0], ""):
                            overhead += ins.bytes // 2
                            break
    return overhead
