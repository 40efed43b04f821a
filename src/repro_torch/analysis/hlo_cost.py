"""Loop-aware static HLO cost analysis — the Byfl analog for XLA; port
of ``repro/analysis/hlo_cost.py`` (the same outputs on the same text).

``compiled.cost_analysis()`` counts a ``while`` body ONCE
(probe-verified), so every scan-over-layers / grad-accumulation cell
under-reports FLOPs, bytes and collective traffic by the trip count.
PPT-Multicore's methodology is static instrumentation (Byfl) that
counts ops per basic block times the block's execution count — this
module does precisely that on the optimized HLO: parse computations
(basic blocks), extract while-loop trip counts (execution counts), and
accumulate dot-exact FLOPs, fusion-boundary bytes, and ring-model
collective traffic, each multiplied by the enclosing loops' trips.

Costs:
* dot: 2 · result_elems · Π contracting dims (exact).
* fusion: FLOPs of the fused computation; bytes = operands + result
  (the fusion boundary is what touches HBM — better than
  cost_analysis' per-op accounting).
* elementwise/reduce: 1 FLOP per result (resp. operand) element.
* while: (body + condition) × trip_count, trips from the condition's
  ``compare(induction, constant)``.
* collectives: ring-model per-chip traffic (see ``analysis/hlo.py``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.analysis.hlo import _DTYPE_BYTES, _group_size, _traffic

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
_SHAPE_TOKEN = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_ASSIGN_RE = re.compile(r"^\s*(?:ROOT\s+)?%([^\s=]+)\s*=\s*(.*)$")
_OPCALL_RE = re.compile(r"\b([a-z][a-z0-9\-]*)\(")
_TRIP_RE = re.compile(r'known_trip_count[^}]*"n"\s*:\s*"(\d+)"')
_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([^\s(]+)\s*\(")
_CALLS_RE = re.compile(r"(?:calls|body|condition|to_apply)=%?([^\s,)]+)")
_BODY_RE = re.compile(r"body=%?([^\s,)]+)")
_COND_RE = re.compile(r"condition=%?([^\s,)]+)")
_OPERANDS_RE = re.compile(r"%([A-Za-z0-9_.\-]+)")
_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}")
_CONSTANT_RE = re.compile(r"constant\((\d+)\)")

_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "copy", "copy-start", "copy-done", "after-all", "partition-id",
    "replica-id", "custom-call", "get-dimension-size", "iota", "broadcast",
    "reshape", "transpose", "slice", "dynamic-slice", "dynamic-update-slice",
    "concatenate", "pad", "reverse", "gather", "scatter", "select-and-scatter",
    "convert", "reduce-precision", "rng", "rng-bit-generator", "domain",
    "opt-barrier", "send", "send-done", "recv", "recv-done", "infeed",
    "outfeed",
}
# data-movement ops above cost bytes (via fusion boundaries) but ~0 FLOPs.


def _shape_elems_bytes(shape_txt: str) -> tuple[list[int], int]:
    elems, total = [], 0
    for dtype, dims in _SHAPE_TOKEN.findall(shape_txt):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        elems.append(n)
        total += n * _DTYPE_BYTES[dtype]
    return elems, total


@dataclass
class Instr:
    name: str
    shape_txt: str
    op: str
    rest: str
    elems: int
    bytes: int


@dataclass
class Computation:
    name: str
    instrs: list[Instr] = field(default_factory=list)
    shapes: dict = field(default_factory=dict)   # instr name -> shape_txt


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    ici_bytes: float = 0.0
    transcendental: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_bytes: dict = field(default_factory=dict)
    op_flops: dict = field(default_factory=dict)

    def add(self, other: "CostTotals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.ici_bytes += other.ici_bytes * mult
        self.transcendental += other.transcendental * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0) + v * mult
        for k, v in other.op_flops.items():
            self.op_flops[k] = self.op_flops.get(k, 0) + v * mult

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "ici_bytes": self.ici_bytes,
            "transcendental": self.transcendental,
            "collective_counts": {k: float(v) for k, v in self.coll_counts.items()},
            "collective_bytes": {k: float(v) for k, v in self.coll_bytes.items()},
            "dominant_flop_ops": dict(sorted(
                self.op_flops.items(), key=lambda kv: -kv[1])[:8]),
        }


def parse_computations(hlo_text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    current: Computation | None = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not stripped:
            continue
        if not line.startswith(" ") and ("->" in line) and stripped.endswith("{"):
            m = _COMP_HDR_RE.match(stripped)
            if m:
                current = Computation(m.group(1))
                comps[current.name] = current
            continue
        if stripped.startswith("}"):
            continue
        if current is None:
            continue
        m = _ASSIGN_RE.match(line)
        if not m:
            continue
        name, tail = m.groups()
        mo = _OPCALL_RE.search(tail)
        if not mo:
            continue
        shape_txt, op, rest = tail[: mo.start()], mo.group(1), tail[mo.end():]
        elems_list, nbytes = _shape_elems_bytes(shape_txt)
        instr = Instr(name, shape_txt, op, rest, sum(elems_list), nbytes)
        current.instrs.append(instr)
        current.shapes[name] = shape_txt
    return comps


class HloCostModel:
    def __init__(self, hlo_text: str):
        self.text = hlo_text
        self.comps = parse_computations(hlo_text)
        m = re.search(r"num_partitions=(\d+)", hlo_text)
        self.num_partitions = int(m.group(1)) if m else 1
        self._memo: dict[str, CostTotals] = {}
        entry = re.search(r"ENTRY\s+%?([^\s(]+)", hlo_text)
        self.entry = entry.group(1) if entry else next(iter(self.comps), None)

    # --- helpers ---------------------------------------------------------

    def _trip_count(self, cond_name: str) -> float:
        comp = self.comps.get(cond_name)
        if comp is None:
            return 1.0
        consts = []
        for ins in comp.instrs:
            if ins.op == "constant":
                mm = re.match(r"\s*(\d+)\s*\)", ins.rest)
                if mm:
                    consts.append(int(mm.group(1)))
            mm = _CONSTANT_RE.search(ins.rest)
            if mm:
                consts.append(int(mm.group(1)))
        return float(max(consts)) if consts else 1.0

    def _dot_flops(self, comp: Computation, ins: Instr) -> float:
        ops = _OPERANDS_RE.findall(ins.rest)
        contract = 1
        m = _CONTRACT_RE.search(ins.rest)
        if m and ops:
            lhs_shape_txt = comp.shapes.get(ops[0], "")
            dims_m = _SHAPE_TOKEN.search(lhs_shape_txt)
            if dims_m:
                dims = [int(d) for d in dims_m.group(2).split(",") if d]
                for idx in (int(i) for i in m.group(1).split(",") if i):
                    if idx < len(dims):
                        contract *= dims[idx]
        return 2.0 * ins.elems * contract

    # --- main ------------------------------------------------------------

    def computation_cost(self, name: str) -> CostTotals:
        if name in self._memo:
            return self._memo[name]
        total = CostTotals()
        self._memo[name] = total  # break cycles defensively
        comp = self.comps.get(name)
        if comp is None:
            return total
        for ins in comp.instrs:
            if ins.op.endswith("-done"):
                continue  # async completion: payload counted at -start
            base_op = ins.op[:-6] if ins.op.endswith("-start") else ins.op
            if base_op in _COLLECTIVES:
                sizes, _ = _shape_elems_bytes(ins.shape_txt)
                dts = [d for d, _ in _SHAPE_TOKEN.findall(ins.shape_txt)
                       if d in _DTYPE_BYTES]
                per = [e * _DTYPE_BYTES[d] for e, d in zip(sizes, dts)]
                if not per:
                    continue
                rb = sum(per) if base_op == "all-reduce" else (
                    max(per) if ins.op.endswith("-start") else sum(per))
                n = _group_size(ins.rest, self.num_partitions)
                total.coll_counts[base_op] = total.coll_counts.get(base_op, 0) + 1
                total.coll_bytes[base_op] = total.coll_bytes.get(base_op, 0) + rb
                total.ici_bytes += _traffic(base_op, rb, n)
                total.bytes += rb
                continue
            if ins.op == "while":
                body = _BODY_RE.search(ins.rest)
                cond = _COND_RE.search(ins.rest)
                mt = _TRIP_RE.search(ins.rest)  # XLA's own trip analysis
                if mt:
                    trips = float(mt.group(1))
                else:
                    trips = self._trip_count(cond.group(1)) if cond else 1.0
                if body:
                    total.add(self.computation_cost(body.group(1)), trips)
                if cond:
                    total.add(self.computation_cost(cond.group(1)), trips)
                continue
            if ins.op in ("fusion", "call", "map", "async-start"):
                m = _CALLS_RE.search(ins.rest)
                sub_ops = set()
                if m:
                    sub = self.computation_cost(m.group(1))
                    sub_no_bytes = CostTotals(
                        flops=sub.flops, ici_bytes=sub.ici_bytes,
                        transcendental=sub.transcendental,
                        coll_counts=dict(sub.coll_counts),
                        coll_bytes=dict(sub.coll_bytes),
                        op_flops=dict(sub.op_flops),
                    )
                    total.add(sub_no_bytes)
                    subc = self.comps.get(m.group(1))
                    if subc is not None:
                        sub_ops = {i.op for i in subc.instrs}
                # fusion-boundary HBM traffic model:
                # * in-place update fusions (fused DUS) touch only the
                #   update payload, not the aliased carry;
                # * fused slice/gather reads touch <= result bytes per
                #   oversized operand;
                # * otherwise: write result once, read operands once.
                operands = []
                for opnd in _OPERANDS_RE.findall(ins.rest.split(")")[0]):
                    _, b = _shape_elems_bytes(comp.shapes.get(opnd, ""))
                    operands.append(b)
                if "dynamic-update-slice" in sub_ops:
                    payload = sum(b for b in operands if b < ins.bytes)
                    total.bytes += 2.0 * payload
                elif sub_ops & {"dynamic-slice", "slice", "gather"}:
                    total.bytes += ins.bytes + sum(
                        min(b, max(ins.bytes, 1)) for b in operands
                    )
                else:
                    total.bytes += ins.bytes + sum(operands)
                continue
            if ins.op == "conditional":
                branches = _OPERANDS_RE.findall(ins.rest)
                costs = [self.computation_cost(b) for b in branches
                         if b in self.comps]
                if costs:
                    total.add(max(costs, key=lambda c: c.flops))
                continue
            if ins.op == "dot":
                f = self._dot_flops(comp, ins)
                total.flops += f
                total.op_flops["dot"] = total.op_flops.get("dot", 0) + f
                operand_bytes = 0
                for opnd in _OPERANDS_RE.findall(ins.rest.split(")")[0]):
                    _, b = _shape_elems_bytes(comp.shapes.get(opnd, ""))
                    operand_bytes += b
                total.bytes += operand_bytes + ins.bytes
                continue
            if ins.op == "convolution":
                # not used by this framework's models; approximate dense
                total.flops += 2.0 * ins.elems
                total.bytes += ins.bytes
                continue
            if ins.op == "dynamic-update-slice":
                ops = _OPERANDS_RE.findall(ins.rest.split(")")[0])
                upd = 0
                if len(ops) >= 2:
                    _, upd = _shape_elems_bytes(comp.shapes.get(ops[1], ""))
                total.bytes += 2.0 * (upd or ins.bytes / 8.0)
                continue
            if ins.op in ("reduce", "reduce-window"):
                total.flops += ins.elems * 4.0  # window/accumulate estimate
                total.op_flops["reduce"] = (
                    total.op_flops.get("reduce", 0) + ins.elems * 4.0)
                total.bytes += ins.bytes
                continue
            if ins.op in ("slice", "dynamic-slice", "gather", "concatenate",
                          "pad", "reverse", "copy", "transpose"):
                total.bytes += 2.0 * ins.bytes  # read + write result-sized
                continue
            if ins.op in ("exponential", "log", "power", "tanh", "logistic",
                          "sine", "cosine", "sqrt", "rsqrt", "divide"):
                total.flops += ins.elems
                total.transcendental += ins.elems
                total.bytes += 2.0 * ins.bytes
                continue
            if ins.op in _FREE_OPS:
                continue
            # generic elementwise (add/multiply/select/compare/...)
            total.flops += ins.elems
            total.bytes += 2.0 * ins.bytes
            total.op_flops["elementwise"] = (
                total.op_flops.get("elementwise", 0) + ins.elems)
        return total

    def entry_cost(self) -> CostTotals:
        # fusions/whiles are walked from the entry; non-entry computations
        # are only counted via their call sites (with trip multipliers).
        return self.computation_cost(self.entry)


def loop_aware_cost(hlo_text: str) -> dict:
    return HloCostModel(hlo_text).entry_cost().as_dict()


def op_class_mix(cost: dict, elem_bytes: float = 8.0) -> dict:
    """Per-class instruction mix from a :func:`loop_aware_cost` dict —
    the ``OpCounts`` kwargs the in-core runtime models consume.

    HLO has no load/store split or integer-op census, so the mix is a
    principled approximation over elements moved (``bytes`` /
    ``elem_bytes``):

    * loads:stores split 2:1 — an elementwise HLO op reads ~two
      operands per result element and writes one;
    * one integer op per element moved stands in for the address/index
      arithmetic the scalar loop nest would carry;
    * transcendentals map to the slow-op (division/SFU) port.
    """
    elems = float(cost["bytes"]) / elem_bytes
    return {
        "int_ops": elems,
        "fp_ops": float(cost["flops"]),
        "div_ops": float(cost["transcendental"]),
        "loads": elems * 2.0 / 3.0,
        "stores": elems / 3.0,
        "total_bytes": float(cost["bytes"]),
    }
