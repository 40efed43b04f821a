"""HLO-text analysis: collective traffic extraction — port of
``repro/analysis/hlo.py`` (``re`` only, the same outputs on the same text).

``compiled.as_text()`` is the post-SPMD, per-partition module, so every
shape below is a per-device shard and the byte counts are per-chip —
exactly the quantity the roofline collective term wants.

Traffic model (ring algorithms, bytes crossing a chip's links):
    all-reduce        2·(n-1)/n · result_bytes
    all-gather          (n-1)/n · result_bytes   (result = gathered size)
    reduce-scatter      (n-1)   · result_bytes   (operand = n · result)
    all-to-all          (n-1)/n · result_bytes
    collective-permute            result_bytes
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_LIST_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9, ]*)\}")
_OP_RE = re.compile(
    r"=\s+(\(?[a-z0-9]+\[[^=]*?)\s+(" + "|".join(_COLLECTIVES) + r")(-start)?\("
)


def _shape_bytes(text: str) -> list[int]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        out.append(n * _DTYPE_BYTES[dtype])
    return out


def _group_size(line: str, num_partitions: int) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        return int(m.group(2))
    m = _LIST_GROUPS_RE.search(line)
    if m:
        ids = [t for t in m.group(1).split(",") if t.strip()]
        return max(len(ids), 1)
    return num_partitions


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)       # op -> #instances
    result_bytes: dict = field(default_factory=dict)  # op -> Σ result bytes
    ici_bytes: float = 0.0                            # per-chip traffic model

    def as_dict(self) -> dict:
        return {
            "counts": dict(self.counts),
            "result_bytes": {k: int(v) for k, v in self.result_bytes.items()},
            "ici_bytes": int(self.ici_bytes),
        }


def _traffic(op: str, result_bytes: float, n: int) -> float:
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * result_bytes
    if op == "all-gather":
        return (n - 1) / n * result_bytes
    if op == "reduce-scatter":
        return (n - 1) * result_bytes
    if op == "all-to-all":
        return (n - 1) / n * result_bytes
    return result_bytes  # collective-permute


def num_partitions(hlo_text: str) -> int:
    m = re.search(r"num_partitions=(\d+)", hlo_text)
    return int(m.group(1)) if m else 1


def collective_stats(hlo_text: str) -> CollectiveStats:
    parts = num_partitions(hlo_text)
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        shapes_txt, op, started = m.group(1), m.group(2), m.group(3)
        sizes = _shape_bytes(shapes_txt)
        if not sizes:
            continue
        # async -start ops return (operand, result) tuples for
        # all-gather/permute — take the output (largest); all-reduce
        # tuples are independent reductions — sum them.
        rb = sum(sizes) if op == "all-reduce" else (
            max(sizes) if started else sum(sizes)
        )
        n = _group_size(line, parts)
        stats.counts[op] = stats.counts.get(op, 0) + 1
        stats.result_bytes[op] = stats.result_bytes.get(op, 0) + rb
        stats.ici_bytes += _traffic(op, rb, n)
    return stats


def collective_summary(hlo_text: str) -> dict:
    return collective_stats(hlo_text).as_dict()


def op_histogram(hlo_text: str) -> dict[str, int]:
    """Instruction-name histogram — remat/redundancy forensics for the
    perf loop (duplicate dot shapes betray recompute)."""
    hist: dict[str, int] = {}
    for m in re.finditer(r"=\s+\(?[a-z0-9]+\[[^ ]*\]?[^ ]* ([a-z][a-z0-9-]*)\(",
                         hlo_text):
        op = m.group(1)
        hist[op] = hist.get(op, 0) + 1
    return hist
