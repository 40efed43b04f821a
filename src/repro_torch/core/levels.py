"""Leaf module: cache-geometry dataclasses shared by every layer.

Port of ``repro/core/levels.py``.  Depends on nothing inside the
package — ``hw.targets`` (hardware specs) and ``api`` (the prediction
pipeline) import from here, so no import cycle can form around the
geometry types.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CacheLevelConfig:
    name: str
    size_bytes: int
    line_size: int
    assoc: int  # ways; >= num_lines means fully associative

    @property
    def num_lines(self) -> int:
        return max(1, self.size_bytes // self.line_size)

    @property
    def effective_assoc(self) -> int:
        return min(self.assoc, self.num_lines)

    @property
    def num_sets(self) -> int:
        return max(1, self.num_lines // self.effective_assoc)


@dataclass(frozen=True)
class LevelResult:
    name: str
    accesses: int          # references reaching this level
    hits: int              # hits at this level
    cumulative_hit_rate: float  # 1 - misses_here / total_trace_accesses
