"""Declarative grid requests: the whole paper-style sweep in one object
(port of ``repro/api/request.py``).

A :class:`PredictionRequest` names targets x core counts x interleave
strategies x runtime modes; :meth:`cells` enumerates the concrete grid
(dropping core counts a target doesn't have).  The Session executes it
with every intermediate artifact computed exactly once — the paper's
"one trace, every configuration" claim as an API invariant.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from repro_torch.core.runtime_model import OpCounts
from repro_torch.hw.targets import resolve_target


@dataclasses.dataclass(frozen=True)
class GridCell:
    """One concrete point of the request grid."""

    target: object
    cores: int
    strategy: str
    mode: str

    @property
    def key(self) -> tuple:
        return (self.target.name, self.cores, self.strategy, self.mode)


@dataclasses.dataclass(frozen=True)
class PredictionRequest:
    """Declarative spec for a prediction sweep.

    ``targets`` accepts registry names (``"i7-5960X"``, ``"tpu-v5e"``)
    or target objects.  ``counts`` enables the stage-4 runtime model;
    without it the request predicts hit rates only.
    """

    targets: tuple = ()
    core_counts: tuple[int, ...] = (1,)
    strategies: tuple[str, ...] = ("round_robin",)
    modes: tuple[str, ...] = ("throughput",)
    counts: OpCounts | None = None
    # stage-4 model by registry name ("eq" / "ecm" / "roofline");
    # None/"auto" keeps each target's default (repro_torch.api.stages)
    runtime_model: str | None = None
    seed: int = 0
    gap_bytes: float = 0.0
    keep_profiles: bool = False
    # drop grid cells asking for more cores than the target has
    respect_core_limit: bool = True
    # streaming: profile passes in windows of this many references
    # (None -> the Session default; 0 forces the in-memory path)
    window_size: int | None = None
    # SHARDS sampling rate for this request's cells (None -> the
    # Session's mode; core.reuse.sampled)
    sampled_rate: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "targets", tuple(self.targets))
        object.__setattr__(
            self, "core_counts", tuple(int(c) for c in self.core_counts)
        )
        object.__setattr__(self, "strategies", tuple(self.strategies))
        object.__setattr__(self, "modes", tuple(self.modes))
        if not self.targets:
            raise ValueError("PredictionRequest needs at least one target")
        if any(c < 1 for c in self.core_counts):
            raise ValueError("core counts must be >= 1")
        if self.window_size is not None and self.window_size < 0:
            raise ValueError("window_size must be >= 0 (0 = in-memory)")
        if self.sampled_rate is not None:
            rate = float(self.sampled_rate)
            if not (0.0 < rate <= 1.0):
                raise ValueError(
                    f"sampled_rate must be in (0, 1], got {self.sampled_rate!r}"
                )
            object.__setattr__(self, "sampled_rate", rate)
        if self.runtime_model is not None:
            # validate both the name and every target pairing up front —
            # a bad request fails at build time, not mid-grid
            from repro_torch.api.stages import resolve_runtime_model

            for target in self.targets:
                resolve_runtime_model(self.runtime_model, target)

    def resolved_targets(self) -> list:
        return [resolve_target(t) for t in self.targets]

    def cells(self) -> Iterator[GridCell]:
        for target in self.resolved_targets():
            limit = getattr(target, "cores", None)
            for cores in self.core_counts:
                if (
                    self.respect_core_limit
                    and limit is not None
                    and cores > limit
                ):
                    continue
                for strategy in self.strategies:
                    for mode in self.modes:
                        yield GridCell(target, cores, strategy, mode)

    def describe(self) -> str:
        names = [resolve_target(t).name for t in self.targets]
        return (
            f"{len(names)} target(s) {names} x cores {list(self.core_counts)}"
            f" x strategies {list(self.strategies)}"
            f" x modes {list(self.modes)}"
        )
