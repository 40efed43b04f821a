"""Discrete hardware search space — port of ``repro/explore/space.py``.

A `SearchSpace` names one swept cache level of a base target and the
discrete axes a candidate config can take.  The axis fields ARE the
schema: `SearchSpace.AXES` drives payload validation and the agents'
index-vector encoding, and `to_json` gives the reference's payload, so a
space keys an explore result identically in both packages.

Axes follow the paper's hardware-side knobs (Table 5 geometry plus the
Eq. 4–7 / ECM timing parameters):

* ``sets`` / ``ways`` — geometry of the swept level (capacity =
  sets x ways x line size; associativity = ways).
* ``line_sizes`` — the hierarchy-wide line size.  Reuse profiles are
  line-granular, so this axis changes the profile, not just the model:
  candidates are grouped per line size and each group amortizes one
  profile build.
* ``latency_cy`` / ``beta_cy`` — the swept level's access latency and
  the transfer beta of the boundary feeding it (`core/incore.py`
  convention; the beta axis is inert when sweeping L1 because LSU issue
  cost comes from the per-class port table).
* ``cores`` / ``strategies`` — OpenMP thread count and interleave
  strategy; these select which PRD/CRD profile pair scores the config.

Constraints: ``ways <= sets`` always (a way per set is the textbook
set-associative shape), ``ways <= A_MAX_LIMIT`` (the batched kernel's
lane cap), and optional ``min_size_bytes``/``max_size_bytes`` capacity
bounds on the swept level.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import ClassVar

from repro_torch.api.batched import A_MAX_LIMIT
from repro_torch.core.levels import CacheLevelConfig
from repro_torch.hw.targets import resolve_target

INTERLEAVE_STRATEGIES = ("round_robin", "chunked", "uniform")


@dataclasses.dataclass(frozen=True)
class CandidateConfig:
    """One point of a `SearchSpace` — a concrete hardware config."""

    sets: int
    ways: int
    line_size: int
    latency_cy: float
    beta_cy: float
    cores: int
    strategy: str

    @property
    def size_bytes(self) -> int:
        return self.sets * self.ways * self.line_size

    def key(self) -> tuple:
        return dataclasses.astuple(self)

    def to_json(self) -> dict:
        out = dataclasses.asdict(self)
        out["size_bytes"] = self.size_bytes
        return out

    def levels(self, base, level_idx: int) -> tuple[CacheLevelConfig, ...]:
        """The candidate's cache hierarchy: the swept level takes this
        config's geometry, every level takes its line size."""
        out = []
        for li, lvl in enumerate(base.levels):
            if li == level_idx:
                out.append(CacheLevelConfig(
                    lvl.name, self.size_bytes, self.line_size, self.ways
                ))
            else:
                out.append(CacheLevelConfig(
                    lvl.name, lvl.size_bytes, self.line_size, lvl.assoc
                ))
        return tuple(out)

    def apply(self, base, level_idx: int):
        """A concrete target with this config substituted in — the
        sequential-oracle path (`Session.predict` on the result must
        score the config identically to the fused sweep)."""
        lats = list(base.level_latency_cy)
        lats[level_idx] = self.latency_cy
        betas = list(base.level_beta_cy)
        betas[level_idx] = self.beta_cy
        slug = (f"{self.sets}s{self.ways}w{self.line_size}b"
                f"{self.latency_cy:g}d{self.beta_cy:g}t")
        return dataclasses.replace(
            base,
            name=f"{base.name}~{base.levels[level_idx].name}={slug}",
            levels=self.levels(base, level_idx),
            level_latency_cy=tuple(lats),
            level_beta_cy=tuple(betas),
        )


def _tuple(values, cast) -> tuple:
    return tuple(cast(v) for v in values)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Discrete axes + constraints over one swept level of a target."""

    AXES: ClassVar[tuple[str, ...]] = (
        "sets", "ways", "line_sizes", "latency_cy", "beta_cy",
        "cores", "strategies",
    )

    target: str = "i7-5960X"
    level: str = "L3"
    sets: tuple[int, ...] = (1024, 4096, 16384)
    ways: tuple[int, ...] = (4, 8, 16)
    line_sizes: tuple[int, ...] = (64,)
    latency_cy: tuple[float, ...] = ()   # () -> base target's value
    beta_cy: tuple[float, ...] = ()      # () -> base target's value
    cores: tuple[int, ...] = (1,)
    strategies: tuple[str, ...] = ("round_robin",)
    min_size_bytes: int | None = None
    max_size_bytes: int | None = None

    def __post_init__(self):
        base = resolve_target(self.target)  # raises on unknown target
        li = self.level_index(base)
        object.__setattr__(self, "sets", _tuple(self.sets, int))
        object.__setattr__(self, "ways", _tuple(self.ways, int))
        object.__setattr__(self, "line_sizes", _tuple(self.line_sizes, int))
        object.__setattr__(
            self, "latency_cy",
            _tuple(self.latency_cy, float)
            or (float(base.level_latency_cy[li]),),
        )
        object.__setattr__(
            self, "beta_cy",
            _tuple(self.beta_cy, float) or (float(base.level_beta_cy[li]),),
        )
        object.__setattr__(self, "cores", _tuple(self.cores, int))
        object.__setattr__(self, "strategies", _tuple(self.strategies, str))
        self._validate(base)

    def _validate(self, base) -> None:
        for name in self.AXES:
            if not getattr(self, name):
                raise ValueError(f"search-space axis {name!r} is empty")
        for name in ("sets", "ways", "line_sizes", "cores"):
            bad = [v for v in getattr(self, name) if v < 1]
            if bad:
                raise ValueError(f"axis {name!r} has non-positive {bad}")
        if any(w > A_MAX_LIMIT for w in self.ways):
            raise ValueError(
                f"ways axis exceeds the batched kernel's "
                f"A_MAX={A_MAX_LIMIT}: {self.ways}"
            )
        for s in self.strategies:
            if s not in INTERLEAVE_STRATEGIES:
                raise ValueError(
                    f"unknown interleave strategy {s!r} "
                    f"(known: {INTERLEAVE_STRATEGIES})"
                )
        if any(c > base.cores for c in self.cores):
            raise ValueError(
                f"cores axis exceeds target {base.name!r}'s "
                f"{base.cores} cores: {self.cores}"
            )
        if not self.configs():
            raise ValueError(
                "search space has no valid configs (constraints "
                "eliminated every axis combination)"
            )

    # --- structure -----------------------------------------------------------

    def level_index(self, base=None) -> int:
        base = base if base is not None else resolve_target(self.target)
        for li, lvl in enumerate(base.levels):
            if lvl.name == self.level:
                return li
        raise ValueError(
            f"target {base.name!r} has no level {self.level!r} "
            f"(levels: {[lvl.name for lvl in base.levels]})"
        )

    def axes(self) -> dict[str, tuple]:
        return {name: getattr(self, name) for name in self.AXES}

    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(len(v) for v in self.axes().values())

    @property
    def raw_size(self) -> int:
        n = 1
        for s in self.axis_sizes():
            n *= s
        return n

    def config_from_indices(self, idx) -> CandidateConfig | None:
        """The config at one index vector, or None where constraints
        reject it.  ``cores == 1`` canonicalizes the strategy axis (a
        single core has nothing to interleave), so distinct index
        vectors may alias one config — agents dedup on `key()`."""
        vals = {
            name: axis[i]
            for (name, axis), i in zip(self.axes().items(), idx)
        }
        sets, ways = vals["sets"], vals["ways"]
        if ways > sets:
            return None
        size = sets * ways * vals["line_sizes"]
        if self.min_size_bytes is not None and size < self.min_size_bytes:
            return None
        if self.max_size_bytes is not None and size > self.max_size_bytes:
            return None
        cores = vals["cores"]
        strategy = vals["strategies"] if cores > 1 else self.strategies[0]
        return CandidateConfig(
            sets=sets, ways=ways, line_size=vals["line_sizes"],
            latency_cy=vals["latency_cy"], beta_cy=vals["beta_cy"],
            cores=cores, strategy=strategy,
        )

    def configs(self) -> list[CandidateConfig]:
        """Every valid config, deterministic order, aliases deduped."""
        seen: set[tuple] = set()
        out: list[CandidateConfig] = []
        for idx in itertools.product(
            *(range(n) for n in self.axis_sizes())
        ):
            cfg = self.config_from_indices(idx)
            if cfg is None or cfg.key() in seen:
                continue
            seen.add(cfg.key())
            out.append(cfg)
        return out

    @property
    def size(self) -> int:
        return len(self.configs())

    # --- (de)serialization ---------------------------------------------------

    def to_json(self) -> dict:
        out = {"target": self.target, "level": self.level}
        out.update({k: list(v) for k, v in self.axes().items()})
        if self.min_size_bytes is not None:
            out["min_size_bytes"] = self.min_size_bytes
        if self.max_size_bytes is not None:
            out["max_size_bytes"] = self.max_size_bytes
        return out

    @classmethod
    def from_json(cls, payload: dict) -> "SearchSpace":
        if not isinstance(payload, dict):
            raise ValueError("search space payload must be an object")
        known = set(cls.AXES) | {
            "target", "level", "min_size_bytes", "max_size_bytes",
        }
        unknown = sorted(set(payload) - known)
        if unknown:
            raise ValueError(
                f"unknown search-space keys {unknown} "
                f"(known: {sorted(known)})"
            )
        return cls(**payload)


__all__ = [
    "INTERLEAVE_STRATEGIES",
    "CandidateConfig",
    "SearchSpace",
]
