"""Legacy end-to-end predictor — port of ``repro/core/predictor.py``, a
thin DEPRECATED shim over :class:`repro_torch.api.Session`.

The class predates the unified pipeline: it recomputes reuse profiles
on every ``predict`` call and only speaks CPU targets.  It is kept so
existing scripts keep working — every method routes through the same
stages the Session uses, with artifact caching disabled to keep the
legacy per-call cost model.  New code should run a
:class:`repro_torch.api.PredictionRequest` through a cached ``Session``.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.core.runtime_model import OpCounts
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.hw.targets import CPUTarget


@dataclass
class Prediction:
    target: str
    num_cores: int
    strategy: str
    hit_rates: dict[str, float]        # level name -> predicted P(h)
    t_pred_s: float
    t_mem_s: float
    t_cpu_s: float
    private_profile: ReuseProfile | None = None
    shared_profile: ReuseProfile | None = None


class PPTMulticorePredictor:
    """Deprecated: use ``repro_torch.api.Session`` + ``PredictionRequest``.

    Trace -> profiles -> SDCM hit rates -> Eq. 4-7 runtime; each call
    recomputes its artifacts on ``device`` (``None`` resolves to the
    GPU).
    """

    def __init__(self, target: CPUTarget, *, device=None):
        warnings.warn(
            "PPTMulticorePredictor is deprecated; use repro_torch.api.Session "
            "with a PredictionRequest (docs/api_migration.md)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.api.session import Session

        self.target = target
        self._session = Session(cache=False, device=device)

    def hit_rates(
        self,
        trace: LabeledTrace,
        num_cores: int,
        *,
        strategy: str = "round_robin",
        seed: int = 0,
    ) -> tuple[dict[str, float], ReuseProfile, ReuseProfile]:
        art = self._session.artifacts(
            trace, num_cores, strategy=strategy, seed=seed,
            line_size=self.target.levels[0].line_size,
        )
        rates = self._session.cache_model.hit_rates(self.target, art)
        return rates, art.prd, art.crd

    def predict(
        self,
        trace: LabeledTrace,
        num_cores: int,
        counts: OpCounts,
        *,
        strategy: str = "round_robin",
        mode: str = "throughput",
        gap_bytes: float = 0.0,
        seed: int = 0,
        keep_profiles: bool = False,
    ) -> Prediction:
        from repro_torch.api.request import PredictionRequest

        req = PredictionRequest(
            targets=(self.target,),
            core_counts=(num_cores,),
            strategies=(strategy,),
            modes=(mode,),
            counts=counts,
            seed=seed,
            gap_bytes=gap_bytes,
            keep_profiles=keep_profiles,
            respect_core_limit=False,
        )
        cell = self._session.predict(trace, req).predictions[0]
        return Prediction(
            target=cell.target,
            num_cores=cell.cores,
            strategy=cell.strategy,
            hit_rates=cell.hit_rates,
            t_pred_s=cell.t_pred_s,
            t_mem_s=cell.t_mem_s,
            t_cpu_s=cell.t_cpu_s,
            private_profile=cell.private_profile,
            shared_profile=cell.shared_profile,
        )

    def sweep_cores(
        self,
        trace: LabeledTrace,
        core_counts: list[int],
        counts: OpCounts,
        **kw,
    ) -> list[Prediction]:
        """Predict across core counts from the single trace — the
        paper's scalability claim, one trace collection amortized."""
        return [self.predict(trace, c, counts, **kw) for c in core_counts]

    def ground_truth_hit_rates(
        self,
        trace: LabeledTrace,
        num_cores: int,
        *,
        strategy: str = "round_robin",
        seed: int = 0,
    ) -> dict[str, float]:
        """Exact LRU simulation of the same mimicked traces — the
        paper's PAPI stand-in."""
        return self._session.ground_truth_hit_rates(
            trace, self.target, num_cores, strategy=strategy, seed=seed
        )
