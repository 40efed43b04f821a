"""Fused fitness evaluation for config search — port of
``repro/explore/engine.py``.

One `FusedSweepEvaluator` owns a `Session` plus device-resident packed
reuse profiles and scores arbitrary batches of `CandidateConfig`s
through `repro_torch.api.batched.sweep_grid`: candidates are grouped by
the axes that change the *profile* (line size, cores, interleave
strategy) and everything else — geometry, latencies, betas — rides as
float64 arrays staged once per group, so each group of an agent round is
one SDCM launch (``inner="vmap"``) however many configs it proposes.

Scores are "smaller is better":

* ``runtime``  — ECM-predicted seconds (needs `OpCounts`), chained on
  the device from the rates of the same sweep.
* ``llc_miss`` — the swept hierarchy's last-level miss fraction
  ``1 - P(hit at LLC)`` (cumulative convention), for workloads without
  operation counts.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api import batched
from repro_torch.api.session import Session
from repro_torch.api.stages import shared_level_index
from repro_torch.core.incore import timings_of
from repro_torch.hw.targets import resolve_target

from .space import CandidateConfig, SearchSpace

OBJECTIVES = ("runtime", "llc_miss")


@dataclasses.dataclass
class SweepStats:
    """What the evaluator actually did (the reference's fields, so an
    explore result has the reference's schema)."""

    sweeps: int = 0               # evaluate() calls
    configs_scored: int = 0       # rows evaluated (incl. re-proposals)
    fused_dispatches: int = 0     # SDCM kernel calls issued
    kernel_compiles: int = 0      # NEW launch shapes recorded
    profile_groups: int = 0       # distinct (line, cores, strategy) packs

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class EvalResult:
    scores: np.ndarray            # [C] smaller is better
    rates: np.ndarray             # [C, L] per-level cumulative hit rates
    t_pred_s: np.ndarray | None   # [C] ECM runtime (None for llc_miss)


class FusedSweepEvaluator:
    """Score candidate configs for one workload via the fused sweep.

    ``session`` defaults to ``Session(cache_model="batched",
    device=device)``: the card unless ``device="cpu"`` is asked for.
    The profile packs live on the session's device.
    """

    def __init__(self, source, space: SearchSpace, *, session=None,
                 device=None, counts=None, mode: str = "throughput",
                 objective: str | None = None, inner: str = "vmap",
                 seed: int = 0, window_size: int | None = None,
                 sampled: float | None = None):
        self.session = session if session is not None else Session(
            cache_model="batched", device=device
        )
        self.source = source
        self.space = space
        self.base = resolve_target(space.target)
        self.level_idx = space.level_index(self.base)
        self.shared_idx = shared_level_index(self.base)
        self.mode = mode
        self.inner = inner
        self.seed = seed
        self.window_size = window_size
        self.sampled = sampled
        self.counts = (counts if counts is not None
                       else getattr(source, "op_counts", None))
        if objective is None:
            objective = "runtime" if self.counts is not None else "llc_miss"
        if objective not in OBJECTIVES:
            raise ValueError(
                f"unknown objective {objective!r} (known: {OBJECTIVES})"
            )
        if objective == "runtime" and self.counts is None:
            raise ValueError(
                "objective 'runtime' needs op counts; this source has "
                "none — pass counts= or use objective='llc_miss'"
            )
        self.objective = objective
        self.timings = (timings_of(self.base)
                        if objective == "runtime" else None)
        self.stats = SweepStats()
        # (line_size, cores, strategy) -> (prd DeviceProfile, crd ...)
        self._packs: dict[tuple, tuple] = {}

    # --- profile packs -------------------------------------------------------

    def _pack(self, line_size: int, cores: int, strategy: str):
        key = (line_size, cores, strategy)
        hit = self._packs.get(key)
        if hit is not None:
            return hit
        art = self.session.artifacts(
            self.source, cores, strategy=strategy, seed=self.seed,
            line_size=line_size, window_size=self.window_size,
            sampled=self.sampled,
        )
        dev = self.session.device
        prd = batched.pack_profile_device(art.prd, device=dev)
        crd = (prd if art.crd is art.prd
               else batched.pack_profile_device(art.crd, device=dev))
        self._packs[key] = (prd, crd)
        self.stats.profile_groups += 1
        return prd, crd

    # --- geometry staging ----------------------------------------------------

    def _geometry(self, configs: list[CandidateConfig],
                  line_size: int, cores: int) -> batched.SweepGeometry:
        """The configs' hierarchies as ``[C, L]`` float64 axes: exactly
        the ``effective_assoc``/``num_lines`` of ``cfg.apply(base, li)``,
        and its latencies and transfer betas."""
        base, li = self.base, self.level_idx
        c = len(configs)
        n_levels = len(base.levels)
        assoc = np.zeros((c, n_levels))
        blocks = np.zeros((c, n_levels))
        delta = np.zeros((c, n_levels))
        tbeta = np.zeros((c, n_levels))
        # non-swept columns depend only on the (fixed) group line size
        for lv, lvl in enumerate(base.levels):
            if lv == li:
                continue
            lines = max(lvl.size_bytes // line_size, 1)
            assoc[:, lv] = min(lvl.assoc, lines)
            blocks[:, lv] = lines
            delta[:, lv] = base.level_latency_cy[lv]
        # transfer beta of boundary i is the port INTO level i+1
        # (RAM for the last boundary) — `core/incore.py` convention
        for bi in range(n_levels):
            if bi == n_levels - 1:
                tbeta[:, bi] = base.ram_beta_cy
            else:
                tbeta[:, bi] = base.level_beta_cy[bi + 1]
        assoc[:, li] = [cfg.ways for cfg in configs]
        blocks[:, li] = [cfg.sets * cfg.ways for cfg in configs]
        delta[:, li] = [cfg.latency_cy for cfg in configs]
        if li >= 1:
            tbeta[:, li - 1] = [cfg.beta_cy for cfg in configs]
        return batched.SweepGeometry(
            assoc=assoc, blocks=blocks, trans_beta=tbeta, delta=delta,
            cores=np.full(c, float(cores)),
        )

    # --- evaluation ----------------------------------------------------------

    def evaluate(self, configs: list[CandidateConfig]) -> EvalResult:
        """Score a batch; results are order-aligned with ``configs``."""
        c = len(configs)
        n_levels = len(self.base.levels)
        rates = np.zeros((c, n_levels), np.float64)
        with_runtime = self.objective == "runtime"
        t_pred = np.zeros(c, np.float64) if with_runtime else None

        groups: dict[tuple, list[int]] = {}
        for ci, cfg in enumerate(configs):
            groups.setdefault(
                (cfg.line_size, cfg.cores, cfg.strategy), []
            ).append(ci)

        for (line, cores, strategy), idxs in groups.items():
            prd, crd = self._pack(line, cores, strategy)
            geom = self._geometry(
                [configs[i] for i in idxs], line, cores
            )
            res = batched.sweep_grid(
                prd, crd, geom,
                shared_idx=self.shared_idx,
                counts=self.counts if with_runtime else None,
                timings=self.timings,
                cycle_s=self.base.cycle_s,
                ram_delta=self.base.ram_latency_cy,
                mode=self.mode,
                inner=self.inner,
            )
            sel = np.asarray(idxs)
            rates[sel] = res.rates
            if with_runtime:
                t_pred[sel] = res.t_pred_s
            self.stats.fused_dispatches += res.dispatches
            self.stats.kernel_compiles += res.compiles
            self.session.stats.kernel_shapes += res.compiles

        self.stats.sweeps += 1
        self.stats.configs_scored += c
        scores = t_pred.copy() if with_runtime else 1.0 - rates[:, -1]
        return EvalResult(scores=scores, rates=rates, t_pred_s=t_pred)

    def scores(self, configs: list[CandidateConfig]) -> np.ndarray:
        return self.evaluate(configs).scores


__all__ = ["OBJECTIVES", "EvalResult", "FusedSweepEvaluator", "SweepStats"]
