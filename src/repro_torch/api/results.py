"""Structured sweep results: filterable, tabulable, serializable (port
of ``repro/api/results.py``)."""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator

from repro_torch.core.reuse.profile import ReuseProfile


@dataclasses.dataclass
class CellPrediction:
    """Prediction for one grid cell (hit rates always; runtime when the
    request carried op counts)."""

    target: str
    cores: int
    strategy: str
    mode: str
    hit_rates: dict[str, float]
    t_pred_s: float | None = None
    t_mem_s: float | None = None
    t_cpu_s: float | None = None
    # which stage-4 model produced the runtime fields ("eq"/"ecm"/...)
    runtime_model: str | None = None
    private_profile: ReuseProfile | None = None
    shared_profile: ReuseProfile | None = None

    def to_record(self) -> dict:
        rec = {
            "target": self.target,
            "cores": self.cores,
            "strategy": self.strategy,
            "mode": self.mode,
            "hit_rates": dict(self.hit_rates),
        }
        if self.t_pred_s is not None:
            rec.update(
                t_pred_s=self.t_pred_s,
                t_mem_s=self.t_mem_s,
                t_cpu_s=self.t_cpu_s,
                runtime_model=self.runtime_model,
            )
        return rec


@dataclasses.dataclass
class PredictionSet:
    """The executed grid: an ordered collection of cell predictions."""

    predictions: list[CellPrediction]
    cache_model: str = "sdcm"
    trace_id: str = ""

    def __iter__(self) -> Iterator[CellPrediction]:
        return iter(self.predictions)

    def __len__(self) -> int:
        return len(self.predictions)

    def select(self, *, target: str | None = None, cores: int | None = None,
               strategy: str | None = None, mode: str | None = None
               ) -> "PredictionSet":
        """Filter by any subset of grid coordinates."""
        keep = [
            p for p in self.predictions
            if (target is None or p.target == target)
            and (cores is None or p.cores == cores)
            and (strategy is None or p.strategy == strategy)
            and (mode is None or p.mode == mode)
        ]
        return PredictionSet(keep, self.cache_model, self.trace_id)

    def one(self, **kw) -> CellPrediction:
        sel = self.select(**kw).predictions
        if len(sel) != 1:
            raise LookupError(f"expected exactly one cell for {kw}, "
                              f"got {len(sel)}")
        return sel[0]

    def to_records(self) -> list[dict]:
        return [p.to_record() for p in self.predictions]

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(
            {
                "cache_model": self.cache_model,
                "trace_id": self.trace_id,
                "predictions": self.to_records(),
            },
            indent=indent,
            default=float,
        )

    def to_table(self) -> str:
        """Fixed-width benchmark table, one row per grid cell."""
        level_names: list[str] = []
        for p in self.predictions:
            for name in p.hit_rates:
                if name not in level_names:
                    level_names.append(name)
        has_runtime = any(p.t_pred_s is not None for p in self.predictions)
        headers = ["target", "cores", "strategy"]
        if len({p.mode for p in self.predictions}) > 1:
            headers.append("mode")
        headers += [f"P(h) {n}" for n in level_names]
        if has_runtime:
            headers += ["T_pred", "T_mem", "T_cpu"]
        rows = []
        for p in self.predictions:
            row = [p.target, p.cores, p.strategy]
            if "mode" in headers:
                row.append(p.mode)
            row += [
                f"{p.hit_rates[n]:.4f}" if n in p.hit_rates else "-"
                for n in level_names
            ]
            if has_runtime:
                row += [
                    f"{v:.3e}" if v is not None else "-"
                    for v in (p.t_pred_s, p.t_mem_s, p.t_cpu_s)
                ]
            rows.append(row)
        widths = [
            max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
            for i, h in enumerate(headers)
        ]

        def line(cells):
            return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths))

        out = [line(headers), line(["-" * w for w in widths])]
        out.extend(line(r) for r in rows)
        return "\n".join(out)
