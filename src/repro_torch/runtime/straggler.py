"""Deadline-based straggler mitigation, with PPT-predicted deadlines.

The paper's headline property — predict runtime for any configuration
*before running it* — is exactly what a straggler detector needs: an
expected step time that doesn't come from warm-up statistics.  The
monitor accepts the roofline/PPT step-time bound as its prior deadline
and tightens it with observed medians as steps accumulate.

Pure logic + injectable clock: unit-testable, and the decision layer a
real cluster agent would call between steps.  Port of
``repro/runtime/straggler.py``, unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass
class WorkerView:
    worker: int
    last_step: int
    last_heartbeat_s: float


@dataclasses.dataclass
class StragglerDecision:
    stragglers: list[int]
    failed: list[int]
    deadline_s: float


class StragglerMonitor:
    """Track per-worker step heartbeats against a deadline.

    deadline = max(predicted_step_s * slack, observed_median * slack)
    — the PPT prediction bootstraps detection from step 0 (no warm-up
    blindness); workers past ``fail_factor`` x deadline are failed.
    """

    def __init__(self, num_workers: int, predicted_step_s: float,
                 slack: float = 3.0, fail_factor: float = 5.0,
                 clock: Callable[[], float] | None = None):
        if predicted_step_s <= 0:
            raise ValueError("predicted_step_s must be positive")
        self.num_workers = num_workers
        self.predicted_step_s = predicted_step_s
        self.slack = slack
        self.fail_factor = fail_factor
        self.clock = clock or __import__("time").monotonic
        now = self.clock()
        self.views = {
            w: WorkerView(w, -1, now) for w in range(num_workers)
        }
        self.durations: list[float] = []

    def heartbeat(self, worker: int, step: int) -> None:
        now = self.clock()
        view = self.views[worker]
        if step > view.last_step and view.last_step >= 0:
            self.durations.append(now - view.last_heartbeat_s)
            if len(self.durations) > 512:
                del self.durations[: -512]
        view.last_step = step
        view.last_heartbeat_s = now

    def deadline_s(self) -> float:
        base = self.predicted_step_s
        if len(self.durations) >= 8:
            med = sorted(self.durations)[len(self.durations) // 2]
            base = max(base, med)
        return base * self.slack

    def check(self) -> StragglerDecision:
        now = self.clock()
        deadline = self.deadline_s()
        stragglers, failed = [], []
        for view in self.views.values():
            idle = now - view.last_heartbeat_s
            if idle > deadline * self.fail_factor / self.slack:
                failed.append(view.worker)
            elif idle > deadline:
                stragglers.append(view.worker)
        return StragglerDecision(sorted(stragglers), sorted(failed), deadline)

    def remove(self, worker: int) -> None:
        self.views.pop(worker, None)
        self.num_workers = len(self.views)
