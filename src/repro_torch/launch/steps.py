"""Step assembly shared by the trainer: the optimizer an architecture
trains with.  Port of ``repro/launch/steps.py::make_optimizer``; the
reference's sharded cell builders (``build_*_cell``, ``lower_cell``)
belong to the dry-run (ROADMAP A-11c)."""
from __future__ import annotations

from repro_torch.configs.base import ArchSpec
from repro_torch.train.optimizer import Optimizer, adafactor, adamw
from repro_torch.train.schedule import warmup_cosine


def make_optimizer(spec: ArchSpec, total_steps: int = 10000) -> Optimizer:
    sched = warmup_cosine(spec.peak_lr, min(500, total_steps // 10 + 1),
                          total_steps)
    if spec.optimizer_name == "adafactor":
        return adafactor(sched)
    return adamw(sched)
