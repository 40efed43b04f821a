"""Learning-rate schedules: ``step`` (an integer tensor) -> lr (an f32
tensor).  Port of ``repro/train/schedule.py``."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    def sched(step):
        step = step.float()
        warm = peak_lr * (step + 1.0) / max(warmup_steps, 1)
        frac = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1),
            0.0, 1.0)
        cos = final_fraction + (1 - final_fraction) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return sched
