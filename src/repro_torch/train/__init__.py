"""Training on one device: schedules, optimizers, synthetic data and the
train step (port of ``repro/train/``)."""
from repro_torch.train.optimizer import Optimizer, adafactor, adamw
from repro_torch.train.schedule import constant, warmup_cosine
from repro_torch.train.train_step import (
    TrainState, build_train_step, global_norm, init_state,
)

__all__ = [
    "Optimizer", "adamw", "adafactor",
    "TrainState", "build_train_step", "global_norm", "init_state",
    "constant", "warmup_cosine",
]
