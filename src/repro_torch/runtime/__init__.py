"""Runtime pieces of the training loop (port of ``repro/runtime/``):
checkpoint/restart on the reference's format, elastic re-meshing and
the straggler monitor."""
from repro_torch.runtime.checkpoint import (
    CheckpointManager, save_checkpoint, restore_checkpoint,
)
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = [
    "CheckpointManager", "save_checkpoint", "restore_checkpoint",
    "plan_remesh", "StragglerMonitor",
]
