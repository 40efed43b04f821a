"""Runtime pieces of the training loop (port of ``repro/runtime/``):
the straggler monitor.  Checkpointing and elastic re-meshing wait for
ROADMAP A-11c."""
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["StragglerMonitor"]
