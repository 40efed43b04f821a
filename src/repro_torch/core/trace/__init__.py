from repro_torch.core.trace.interleave import interleave_traces
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.core.trace.types import LabeledTrace, trace_from_blocks

__all__ = [
    "interleave_traces",
    "gen_private_traces",
    "LabeledTrace",
    "trace_from_blocks",
]
