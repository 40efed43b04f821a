from repro_torch.core.trace.interleave import (
    interleave_traces,
    interleave_windows,
)
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.core.trace.types import (
    ChunkedTraceSource,
    LabeledTrace,
    rebatch_windows,
    trace_from_blocks,
)

__all__ = [
    "ChunkedTraceSource",
    "interleave_traces",
    "interleave_windows",
    "gen_private_traces",
    "LabeledTrace",
    "rebatch_windows",
    "trace_from_blocks",
]
