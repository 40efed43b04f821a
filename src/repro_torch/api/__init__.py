"""repro_torch.api — the prediction pipeline on PyTorch (port of
``repro.api``).

    from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session

    session = Session(cache_model=AnalyticalSDCM(backend="batched"))
    request = PredictionRequest(
        targets=("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P"),
        core_counts=(1, 2, 4, 8),
        counts=workload.op_counts,
    )
    result = session.predict(workload, request)
    print(result.to_table())

``Session()`` runs on the GPU and raises without one; pass
``device="cpu"`` to run on the host.  ``Session(window_size=W)``
builds the profiles window by window (bit-identical, the interleaved
trace never materialized); ``Session(binned=True)`` builds log2-binned
profiles through the reuse-histogram kernel; ``Session(sampled=R)``
SHARDS-sampled profiles with their declared error bound.
``session.ground_truth_hit_rates(workload, target, cores)`` (or
``Session(cache_model=ExactLRU())``) runs the exact-LRU simulator on
the Session's device.  Registry names (``"polybench/atx"``, ``"atx"``)
are trace sources too.
"""
from repro_torch.api.request import GridCell, PredictionRequest
from repro_torch.api.results import CellPrediction, PredictionSet
from repro_torch.api.session import Session, SessionStats
from repro_torch.core.trace.types import ChunkedTraceSource
from repro_torch.api.stages import (
    AnalyticalSDCM,
    ArrayTraceSource,
    CacheModel,
    ECMRuntimeModel,
    EqRuntimeModel,
    ExactLRU,
    MimicProfileBuilder,
    ProfileArtifacts,
    ProfileBuilder,
    RUNTIME_MODELS,
    RooflineRuntimeModel,
    RuntimeModel,
    Target,
    TraceSource,
    resolve_runtime_model,
    supported_runtime_models,
    trace_content_id,
)

__all__ = [
    "AnalyticalSDCM",
    "ArrayTraceSource",
    "CacheModel",
    "ChunkedTraceSource",
    "CellPrediction",
    "ECMRuntimeModel",
    "EqRuntimeModel",
    "ExactLRU",
    "GridCell",
    "MimicProfileBuilder",
    "PredictionRequest",
    "PredictionSet",
    "ProfileArtifacts",
    "ProfileBuilder",
    "RUNTIME_MODELS",
    "RooflineRuntimeModel",
    "RuntimeModel",
    "Session",
    "SessionStats",
    "Target",
    "TraceSource",
    "resolve_runtime_model",
    "supported_runtime_models",
    "trace_content_id",
]
