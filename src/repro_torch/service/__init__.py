"""repro_torch.service — concurrent prediction service with request
coalescing (port of ``repro.service``).

    from repro_torch.service import PredictionService, ServiceConfig
    from repro_torch.api import PredictionRequest

    with PredictionService(artifact_dir=".cache/artifacts") as svc:
        fut = svc.submit(workload, PredictionRequest(
            targets=("i7-5960X",), core_counts=(1, 4, 8),
        ))
        resp = fut.result()
        print(resp.result.to_table(), resp.timing.batch_size)

Many threads (or HTTP clients — ``python -m repro_torch.service``)
submit independent :class:`repro_torch.api.PredictionRequest`\\ s; a
microbatching scheduler dedups identical requests, coalesces compatible
ones, and evaluates each batch through ONE ``Session.predict_many`` call
(one launch of the ragged SDCM kernel on the card).  A shared
``Session(artifact_dir=...)`` means a warm disk store serves reuse
profiles with zero rebuilds across service processes.  The service runs
on the card unless ``ServiceConfig(device="cpu")`` is given.
"""
from repro_torch.service.scheduler import (
    Computation,
    MicroBatcher,
    PendingRequest,
    coalesce,
    default_key,
    resolve_future,
)
from repro_torch.service.service import (
    PredictionService,
    RequestTiming,
    ServiceConfig,
    ServiceOverloadedError,
    ServiceResponse,
    ServiceStats,
)

__all__ = [
    "Computation",
    "MicroBatcher",
    "PendingRequest",
    "PredictionService",
    "RequestTiming",
    "ServiceConfig",
    "ServiceOverloadedError",
    "ServiceResponse",
    "ServiceStats",
    "coalesce",
    "default_key",
    "resolve_future",
]
