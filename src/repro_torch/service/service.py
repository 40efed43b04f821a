"""PredictionService: concurrent prediction over one shared Session (port
of ``repro/service/service.py``).

The paper's asymmetry — profiles are collected once, every what-if
query afterwards is cheap analytical math — makes prediction a natural
high-QPS service.  This module composes two halves of the port:

* the batched SDCM path (``repro_torch.api.batched``), reached through
  ``Session.predict_many``: on the card N coalesced requests cost ONE
  launch of kernel B1's ragged form (``sdcm_rates_ragged``), whatever
  the batch holds — the ragged kernel is composition-invariant, so a
  request's bits do not depend on its batch-mates;
* the disk :class:`repro_torch.validate.store.ArtifactStore`
  (``artifact_dir=...``), so a warm store means zero reuse-profile
  rebuilds across service processes.

Concurrency model: submitters enqueue onto a bounded queue; a single
worker thread owns the Session and turns queue depth into batch size
(:mod:`repro_torch.service.scheduler`).  Backpressure is load-shedding —
a full queue raises :class:`ServiceOverloadedError` at ``submit`` time
instead of letting latency grow without bound.

Device and streams: the Session runs on ``ServiceConfig.device`` (the
card unless ``"cpu"`` is asked for).  The predict worker launches on its
thread's current stream.  Each ``/explore`` job builds a private
Session on the same device and over the same artifact dir, and runs its
sweeps on a CUDA stream of its own, so a long sweep does not queue
behind predict batches on the device either.  That is safe for every
kernel on the path: kernel B2 keeps its integer accumulator per
(device, stream), and launch counts are taken under a lock
(``repro_torch.kernels.count_launch``).

Failure modes:

* queue full            -> ``ServiceOverloadedError`` (``stats.shed``)
* bad request           -> ``ValueError`` at submit (before queueing)
* one computation fails -> the batch group retries each computation
  individually, so only the poisoned request's waiters see the error
* service stopped       -> ``RuntimeError`` on submit
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import ClassVar

import torch

from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
from repro_torch.api.results import PredictionSet
from repro_torch.device import resolve_device
from repro_torch.service.scheduler import (
    BoundedWorkerPool,
    MicroBatcher,
    PendingRequest,
    coalesce,
    default_key,
    resolve_future,
)

SHED_MESSAGE = (
    "prediction service queue is full ({depth} pending, limit {limit}); "
    "request shed — retry with backoff or raise ServiceConfig.queue_size"
)
NOT_RUNNING = ("PredictionService is not running "
               "(use `with service:` or call start())")


class ServiceOverloadedError(RuntimeError):
    """Raised by ``submit`` when the bounded queue is full (load shed)."""


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Tuning knobs (the reference's), plus the device."""

    max_batch: int = 64         # batch budget: flush when this many gathered
    max_wait_ms: float = 5.0    # flush window past the first item
    queue_size: int = 256       # bounded queue; beyond this, shed
    artifact_dir: str | None = None  # shared disk store (optional)
    # the /explore lane: long-running sweeps run on their own bounded
    # pool so a search can never starve /predict microbatches
    explore_workers: int = 1    # concurrent explore jobs
    explore_pending: int = 2    # queued explore jobs beyond that; then shed
    explore_budget_cap: int = 4096  # max unique configs per explore request
    device: object = None       # None: the card (repro_torch.device)

    @property
    def max_wait_s(self) -> float:
        return self.max_wait_ms / 1000.0


@dataclasses.dataclass
class ServiceStats:
    """Observable service behaviour (asserted by tests/benchmarks).

    Batch sizes are kept as running aggregates plus a bounded recent
    window (a long-running service must not accumulate per-batch
    history without limit); dedup shows up as ``coalesced <
    batched_requests``.  Store/profile counters live on the underlying
    ``Session.stats`` — ``snapshot()`` merges both.
    """

    RECENT_WINDOW: ClassVar[int] = 64

    submitted: int = 0          # accepted into the queue
    completed: int = 0          # futures resolved with a result
    failed: int = 0             # futures resolved with an exception
    cancelled: int = 0          # futures the caller cancelled while queued
    shed: int = 0               # rejected with ServiceOverloadedError
    batches: int = 0            # coalesced batches processed
    batched_requests: int = 0   # sum of batch sizes
    coalesced: int = 0          # unique computations actually evaluated
    deduped: int = 0            # requests served by another's computation
    kernel_calls: int = 0       # predict_many invocations (+ retries)
    queue_wait_s: float = 0.0   # summed per-request queue wait
    service_s: float = 0.0      # summed per-request in-batch service time
    max_batch_size: int = 0
    recent_batch_sizes: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=ServiceStats.RECENT_WINDOW)
    )

    @property
    def mean_batch_size(self) -> float:
        return self.batched_requests / max(self.batches, 1)

    def record_batch(self, size: int) -> None:
        self.batches += 1
        self.batched_requests += size
        self.max_batch_size = max(self.max_batch_size, size)
        self.recent_batch_sizes.append(size)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["recent_batch_sizes"] = list(self.recent_batch_sizes)
        out["mean_batch_size"] = self.mean_batch_size
        return out


@dataclasses.dataclass(frozen=True)
class RequestTiming:
    """Per-request observability returned alongside every result."""

    queue_wait_s: float         # submit -> batch formation
    service_s: float            # batch formation -> result ready
    batch_size: int             # requests in the coalesced batch
    group_size: int             # unique computations evaluated together
    shared: bool                # served by a deduped computation (>1 waiter)


@dataclasses.dataclass
class ServiceResponse:
    """What a resolved future carries: the grid result + timing."""

    result: PredictionSet
    timing: RequestTiming


class PredictionService:
    """Microbatching front-end over one Session (see module docstring).

    >>> with PredictionService(artifact_dir=".cache/artifacts") as svc:
    ...     resp = svc.predict(workload, request)
    ...     print(resp.result.to_table(), resp.timing.batch_size)

    Thread-safe: any number of threads may ``submit``/``predict``
    concurrently; the Session is only ever touched by the worker.
    A ``session`` passed in brings its own device; otherwise the
    Session is built on ``config.device``.
    """

    def __init__(self, session: Session | None = None, *,
                 config: ServiceConfig | None = None,
                 artifact_dir: str | None = None):
        self.config = config or ServiceConfig()
        if artifact_dir is None:
            artifact_dir = self.config.artifact_dir
        if session is None:
            # batched backend: the whole coalesced batch is one launch
            session = Session(
                cache_model=AnalyticalSDCM(backend="batched"),
                device=resolve_device(self.config.device),
                artifact_dir=artifact_dir,
            )
        self.session = session
        self.device = session.device
        self._artifact_dir = artifact_dir
        self.stats = ServiceStats()
        self._stats_lock = threading.Lock()
        self._batcher = MicroBatcher(
            self._execute_batch,
            max_batch=self.config.max_batch,
            max_wait_s=self.config.max_wait_s,
            queue_size=self.config.queue_size,
            on_discard=self._discard,
        )
        # explore jobs get their own small lane: separate worker
        # thread(s), separate bounded queue — a multi-second sweep can
        # never occupy the predict worker, and each job runs on a
        # private Session (sharing the disk store), so the predict
        # Session stays single-threaded
        self._explore_pool = BoundedWorkerPool(
            max_workers=self.config.explore_workers,
            max_pending=self.config.explore_pending,
            name="repro-service-explore",
        )
        self._running = False

    # --- lifecycle ---------------------------------------------------------

    def start(self) -> "PredictionService":
        self._running = True
        self._batcher.start()
        self._explore_pool.start()
        return self

    def stop(self) -> None:
        """Drain the queue, resolve every pending future, stop the
        worker.  Submissions after stop raise ``RuntimeError``; a
        submission that raced past the check and enqueued behind the
        stop sentinel gets that same error on its future rather than
        hanging its waiter."""
        if not self._running:
            return
        self._running = False
        self._batcher.stop()
        self._explore_pool.stop()

    def _discard(self, leftovers: list[PendingRequest]) -> None:
        error = RuntimeError(
            "PredictionService stopped before this request was served"
        )
        failed = 0
        for item in leftovers:
            if resolve_future(item.future, error=error):
                failed += 1
        with self._stats_lock:
            self.stats.failed += failed

    def __enter__(self) -> "PredictionService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- submission --------------------------------------------------------

    def submit(self, source, request: PredictionRequest, *,
               key: object = None) -> Future:
        """Enqueue one prediction; returns a Future resolving to a
        :class:`ServiceResponse`.

        ``key`` is the dedup identity — requests sharing a key within a
        batch are computed once and fanned out to every waiter.  The
        default keys on source *object* identity plus request equality
        (:func:`repro_torch.service.scheduler.default_key`).

        Raises ``ServiceOverloadedError`` when the bounded queue is
        full and ``ValueError`` for a request matching no grid cells
        (both before any queueing).
        """
        if not self._running:
            raise RuntimeError(NOT_RUNNING)
        if not any(True for _ in request.cells()):
            raise ValueError(
                f"request matched no grid cells: {request.describe()}"
            )
        item = PendingRequest(
            source=source, request=request,
            key=key if key is not None else default_key(source, request),
            future=Future(), enqueued_at=time.monotonic(),
        )
        try:
            accepted = self._batcher.offer(item)
        except RuntimeError:
            # lost the race against a concurrent stop()
            raise RuntimeError(NOT_RUNNING) from None
        if not accepted:
            with self._stats_lock:
                self.stats.shed += 1
            raise ServiceOverloadedError(SHED_MESSAGE.format(
                depth=self._batcher.depth, limit=self.config.queue_size
            ))
        with self._stats_lock:
            self.stats.submitted += 1
        return item.future

    def predict(self, source, request: PredictionRequest, *,
                key: object = None, timeout: float | None = None
                ) -> ServiceResponse:
        """Blocking convenience: ``submit(...).result(timeout)``."""
        return self.submit(source, request, key=key).result(timeout)

    # --- explore lane ------------------------------------------------------

    def _explore_stream(self):
        """A CUDA stream of the explore job's own (nothing on the host)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(torch.cuda.Stream(self.device))

    def submit_explore(self, source, space, *, agent: str = "hillclimb",
                       budget: int = 256, seed: int = 0,
                       mode: str = "throughput",
                       objective: str | None = None,
                       inner: str = "vmap",
                       workload: str | None = None,
                       refresh: bool = False) -> Future:
        """Enqueue a config-space search (``repro_torch.explore``) on the
        bounded explore pool; the Future resolves to the
        ``run_explore`` result dict.

        Validation (unknown agent, empty space, over-cap budget) raises
        ``ValueError`` here — before queueing — and a full explore lane
        raises ``ServiceOverloadedError``, exactly like ``submit``.
        Each job builds a private Session on the service's device over
        its artifact dir, and runs on a stream of its own: profiles and
        trajectories persist in the shared store, but the predict
        Session is never touched off its worker thread.
        """
        from repro_torch.explore import make_agent, run_explore

        if not self._running:
            raise RuntimeError(NOT_RUNNING)
        cap = self.config.explore_budget_cap
        if budget < 1 or budget > cap:
            raise ValueError(
                f"explore budget {budget} outside [1, {cap}] "
                "(ServiceConfig.explore_budget_cap)"
            )
        make_agent(agent)  # unknown agent -> ValueError before queueing
        artifact_dir = self._artifact_dir

        def job() -> dict:
            with self._explore_stream():
                session = Session(
                    cache_model=AnalyticalSDCM(backend="batched"),
                    device=self.device, artifact_dir=artifact_dir,
                )
                return run_explore(
                    source, space, agent=agent, budget=budget, seed=seed,
                    session=session, mode=mode, objective=objective,
                    inner=inner, workload=workload, refresh=refresh,
                )

        try:
            future = self._explore_pool.try_submit(job)
        except RuntimeError:
            raise RuntimeError(NOT_RUNNING) from None
        if future is None:
            raise ServiceOverloadedError(
                f"explore lane is full ({self._explore_pool.depth} "
                f"pending, limit {self.config.explore_pending}); request "
                "shed — retry with backoff or raise "
                "ServiceConfig.explore_pending"
            )
        return future

    def explore(self, source, space, *, timeout: float | None = None,
                **kwargs) -> dict:
        """Blocking convenience: ``submit_explore(...).result()``."""
        return self.submit_explore(source, space, **kwargs).result(timeout)

    def snapshot(self) -> dict:
        """Service + Session counters in one json-serializable dict."""
        with self._stats_lock:
            out = {"service": self.stats.to_dict()}
        out["session"] = dataclasses.asdict(self.session.stats)
        out["explore"] = self._explore_pool.stats_dict()
        store = self.session.store
        if store is not None:
            out["store"] = dataclasses.asdict(store.stats)
        return out

    # --- worker side -------------------------------------------------------

    def _execute_batch(self, batch: list[PendingRequest]) -> None:
        """Runs on the worker thread with one collected batch.

        The whole coalesced batch is ONE ``predict_many`` call — one
        ragged SDCM launch on the card, every row with its own shape —
        so splitting here would only fragment the batch into extra
        round-trips."""
        formed_at = time.monotonic()
        comps = coalesce(batch)
        with self._stats_lock:
            self.stats.record_batch(len(batch))
            self.stats.coalesced += len(comps)
            self.stats.deduped += len(batch) - len(comps)
        self._execute_group(comps, len(batch), formed_at)

    def _execute_group(self, group, batch_size: int,
                       formed_at: float) -> None:
        results: list[PredictionSet | Exception]
        try:
            with self._stats_lock:
                self.stats.kernel_calls += 1
            results = list(self.session.predict_many(
                [(c.source, c.request) for c in group]
            ))
        except Exception:
            # one poisoned computation must not fail the whole group:
            # retry each individually so only its waiters see the error
            results = []
            for comp in group:
                try:
                    with self._stats_lock:
                        self.stats.kernel_calls += 1
                    results.append(
                        self.session.predict(comp.source, comp.request)
                    )
                except Exception as exc:  # noqa: BLE001 — forwarded
                    results.append(exc)
        done_at = time.monotonic()
        completed = failed = cancelled = 0
        queue_wait = service = 0.0
        for comp, res in zip(group, results):
            for waiter in comp.waiters:
                timing = RequestTiming(
                    queue_wait_s=formed_at - waiter.enqueued_at,
                    service_s=done_at - formed_at,
                    batch_size=batch_size,
                    group_size=len(group),
                    shared=len(comp.waiters) > 1,
                )
                queue_wait += timing.queue_wait_s
                service += timing.service_s
                if isinstance(res, Exception):
                    if resolve_future(waiter.future, error=res):
                        failed += 1
                    else:
                        cancelled += 1
                elif resolve_future(waiter.future,
                                    ServiceResponse(res, timing)):
                    completed += 1
                else:  # caller cancelled while queued — never fatal
                    cancelled += 1
        with self._stats_lock:
            self.stats.completed += completed
            self.stats.failed += failed
            self.stats.cancelled += cancelled
            self.stats.queue_wait_s += queue_wait
            self.stats.service_s += service
