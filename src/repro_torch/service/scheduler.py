"""Microbatching scheduler: queue -> collect -> dedup -> group (port of
``repro/service/scheduler.py``; framework-free, a copy of its own).

The service's concurrency story is deliberately simple: submitters put
:class:`PendingRequest` items on ONE bounded queue, and ONE worker
thread owns the Session.  The Session (and its artifact caches) are
never touched from two threads, so no stage needs locking — the
scheduler turns concurrency into batch size instead.

Batch formation (``MicroBatcher.collect``):

1. block for the first item (idle costs nothing);
2. keep draining the queue until either ``max_batch`` items are
   gathered or ``max_wait_s`` has elapsed since the first item — a
   partial batch *always* flushes when the wait window closes, a
   lone request is never stranded;
3. hand the batch to the service's executor.

Within a batch, :func:`coalesce` dedups identical computations (same
``key``: by default the same source object + an equal request), so N
clients asking the same question cost one evaluation fanned out to all
N futures.  The whole coalesced batch then goes to ONE
``Session.predict_many`` call — kernel-compatibility grouping happens
*inside* the batched SDCM path: on the card every row of the batch goes
to ONE launch of kernel B1's ragged form (``sdcm_rates_ragged``), each
row with its own length and A_MAX bucket
(``repro_torch.api.batched._row_shape_key``), so an odd cache geometry
never splits the batch and the scheduler has nothing left to split.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

from repro_torch.api.request import PredictionRequest


@dataclasses.dataclass
class PendingRequest:
    """One submitted request waiting in the queue."""

    source: object
    request: PredictionRequest
    key: object                 # dedup identity (hashable)
    future: Future
    enqueued_at: float          # time.monotonic() at submit


@dataclasses.dataclass
class Computation:
    """One unique computation a batch performs; ``waiters`` are every
    pending request that coalesced onto it (>= 1)."""

    key: object
    source: object
    request: PredictionRequest
    waiters: list[PendingRequest]


def default_key(source, request: PredictionRequest) -> object:
    """Dedup identity used when the submitter doesn't provide one.

    Source identity is the *object* (``id``), not the trace content:
    hashing a trace is O(N) and must stay on the worker thread.  The
    HTTP server resolves workloads through a cache, so equal specs map
    to one object; in-process callers submitting distinct-but-equal
    trace objects should pass an explicit ``key``.  The pending item
    pins the source, so the id cannot be recycled while queued.
    """
    return (id(source), request)


def coalesce(batch: list[PendingRequest]) -> list[Computation]:
    """Dedup a batch by key, preserving first-seen order."""
    by_key: dict[object, Computation] = {}
    for item in batch:
        comp = by_key.get(item.key)
        if comp is None:
            by_key[item.key] = Computation(
                item.key, item.source, item.request, [item]
            )
        else:
            comp.waiters.append(item)
    return list(by_key.values())


def resolve_future(future: Future, result=None, error=None) -> bool:
    """Resolve a waiter's future, tolerating callers that cancelled it
    while it was queued (``set_result`` on a cancelled future raises
    ``InvalidStateError`` — which must never kill the worker thread).
    Returns False when the future was already cancelled/resolved."""
    if not future.set_running_or_notify_cancel():
        return False
    if error is not None:
        future.set_exception(error)
    else:
        future.set_result(result)
    return True


_STOP = object()


class MicroBatcher:
    """Bounded queue + single collector thread.

    ``executor(batch)`` is called on the worker thread with each
    collected batch (a non-empty ``list[PendingRequest]``); it must
    resolve every item's future (result or exception) and never raise.
    """

    def __init__(self, executor, *, max_batch: int, max_wait_s: float,
                 queue_size: int, on_discard=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._executor = executor
        self._on_discard = on_discard  # called with items left at stop
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._queue: queue.Queue = queue.Queue(maxsize=queue_size)
        self._thread: threading.Thread | None = None
        self._stopped = False
        # serializes offer() against stop()'s flag flip: an offer either
        # lands before the stop sentinel (and is drained) or is rejected
        self._state_lock = threading.Lock()

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    def start(self) -> None:
        if self._thread is not None:
            return
        # flips under the same lock as stop()/offer(): a restart racing
        # a concurrent offer() must not leave the flag torn
        with self._state_lock:
            self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name="repro-service-batcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop the worker after draining everything already queued.

        The stop flag flips under the same lock ``offer`` holds, so
        every accepted item sits ahead of the sentinel and is served
        before the worker exits; later offers raise.  Anything
        unexpectedly left after the join (belt-and-braces — e.g. a
        sentinel re-queue interleaving) goes to ``on_discard`` so no
        waiter is ever stranded."""
        with self._state_lock:
            self._stopped = True
        thread, self._thread = self._thread, None
        if thread is not None:
            self._queue.put(_STOP)
            thread.join()
        # drain even when the worker never started (stop before start
        # must not strand an offered waiter either)
        leftovers = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        if leftovers and self._on_discard is not None:
            self._on_discard(leftovers)

    def offer(self, item: PendingRequest) -> bool:
        """Enqueue without blocking; False means the queue is full (the
        caller sheds the request).  Raises ``RuntimeError`` once the
        batcher is stopped — a racing late submission must be rejected,
        not silently stranded behind the stop sentinel."""
        with self._state_lock:
            if self._stopped:
                raise RuntimeError("MicroBatcher is stopped")
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                return False
            return True

    # --- worker side -------------------------------------------------------

    def collect(self, first: PendingRequest) -> list[PendingRequest]:
        """Gather one batch: up to ``max_batch`` items or until
        ``max_wait_s`` elapses past the first item, whichever first."""
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _STOP:
                # re-queue so the outer loop sees it after this batch
                self._queue.put(_STOP)
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            batch = self.collect(item)
            try:
                self._executor(batch)
            except BaseException as exc:  # noqa: BLE001 — keep serving
                # the executor contract is "never raise", but a dead
                # worker wedges the whole service; resolve the batch's
                # futures and keep going
                for pending in batch:
                    resolve_future(pending.future, error=exc)


@dataclasses.dataclass
class PoolStats:
    """Observable worker-pool behaviour (asserted by tests)."""

    submitted: int = 0          # accepted into the pending queue
    completed: int = 0          # futures resolved with a result
    failed: int = 0             # futures resolved with an exception
    cancelled: int = 0          # cancelled while pending
    shed: int = 0               # rejected, pending queue full
    active: int = 0             # jobs executing right now


class BoundedWorkerPool:
    """Fixed worker threads + a bounded pending queue for LONG jobs.

    The microbatcher above turns many small requests into batch size;
    this pool is its counterpart for requests that are individually
    expensive (config-space sweeps via ``POST /explore``): a separate,
    deliberately small lane so a multi-second search can never occupy
    the predict worker or its queue.  Backpressure is the same
    load-shedding contract — ``try_submit`` returns ``None`` when
    ``max_pending`` jobs are already waiting, and the HTTP layer maps
    that to 503 exactly like a full predict queue.
    """

    def __init__(self, *, max_workers: int = 1, max_pending: int = 2,
                 name: str = "repro-service-pool"):
        if max_workers < 1:
            raise ValueError("max_workers must be >= 1")
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.max_workers = max_workers
        self.max_pending = max_pending
        self._name = name
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._threads: list[threading.Thread] = []
        self._stopped = False
        self.stats = PoolStats()
        # one lock serializes submit/stop/stat flips (MicroBatcher's
        # accepted-before-sentinel draining argument applies unchanged)
        self._state_lock = threading.Lock()

    @property
    def depth(self) -> int:
        return self._queue.qsize()

    def start(self) -> None:
        if self._threads:
            return
        with self._state_lock:
            self._stopped = False
        for i in range(self.max_workers):
            t = threading.Thread(
                target=self._run, name=f"{self._name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        """Drain accepted jobs, then stop every worker.  Jobs still
        pending after the join (stop before start) resolve with a
        RuntimeError rather than stranding their waiters."""
        with self._state_lock:
            self._stopped = True
        threads, self._threads = self._threads, []
        for _ in threads:
            self._queue.put(_STOP)
        for t in threads:
            t.join()
        error = RuntimeError("worker pool stopped before this job ran")
        dropped = 0
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                continue
            _fn, future = item
            if resolve_future(future, error=error):
                dropped += 1
        with self._state_lock:
            self.stats.failed += dropped

    def try_submit(self, fn) -> Future | None:
        """Enqueue ``fn`` (a zero-arg callable); ``None`` means the
        pending lane is full and the caller sheds.  Raises
        ``RuntimeError`` once stopped."""
        future: Future = Future()
        with self._state_lock:
            if self._stopped:
                raise RuntimeError("BoundedWorkerPool is stopped")
            try:
                self._queue.put_nowait((fn, future))
            except queue.Full:
                self.stats.shed += 1
                return None
            self.stats.submitted += 1
        return future

    def stats_dict(self) -> dict:
        with self._state_lock:
            out = dataclasses.asdict(self.stats)
        out["depth"] = self.depth
        out["max_workers"] = self.max_workers
        out["max_pending"] = self.max_pending
        return out

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _STOP:
                return
            fn, future = item
            # mark running BEFORE executing: a cancel can only win while
            # the job is still pending, never mid-flight
            if not future.set_running_or_notify_cancel():
                with self._state_lock:
                    self.stats.cancelled += 1
                continue
            with self._state_lock:
                self.stats.active += 1
            try:
                result = fn()
            except BaseException as exc:  # noqa: BLE001 — forwarded
                future.set_exception(exc)
                with self._state_lock:
                    self.stats.active -= 1
                    self.stats.failed += 1
            else:
                future.set_result(result)
                with self._state_lock:
                    self.stats.active -= 1
                    self.stats.completed += 1
