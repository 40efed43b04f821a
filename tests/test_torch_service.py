"""The prediction service of the port (``repro_torch.service``) on the
CPU: the reference's scheduler, explore-lane, server, CLI and identity
cases against the port with ``device="cpu"``, and the same HTTP payloads
sent to the port's and the reference's servers (hit rates within 1e-6,
``t_pred_s`` within rel 1e-6)."""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
from repro_torch.api.batched import _row_shape_key, batched_hit_rates
from repro_torch.core.trace.types import trace_from_blocks
from repro_torch.hw.targets import resolve_target
from repro_torch.service import (
    MicroBatcher,
    PendingRequest,
    PredictionService,
    ServiceConfig,
    ServiceOverloadedError,
    coalesce,
)
from repro_torch.service.client import ServiceClient, ServiceError
from repro_torch.service.scheduler import BoundedWorkerPool
from repro_torch.service.server import PredictionServer

ROOT = Path(__file__).resolve().parents[1]
CPU = ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P")
SPACE = {"sets": [512, 4096], "ways": [4, 8], "cores": [1, 2]}
RATE_TOL = 1e-6      # hit rates, port vs reference
T_RTOL = 1e-6        # t_pred_s, port vs reference (relative)


def make_trace(iters=200, stride=8, seed=None):
    """The reference tests' small trace; ``seed`` draws the second
    array's offsets at random (the identity tests' traces)."""
    rng = np.random.default_rng(seed)
    blocks = [("OUT__1__.entry", np.array([0, 8]), True)]
    A0, B0 = 1 << 20, 2 << 20
    for i in range(iters):
        j = i % 64 if seed is None else int(rng.integers(0, 64))
        blocks.append((
            "OUT__1__.for.body",
            np.array([A0 + stride * i, B0 + stride * j, 0]),
            np.array([False, False, True]),
        ))
    return trace_from_blocks(blocks)


def request(targets=("i7-5960X",), cores=(1, 2)):
    return PredictionRequest(
        targets=targets, core_counts=cores, respect_core_limit=False
    )


def pending(source, req, key):
    return PendingRequest(source, req, key, Future(), time.monotonic())


def cpu_service(session=None, **config) -> PredictionService:
    return PredictionService(session, config=ServiceConfig(device="cpu",
                                                           **config))


# --- pure coalescing logic ---------------------------------------------------


def test_coalesce_dedups_by_key_preserving_order():
    t = make_trace()
    r = request()
    items = [pending(t, r, "a"), pending(t, r, "b"), pending(t, r, "a"),
             pending(t, r, "a")]
    comps = coalesce(items)
    assert [c.key for c in comps] == ["a", "b"]
    assert len(comps[0].waiters) == 3
    assert len(comps[1].waiters) == 1


def test_kernel_compatibility_grouping_lives_in_the_batched_kernel():
    """The scheduler does NOT split batches by cache geometry — each row
    carries its own (A_MAX, padded-M) shape into the one ragged launch."""
    art = Session(device="cpu").artifacts(make_trace(), 1)
    i7 = resolve_target("i7-5960X")      # 16-way L3: bucket 16
    tpu = resolve_target("tpu-v5e")      # fully associative: min bucket
    key_cpu = _row_shape_key(art.prd, i7.levels[-1].effective_assoc,
                             i7.levels[-1].num_lines)
    key_tpu = _row_shape_key(art.prd, tpu.levels[0].effective_assoc,
                             tpu.levels[0].num_lines)
    assert key_cpu[0] != key_tpu[0]


# --- MicroBatcher ------------------------------------------------------------


def test_offer_returns_false_when_queue_full():
    mb = MicroBatcher(lambda batch: None, max_batch=4, max_wait_s=0.01,
                      queue_size=2)
    t, r = make_trace(), request()
    assert mb.offer(pending(t, r, 1))
    assert mb.offer(pending(t, r, 2))
    assert not mb.offer(pending(t, r, 3))  # full: caller sheds


@pytest.mark.parametrize("case", ["max_wait", "batch_budget"])
def test_batches_flush(case):
    """A lone request must not wait for ``max_batch`` company (the wait
    window closes and the partial batch flushes); a full batch flushes
    before a window far larger than the test's budget closes."""
    batches = []
    done = threading.Event()
    want = [1] if case == "max_wait" else [3, 3]

    def executor(batch):
        batches.append(len(batch))
        if sum(batches) == sum(want):
            done.set()

    if case == "max_wait":
        mb = MicroBatcher(executor, max_batch=64, max_wait_s=0.05,
                          queue_size=16)
    else:
        mb = MicroBatcher(executor, max_batch=3, max_wait_s=30.0,
                          queue_size=16)
    t, r = make_trace(), request()
    t0 = time.monotonic()
    for i in range(sum(want)):
        assert mb.offer(pending(t, r, i))
    mb.start()
    try:
        assert done.wait(timeout=5.0), "batch never flushed"
        assert time.monotonic() - t0 < 4.0
        assert batches == want
    finally:
        mb.stop()


# --- service-level dedup / shed ---------------------------------------------


class GatedSDCM(AnalyticalSDCM):
    """Blocks every grid evaluation until the test releases it."""

    def __init__(self):
        super().__init__(backend="numpy", device="cpu")
        self.entered = threading.Event()
        self.release = threading.Event()

    def hit_rates_grid(self, items):
        self.entered.set()
        assert self.release.wait(timeout=30.0)
        return super().hit_rates_grid(items)


def gated_service(**config):
    gate = GatedSDCM()
    return gate, cpu_service(Session(cache_model=gate, device="cpu"),
                             **config)


def test_duplicate_requests_compute_once_and_fan_out():
    """K identical submissions in one batch: ONE computation, K futures
    all carrying the same (equal-bits) result."""
    trace, req = make_trace(), request()
    gate, service = gated_service(max_batch=32, max_wait_ms=50,
                                  queue_size=64)
    with service:
        plug = service.submit(make_trace(50), request(cores=(1,)))
        assert gate.entered.wait(timeout=10.0)  # worker busy on the plug
        gate.entered.clear()
        futs = [service.submit(trace, req) for _ in range(5)]
        gate.release.set()
        responses = [f.result(timeout=30.0) for f in futs]
        plug.result(timeout=30.0)

    first = responses[0].result
    for resp in responses[1:]:
        for a, b in zip(first, resp.result):
            assert a.hit_rates == b.hit_rates
        assert resp.timing.shared
    assert service.stats.deduped == 4
    assert service.stats.submitted == 6
    assert service.stats.completed == 6
    assert 5 in service.stats.recent_batch_sizes
    assert service.stats.max_batch_size == 5
    # plug (1 cell) + the deduped request (2 core counts) — never 5x
    assert service.session.stats.profile_builds == 3


def test_full_queue_sheds_with_documented_error():
    trace, req = make_trace(), request()
    gate, service = gated_service(max_batch=1, max_wait_ms=1, queue_size=2)
    with service:
        plug = service.submit(trace, req, key="plug")
        assert gate.entered.wait(timeout=10.0)  # worker blocked mid-batch
        queued = [service.submit(trace, req, key=i) for i in range(2)]
        with pytest.raises(ServiceOverloadedError, match="queue is full"):
            service.submit(trace, req, key="overflow")
        assert service.stats.shed == 1
        gate.release.set()
        plug.result(timeout=30.0)
        for f in queued:
            f.result(timeout=30.0)
    assert service.stats.completed == 3


def test_submit_rejects_empty_grid_before_queueing():
    service = cpu_service(max_wait_ms=1)
    with service:
        with pytest.raises(ValueError, match="no grid cells"):
            # i7-5960X has 8 cores; respect_core_limit drops the cell
            service.submit(make_trace(), PredictionRequest(
                targets=("i7-5960X",), core_counts=(512,),
            ))
    assert service.stats.submitted == 0


@pytest.mark.parametrize("layer", ["service", "microbatcher"])
def test_submit_after_stop_raises(layer):
    """A late submission is rejected, never stranded behind the stop."""
    if layer == "service":
        service = cpu_service()
        service.start()
        service.stop()
        with pytest.raises(RuntimeError, match="not running"):
            service.submit(make_trace(), request())
        return
    mb = MicroBatcher(lambda batch: None, max_batch=4, max_wait_s=0.01,
                      queue_size=4)
    mb.start()
    mb.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        mb.offer(pending(make_trace(50), request(), "late"))


def test_cancelled_future_does_not_kill_worker():
    trace, req = make_trace(), request()
    gate, service = gated_service(max_batch=8, max_wait_ms=20,
                                  queue_size=64)
    with service:
        plug = service.submit(trace, req, key="plug")
        assert gate.entered.wait(timeout=10.0)
        doomed = service.submit(trace, req, key="doomed")
        assert doomed.cancel()  # still queued: cancel succeeds
        gate.release.set()
        plug.result(timeout=30.0)
        after = service.predict(trace, req, key="after", timeout=30.0)
        assert after.result.predictions
    assert service.stats.cancelled == 1
    assert service.stats.completed == 2


def test_stop_discards_strand_candidates_with_failed_futures():
    discarded = []
    mb = MicroBatcher(lambda batch: None, max_batch=4, max_wait_s=0.01,
                      queue_size=4, on_discard=discarded.extend)
    item = pending(make_trace(50), request(), "stranded")
    assert mb.offer(item)
    # worker never started: stop() must still hand the item back
    mb._thread = threading.Thread(target=lambda: None)
    mb._thread.start()
    mb.stop()
    assert discarded == [item]

    service = cpu_service(max_wait_ms=1)
    service._discard([item])
    with pytest.raises(RuntimeError, match="stopped before"):
        item.future.result(timeout=1.0)
    assert service.stats.failed == 1


def test_service_without_a_device_needs_cuda(monkeypatch):
    """The service runs on the card unless the CPU is asked for."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PredictionService()
    assert cpu_service().session.device.type == "cpu"


# --- BoundedWorkerPool -------------------------------------------------------


def test_pool_runs_jobs_and_counts():
    pool = BoundedWorkerPool(max_workers=1, max_pending=4)
    pool.start()
    try:
        futures = [pool.try_submit(lambda i=i: i * i) for i in range(3)]
        assert all(f is not None for f in futures)
        assert [f.result(5) for f in futures] == [0, 1, 4]
        stats = pool.stats_dict()
        assert stats["submitted"] == 3
        assert stats["completed"] == 3
        assert stats["active"] == 0
    finally:
        pool.stop()


def test_pool_sheds_when_pending_full():
    gate = threading.Event()
    pool = BoundedWorkerPool(max_workers=1, max_pending=1)
    pool.start()
    try:
        running = pool.try_submit(gate.wait)      # occupies the worker
        queued = None
        deadline = time.monotonic() + 5
        while queued is None and time.monotonic() < deadline:
            queued = pool.try_submit(gate.wait)
            if queued is None:
                time.sleep(0.01)
        assert queued is not None
        shed = False
        while not shed and time.monotonic() < deadline:
            shed = pool.try_submit(lambda: None) is None
            if not shed:
                time.sleep(0.01)
        assert shed, "pool never shed with a full pending lane"
        assert pool.stats_dict()["shed"] >= 1
        gate.set()
        assert running.result(5) is True
        assert queued.result(5) is True
    finally:
        gate.set()
        pool.stop()


def test_pool_forwards_exceptions_without_dying():
    pool = BoundedWorkerPool(max_workers=1, max_pending=4)
    pool.start()
    try:
        bad = pool.try_submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            bad.result(5)
        ok = pool.try_submit(lambda: "alive")
        assert ok.result(5) == "alive"
        stats = pool.stats_dict()
        assert stats["failed"] == 1 and stats["completed"] == 1
    finally:
        pool.stop()


@pytest.mark.parametrize("started", [True, False])
def test_pool_stop(started):
    """Stop drains accepted jobs and rejects later submits; stop before
    start fails the pending futures instead of stranding them."""
    pool = BoundedWorkerPool(max_workers=1, max_pending=4)
    if started:
        pool.start()
    f = pool.try_submit(lambda: 42)
    pool.stop()
    if started:
        assert f.result(5) == 42
        with pytest.raises(RuntimeError, match="stopped"):
            pool.try_submit(lambda: None)
    else:
        with pytest.raises(RuntimeError, match="stopped before"):
            f.result(1)


def test_pool_cancel_only_wins_while_pending():
    gate = threading.Event()
    pool = BoundedWorkerPool(max_workers=1, max_pending=2)
    pool.start()
    try:
        blocker = pool.try_submit(gate.wait)
        victim = pool.try_submit(lambda: "ran")
        assert victim.cancel()
        gate.set()
        assert blocker.result(5) is True
        deadline = time.monotonic() + 5
        while pool.stats_dict()["cancelled"] < 1:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    finally:
        gate.set()
        pool.stop()


# --- the explore lane --------------------------------------------------------


def explore_config():
    return dict(max_batch=16, max_wait_ms=5, queue_size=64,
                explore_workers=1, explore_pending=1, explore_budget_cap=64)


@pytest.fixture()
def service(tmp_path):
    svc = cpu_service(artifact_dir=str(tmp_path), **explore_config())
    with svc:
        yield svc


def resolve(name="polybench/atx", sizes="smoke"):
    from repro_torch.workloads import registry

    return registry.resolve(name, sizes)


def test_submit_explore_resolves_with_result(service):
    from repro_torch.explore import SearchSpace

    fut = service.submit_explore(
        resolve(), SearchSpace.from_json(SPACE), agent="random",
        budget=8, workload="polybench/atx",
    )
    assert isinstance(fut, Future)
    res = fut.result(120)
    assert res["best"]["config"]["size_bytes"] > 0
    assert res["trajectory"]["evaluations"] <= 8
    snap = service.snapshot()
    assert snap["explore"]["completed"] == 1
    # the predict Session was never touched by the explore job
    assert service.session.stats.profile_builds == 0


def test_submit_explore_validates_before_queueing(service):
    from repro_torch.explore import SearchSpace

    space = SearchSpace.from_json(SPACE)
    workload = resolve()
    with pytest.raises(ValueError, match="budget"):
        service.submit_explore(workload, space, budget=65)
    with pytest.raises(ValueError, match="unknown agent"):
        service.submit_explore(workload, space, agent="anneal", budget=4)
    assert service.snapshot()["explore"]["submitted"] == 0


def test_explore_does_not_starve_predict(service):
    from repro_torch.explore import SearchSpace

    workload = resolve()
    fut = service.submit_explore(
        workload, SearchSpace.from_json(SPACE), agent="random",
        budget=16, workload="polybench/atx",
    )
    req = PredictionRequest(targets=("i7-5960X",), core_counts=(1,))
    t0 = time.monotonic()
    resp = service.predict(workload, req, timeout=60)
    predict_s = time.monotonic() - t0
    assert resp.result is not None
    fut.result(120)
    assert predict_s < 60


# --- HTTP --------------------------------------------------------------------


def serve(svc):
    server = PredictionServer(svc, "127.0.0.1", 0)
    server.serve_background()
    return server


@pytest.fixture()
def served(tmp_path):
    svc = cpu_service(max_batch=16, max_wait_ms=10, queue_size=64)
    with svc:
        server = serve(svc)
        client = ServiceClient(server.url)
        client.wait_ready()
        try:
            yield svc, client
        finally:
            server.shutdown()
            server.server_close()


@pytest.fixture()
def served_explore(tmp_path):
    svc = cpu_service(artifact_dir=str(tmp_path), **explore_config())
    with svc:
        server = serve(svc)
        client = ServiceClient(server.url, timeout=120)
        client.wait_ready()
        try:
            yield svc, client
        finally:
            server.shutdown()
            server.server_close()


def test_explore_over_http(served_explore):
    _svc, client = served_explore
    out = client.explore("atx", sizes="smoke", space=SPACE,
                         agent="random", budget=8)
    assert out["workload"] == "polybench/atx"
    assert out["cached"] is False
    assert out["best"]["score"] > 0
    assert out["space"]["sets"] == SPACE["sets"]
    again = client.explore("atx", sizes="smoke", space=SPACE,
                           agent="random", budget=8)
    assert again["cached"] is True
    assert again["best"] == out["best"]
    assert client.stats()["explore"]["completed"] == 2


def test_explore_http_error_mapping(served_explore):
    _svc, client = served_explore
    with pytest.raises(ServiceError) as err:
        client.explore("atx", sizes="smoke",
                       space={"sets": [512], "bogus_axis": [1]})
    assert err.value.status == 400
    with pytest.raises(ServiceError) as err:
        client.explore("no/such/workload", space=SPACE)
    assert err.value.status == 400
    with pytest.raises(ServiceError) as err:
        client.explore("atx", sizes="smoke", space=SPACE, budget=10_000)
    assert err.value.status == 400


def test_healthz_and_stats(served):
    _service, client = served
    assert client.healthz() == {"ok": True}
    stats = client.stats()
    assert {"service", "session", "explore"} <= set(stats)
    assert stats["service"]["submitted"] == 0


def test_predict_over_http(served):
    _service, client = served
    out = client.predict("atx", sizes="smoke", core_counts=[1, 2],
                         targets=["i7-5960X"])
    assert out["workload"] == "polybench/atx"
    assert out["requested"] == "atx"
    assert len(out["predictions"]) == 2
    for cell in out["predictions"]:
        assert cell["target"] == "i7-5960X"
        assert 0.0 <= cell["hit_rates"]["L1"] <= 1.0
        assert cell["t_pred_s"] > 0
    assert out["timing"]["batch_size"] >= 1


def test_registry_names_and_aliases_coalesce(served):
    service, client = served
    a = client.predict("polybench/atx", sizes="smoke", core_counts=[1, 2],
                       targets=["i7-5960X"])
    b = client.predict("atx", sizes="smoke", core_counts=[1, 2],
                       targets=["i7-5960X"])
    assert a["workload"] == b["workload"] == "polybench/atx"
    assert a["trace_id"] == b["trace_id"]
    assert a["predictions"] == b["predictions"]
    assert service.session.stats.trace_builds <= 1


def test_concurrent_clients_coalesce(served):
    _service, client = served
    errors = []

    def go():
        try:
            out = client.predict("atx", sizes="smoke", core_counts=[1, 2])
            assert len(out["predictions"]) == 6  # 3 CPU targets x 2 cores
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=go) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    stats = client.stats()
    assert stats["service"]["completed"] == 8
    assert stats["service"]["coalesced"] <= stats["service"]["submitted"]
    assert stats["session"]["profile_builds"] <= 2


@pytest.mark.parametrize("endpoint", ["predict", "explore"])
def test_model_workload_over_http_is_not_served_yet(served, endpoint):
    """The reference serves every ``model/<arch>/<step>`` workload, and
    so does the port: a ``train`` cell is answered with 200, ``/predict``
    with a sequential ``Session.predict``'s answer, ``/explore`` with a
    search over its trace."""
    from repro_torch.service.server import build_request

    _service, client = served
    name = "model/llama3_8b/train"
    if endpoint == "explore":
        out = client.explore(name, sizes="smoke", space=SPACE,
                             agent="random", budget=8)
        assert out["workload"] == name and out["best"]["score"] > 0
        return
    payload = {"workload": name, "sizes": "smoke", "targets": ["tpu-v5e"],
               "core_counts": [1]}
    got = client.predict(**payload)
    assert got["workload"] == name
    workload = resolve(name)
    want = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cpu").predict(workload,
                                         build_request(payload, workload))
    assert got["predictions"] == json.loads(want.to_json())["predictions"]


def test_model_decode_over_http_equals_session_predict(served):
    """The reference's selftest payload (``model/llama3_8b/decode`` on
    ``tpu-v5e``) is served with 200 and the answer of a sequential
    ``Session.predict`` with the service's cache model on the same
    source, bit for bit after the JSON round trip; the raw arch id
    routes to the same cell."""
    from repro_torch.service.server import build_request

    svc, client = served
    payload = {"workload": "model/llama3_8b/decode", "sizes": "smoke",
               "targets": ["tpu-v5e"], "core_counts": [1]}
    got = client.predict(**payload)
    assert got["workload"] == "model/llama3_8b/decode"
    workload = resolve("model/llama3_8b/decode")
    want = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cpu").predict(workload,
                                         build_request(payload, workload))
    assert got["predictions"] == json.loads(want.to_json())["predictions"]
    alias = client.predict(**{**payload, "workload": "model/llama3-8b/decode"})
    assert alias["workload"] == "model/llama3_8b/decode"
    assert alias["predictions"] == got["predictions"]


def test_error_mapping(served):
    _service, client = served
    with pytest.raises(ServiceError, match="unknown workload") as ei:
        client.predict("nope")
    assert ei.value.status == 400
    with pytest.raises(ServiceError, match="unknown size preset") as ei:
        client.predict("atx", sizes="enormous")
    assert ei.value.status == 400
    with pytest.raises(ServiceError, match="unknown target") as ei:
        client.predict("atx", sizes="smoke", targets=["z80"])
    assert ei.value.status == 400
    with pytest.raises(ServiceError) as ei:
        client._call("/nowhere", {})
    assert ei.value.status == 404


# --- the documented entrypoint ----------------------------------------------


def run_selftest(artifact_dir: Path) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
    )
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--selftest",
         "--device", "cpu", "--artifact-dir", str(artifact_dir)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout)


def test_second_service_process_rebuilds_nothing(tmp_path):
    store = tmp_path / "artifacts"

    first = run_selftest(store)
    assert first["selftest"] == "ok" and first["device"] == "cpu"
    assert first["session"]["profile_builds"] > 0
    assert first["session"]["store_puts"] == first["session"]["profile_builds"]
    assert first["service"]["completed"] == first["requests"]

    second = run_selftest(store)
    assert second["selftest"] == "ok"
    assert second["session"]["profile_builds"] == 0
    assert second["session"]["rd_builds"] == 0
    assert second["session"]["store_hits"] == first["session"]["store_puts"]
    assert second["service"]["completed"] == second["requests"]
    assert second["service"]["deduped"] > 0


# --- bit identity with sequential Session.predict ---------------------------


REQUESTS = [
    PredictionRequest(targets=CPU, core_counts=(1, 2, 4),
                      respect_core_limit=False),
    PredictionRequest(targets=("i7-5960X",), core_counts=(1, 8),
                      strategies=("round_robin", "chunked"),
                      respect_core_limit=False),
    PredictionRequest(targets=("tpu-v5e", "EPYC 7702P"), core_counts=(2,),
                      respect_core_limit=False),
    PredictionRequest(targets=CPU[:1], core_counts=(1, 4),
                      window_size=1 << 10, respect_core_limit=False),
]


def assert_bit_identical(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.target, x.cores, x.strategy, x.mode) == \
               (y.target, y.cores, y.strategy, y.mode)
        assert x.hit_rates == y.hit_rates          # exact float equality
        assert x.t_pred_s == y.t_pred_s


def test_concurrent_service_matches_sequential_predict_exactly():
    traces = [make_trace(150, 8, 0), make_trace(220, 16, 1)]
    pairs = [(t, r) for t in traces for r in REQUESTS]

    sequential = Session(cache_model=AnalyticalSDCM(backend="batched"),
                         device="cpu")
    expected = {i: sequential.predict(t, r)
                for i, (t, r) in enumerate(pairs)}

    service = cpu_service(max_batch=16, max_wait_ms=25, queue_size=256)
    jobs = [(i, t, r) for i, (t, r) in enumerate(pairs)] * 3
    random.Random(7).shuffle(jobs)
    results: dict[int, list] = {}
    lock = threading.Lock()

    def client(chunk):
        for i, t, r in chunk:
            resp = service.predict(t, r, timeout=120.0)
            with lock:
                results.setdefault(i, []).append(resp.result)

    with service:
        step = max(1, len(jobs) // 8)
        chunks = [jobs[k:k + step] for k in range(0, len(jobs), step)]
        threads = [threading.Thread(target=client, args=(c,))
                   for c in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)

    assert sum(len(v) for v in results.values()) == len(jobs)
    for i, copies in results.items():
        for got in copies:
            assert_bit_identical(expected[i], got)
    assert service.stats.batches < service.stats.submitted


_POOL: list | None = None


def _pool() -> list:
    """Fixed (target, artifacts) cells the property test composes."""
    global _POOL
    if _POOL is None:
        session = Session(device="cpu")
        traces = [make_trace(150, 8, 0), make_trace(220, 16, 1),
                  make_trace(90, 24, 2)]
        arts = [session.artifacts(t, c) for t in traces for c in (1, 2)]
        targets = [resolve_target(n) for n in CPU + ("tpu-v5e",)]
        _POOL = [(tg, a) for a in arts for tg in targets]
    return _POOL


@settings(max_examples=25, deadline=None)
@given(idx=st.lists(st.integers(min_value=0, max_value=63), min_size=1,
                    max_size=8))
def test_batched_rows_are_composition_invariant(idx):
    pool = _pool()
    items = [pool[i % len(pool)] for i in idx]
    together = batched_hit_rates(items, device="cpu")
    alone = [batched_hit_rates([item], device="cpu")[0] for item in items]
    assert together == alone


# --- the port's server against the reference's -----------------------------


PARITY_PAYLOADS = [
    {"workload": "polybench/atx", "sizes": "smoke",
     "core_counts": [1, 2, 4]},
    {"workload": "mvt", "sizes": "smoke", "core_counts": [1, 8],
     "targets": ["i7-5960X"], "strategies": ["round_robin", "uniform"]},
    {"workload": "polybench/jcb", "sizes": "smoke", "core_counts": [2],
     "targets": ["EPYC 7702P", "tpu-v5e"], "runtime_model": "roofline"},
    {"workload": "polybench/2mm", "sizes": "smoke", "core_counts": [4],
     "runtime_model": "ecm", "window_size": 256},
    {"workload": "polybench/bcg", "sizes": "smoke", "core_counts": [1, 2],
     "targets": ["Xeon E5-2699 v4"], "sampled_rate": 0.5},
    {"workload": "synthetic/stride", "sizes": "smoke", "core_counts": [1],
     "targets": ["tpu-v5e"], "runtime": False},
]


def post(url: str, payload: dict) -> dict:
    from urllib.request import Request, urlopen

    req = Request(url + "/predict", data=json.dumps(payload).encode(),
                  headers={"Content-Type": "application/json"})
    with urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def both_servers():
    from repro.service import PredictionService as RefService
    from repro.service import ServiceConfig as RefConfig
    from repro.service.server import PredictionServer as RefServer

    port_svc = cpu_service(max_wait_ms=5)
    ref_svc = RefService(config=RefConfig(max_wait_ms=5))
    with port_svc, ref_svc:
        servers = [PredictionServer(port_svc, "127.0.0.1", 0),
                   RefServer(ref_svc, "127.0.0.1", 0)]
        for s in servers:
            s.serve_background()
        try:
            yield [s.url for s in servers]
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()


@pytest.mark.parametrize("payload", PARITY_PAYLOADS,
                         ids=[p["workload"] for p in PARITY_PAYLOADS])
def test_port_server_matches_reference_server(both_servers, payload):
    port_url, ref_url = both_servers
    got, want = post(port_url, payload), post(ref_url, payload)
    assert set(got) == set(want)
    for key in ("workload", "requested", "sizes", "cache_model",
                "trace_id"):
        assert got[key] == want[key], key
    assert set(got["timing"]) == set(want["timing"])
    assert len(got["predictions"]) == len(want["predictions"])
    for g, w in zip(got["predictions"], want["predictions"]):
        assert set(g) == set(w)
        for key in ("target", "cores", "strategy", "mode", "runtime_model"):
            assert g.get(key) == w.get(key), key
        assert set(g["hit_rates"]) == set(w["hit_rates"])
        for lvl, rate in w["hit_rates"].items():
            assert g["hit_rates"][lvl] == pytest.approx(rate, abs=RATE_TOL)
        if w.get("t_pred_s") is None:
            assert g.get("t_pred_s") is None
        else:
            assert g["t_pred_s"] == pytest.approx(w["t_pred_s"], rel=T_RTOL)
