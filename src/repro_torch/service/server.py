"""HTTP front door for the prediction service (stdlib only; port of
``repro/service/server.py``, the same endpoints and JSON schema key for
key, so a client of the reference works against the port unchanged).

A ``ThreadingHTTPServer`` gives every client connection its own
handler thread; all those threads funnel into the service's ONE
bounded queue, so concurrent HTTP clients become microbatches for the
batched SDCM kernel (one ragged launch a batch on the card) exactly like
in-process submitters.

Endpoints (JSON in/out):

    POST /predict   {"workload": "polybench/atx", "sizes": "smoke",
                     "targets": [...], "core_counts": [1, 4, 8],
                     "strategies": ["round_robin"], "runtime": true,
                     "runtime_model": "auto" | "eq" | "ecm" | "roofline"}
    POST /explore   {"workload": "polybench/atx", "sizes": "smoke",
                     "space": {"sets": [...], "ways": [...]},
                     "agent": "hillclimb", "budget": 256, "seed": 0}
    GET  /stats     service + session + store counters
    GET  /healthz   liveness

``/explore`` runs on the service's bounded explore pool (its own
worker lane), so a multi-second config sweep can never starve
``/predict`` microbatches; the handler thread blocks on the job's
future and returns the full ``run_explore`` result dict.

Error mapping: bad payloads -> 400, queue-full load shed -> 503 (with
``Retry-After``), a workload the port does not serve yet -> 501 (every
registered workload is served, the ``model/<arch>/train`` cells
included), anything else -> 500.
Workloads are resolved by registry name (``polybench/atx``,
``synthetic/stream``, ``model/llama3_8b/decode``; legacy Table-4
abbreviations and raw arch ids stay routable as aliases) through a
cache, so
equal (workload, sizes) specs share one source object — and therefore
one declared fingerprint, one Session artifact set, and one dedup key
(aliases coalesce with their canonical spelling).
"""
from __future__ import annotations

import json
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.api import PredictionRequest
from repro_torch.hw.targets import ALL_TARGETS, CPU_TARGETS
from repro_torch.service.service import (
    PredictionService,
    ServiceOverloadedError,
)

DEFAULT_PORT = 8177


class WorkloadResolver:
    """Cached registry resolution: one source object per canonical
    (workload, sizes) spec.  ``store`` (the service Session's
    ArtifactStore) is forwarded to ``registry.resolve``, for sources
    that cache derived metadata on disk.
    """

    def __init__(self, store=None):
        self._lock = threading.Lock()
        self._store = store
        self._cache: dict[tuple[str, str | None], object] = {}

    def get(self, name: str, sizes: str | None):
        from repro_torch.workloads import registry

        try:
            canonical = registry.canonical_name(name)
        except KeyError as exc:
            raise ValueError(exc.args[0] if exc.args else str(exc)) from exc
        key = (canonical, sizes)
        with self._lock:
            if key not in self._cache:
                self._cache[key] = registry.resolve(
                    canonical, sizes, store=self._store
                )
            return self._cache[key]


def build_request(payload: dict, workload) -> PredictionRequest:
    """Translate one JSON payload into a PredictionRequest.

    Target names are resolved eagerly so an unknown one is a
    ``ValueError`` here (HTTP 400), not a worker-side failure (500)."""
    targets = tuple(payload.get("targets") or CPU_TARGETS)
    unknown = [t for t in targets if t not in ALL_TARGETS]
    if unknown:
        raise ValueError(
            f"unknown target(s) {unknown} (choose from "
            f"{sorted(ALL_TARGETS)})"
        )
    window = payload.get("window_size")
    sampled = payload.get("sampled_rate")
    return PredictionRequest(
        targets=targets,
        core_counts=tuple(payload.get("core_counts") or (1,)),
        strategies=tuple(payload.get("strategies") or ("round_robin",)),
        modes=tuple(payload.get("modes") or ("throughput",)),
        counts=workload.op_counts if payload.get("runtime", True) else None,
        # PredictionRequest validates the name against every requested
        # target, so a bad model/target pairing is a 400 here too
        runtime_model=payload.get("runtime_model"),
        seed=int(payload.get("seed", 0)),
        window_size=int(window) if window is not None else None,
        # sampled profiles per request: the rate joins the frozen
        # request, so the scheduler's dedup key separates rates
        sampled_rate=float(sampled) if sampled is not None else None,
    )


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-torch-service/1"
    protocol_version = "HTTP/1.1"

    # --- plumbing ----------------------------------------------------------

    @property
    def service(self) -> PredictionService:
        return self.server.service  # type: ignore[attr-defined]

    def _reply(self, code: int, obj: dict, headers: dict | None = None):
        blob = json.dumps(obj, default=float).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(blob)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(blob)

    def log_message(self, fmt, *args):  # quiet unless asked
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # --- endpoints ---------------------------------------------------------

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/stats":
            self._reply(200, self.service.snapshot())
        else:
            self._reply(404, {"error": f"no such endpoint: {self.path}"})

    def do_POST(self):
        if self.path == "/explore":
            self._do_explore()
            return
        if self.path != "/predict":
            self._reply(404, {"error": f"no such endpoint: {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            requested = payload["workload"]
            sizes = payload.get("sizes")
            resolver = self.server.resolver  # type: ignore[attr-defined]
            workload = resolver.get(requested, sizes)
            name = getattr(workload, "workload_name", requested)
            request = build_request(payload, workload)
        except (KeyError, TypeError, ValueError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        try:
            # dedup on the canonical name so an alias coalesces with
            # its canonical spelling
            resp = self.service.predict(
                workload, request, key=(name, sizes, request)
            )
        except ServiceOverloadedError as exc:
            self._reply(503, {"error": str(exc)}, {"Retry-After": "1"})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — surfaced to the client
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, {
            "workload": name,
            "requested": requested,
            "sizes": sizes,
            "cache_model": resp.result.cache_model,
            "trace_id": resp.result.trace_id,
            "predictions": resp.result.to_records(),
            "timing": asdict(resp.timing),
        })

    def _do_explore(self):
        from repro_torch.explore import SearchSpace

        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            requested = payload["workload"]
            sizes = payload.get("sizes")
            resolver = self.server.resolver  # type: ignore[attr-defined]
            workload = resolver.get(requested, sizes)
            name = getattr(workload, "workload_name", requested)
            space = SearchSpace.from_json(payload.get("space") or {})
            kwargs = dict(
                agent=payload.get("agent", "hillclimb"),
                budget=int(payload.get("budget", 256)),
                seed=int(payload.get("seed", 0)),
                mode=payload.get("mode", "throughput"),
                objective=payload.get("objective"),
                inner=payload.get("inner", "vmap"),
                refresh=bool(payload.get("refresh", False)),
            )
        except (KeyError, TypeError, ValueError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        try:
            # unlike /predict this blocks the handler thread for the
            # whole search — the explore lane bounds how many do so
            result = self.service.explore(
                workload, space, workload=name, **kwargs
            )
        except ServiceOverloadedError as exc:
            self._reply(503, {"error": str(exc)}, {"Retry-After": "5"})
            return
        except NotImplementedError as exc:
            self._reply(501, {"error": str(exc)})
            return
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 — surfaced to the client
            self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})
            return
        self._reply(200, result)


class PredictionServer(ThreadingHTTPServer):
    """HTTP server bound to one PredictionService."""

    daemon_threads = True
    # the listen backlog: socketserver's default of 5 resets connections
    # when tens of clients connect at once
    request_queue_size = 256

    def __init__(self, service: PredictionService, host: str = "127.0.0.1",
                 port: int = DEFAULT_PORT, *, verbose: bool = False):
        super().__init__((host, port), _Handler)
        self.service = service
        self.resolver = WorkloadResolver(
            store=getattr(service.session, "store", None)
        )
        self.verbose = verbose

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"

    def serve_background(self) -> threading.Thread:
        """Serve on a daemon thread (tests / selftest); ``shutdown()``
        to stop."""
        t = threading.Thread(
            target=self.serve_forever, name="repro-service-http", daemon=True
        )
        t.start()
        return t
