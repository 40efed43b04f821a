"""CLI for the concurrent prediction service (port of
``repro/service/__main__.py``).

    python -m repro_torch.service                    # serve on :8177
    python -m repro_torch.service --artifact-dir .cache/artifacts
    python -m repro_torch.service --selftest         # in-process smoke
    python -m repro_torch.service --selftest --device cpu

Runs on the card unless ``--device cpu`` is given.  ``--selftest`` is
the gate for the documented entrypoint: it starts the HTTP server on an
ephemeral port, hammers it with concurrent in-process clients
(duplicate payloads included, so coalescing and dedup are exercised),
verifies every response is bit-identical to a sequential
``Session.predict`` of the same request on the same device, prints a
machine-readable summary (service/session/store counters), and exits
non-zero on any mismatch.  With ``--artifact-dir`` the summary's
``session.profile_builds`` shows whether profiles came off the disk
store — a second selftest against a warm store reports zero rebuilds.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

from repro_torch.api import AnalyticalSDCM, Session
from repro_torch.service.client import ServiceClient
from repro_torch.service.server import (
    DEFAULT_PORT,
    PredictionServer,
    build_request,
)
from repro_torch.service.service import PredictionService, ServiceConfig

SELFTEST_PAYLOADS = (
    {"workload": "polybench/atx", "sizes": "smoke",
     "core_counts": [1, 2, 4]},
    # legacy Table-4 alias spelling: must keep resolving
    {"workload": "mvt", "sizes": "smoke", "core_counts": [1, 8],
     "targets": ["i7-5960X"]},
    # duplicate of the first VIA its alias: dedup must coalesce the
    # alias with the canonical spelling
    {"workload": "atx", "sizes": "smoke", "core_counts": [1, 2, 4]},
    # model-derived workload through the TPU VMEM target
    {"workload": "model/llama3_8b/decode", "sizes": "smoke",
     "targets": ["tpu-v5e"], "core_counts": [1]},
)
SELFTEST_CLIENTS = 6


def run_selftest(config: ServiceConfig, host: str = "127.0.0.1",
                 port: int = 0) -> dict:
    """The selftest flow; returns its summary (``"selftest"`` is
    ``"ok"`` or ``"fail"``, with the mismatches under ``"failures"``)."""
    service = PredictionService(config=config)
    failures: list[str] = []
    lock = threading.Lock()

    def run_client(client: ServiceClient) -> None:
        for payload, want in zip(SELFTEST_PAYLOADS, expected):
            try:
                got = client.predict(**payload)
            except Exception as exc:  # noqa: BLE001 — collected
                with lock:
                    failures.append(f"{payload['workload']}: {exc}")
                continue
            if got["predictions"] != want:
                with lock:
                    failures.append(
                        f"{payload['workload']}: response diverged from "
                        "sequential Session.predict"
                    )

    with service:
        server = PredictionServer(service, host, port)

        # reference: a plain sequential Session on the same device with
        # the same cache model — coalescing must not change a single bit
        # of the results.  Sources come from the server's own resolver
        # so the reference and the HTTP path share one object per spec.
        reference = Session(cache_model=AnalyticalSDCM(backend="batched"),
                            device=service.device)
        expected = []
        for payload in SELFTEST_PAYLOADS:
            workload = server.resolver.get(
                payload["workload"], payload.get("sizes")
            )
            request = build_request(payload, workload)
            result = reference.predict(workload, request)
            # through the same JSON float round-trip the HTTP path uses
            expected.append(json.loads(result.to_json())["predictions"])

        server.serve_background()
        try:
            client = ServiceClient(server.url)
            client.wait_ready()
            threads = [
                threading.Thread(target=run_client, args=(client,))
                for _ in range(SELFTEST_CLIENTS)
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            stats = client.stats()
        finally:
            server.shutdown()
            server.server_close()

    return {
        "selftest": "fail" if failures else "ok",
        "device": str(service.device),
        "requests": SELFTEST_CLIENTS * len(SELFTEST_PAYLOADS),
        "failures": failures,
        **stats,
    }


def config_from(args) -> ServiceConfig:
    return ServiceConfig(
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        queue_size=args.queue_size, artifact_dir=args.artifact_dir,
        device=args.device,
    )


def selftest(args) -> int:
    summary = run_selftest(config_from(args), args.host, args.port or 0)
    print(json.dumps(summary, indent=2, default=float))
    if summary["failures"]:
        print(f"SELFTEST FAILED: {len(summary['failures'])} mismatches",
              file=sys.stderr)
        return 1
    return 0


def serve(args) -> int:
    service = PredictionService(config=config_from(args))
    with service:
        server = PredictionServer(
            service, args.host, args.port, verbose=args.verbose
        )
        print(f"prediction service listening on {server.url} "
              f"(device {service.device})")
        print("  try: curl -s -X POST "
              f"{server.url}/predict -d "
              "'{\"workload\": \"polybench/atx\", "
              "\"core_counts\": [1, 4, 8]}'")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.service",
        description="concurrent microbatching prediction service",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--artifact-dir", default=None,
                    help="shared disk ArtifactStore; a warm store means "
                         "zero profile rebuilds in this process")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="coalesced batch budget (flush when reached)")
    ap.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batch collection window past the first request")
    ap.add_argument("--queue-size", type=int, default=256,
                    help="bounded queue depth; beyond it requests are "
                         "shed with ServiceOverloadedError / HTTP 503")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path on the host)")
    ap.add_argument("--selftest", action="store_true",
                    help="start on an ephemeral port, run concurrent "
                         "in-process clients, verify bit-identity vs "
                         "sequential Session.predict, exit")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(args)
    return serve(args)


if __name__ == "__main__":
    raise SystemExit(main())
