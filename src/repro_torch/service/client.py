"""Minimal stdlib client for the prediction service HTTP API (port of
``repro/service/client.py``; it speaks to either package's server).

    from repro_torch.service.client import ServiceClient

    client = ServiceClient("http://127.0.0.1:8177")
    out = client.predict("atx", core_counts=[1, 4, 8])
    for cell in out["predictions"]:
        print(cell["target"], cell["cores"], cell["t_pred_s"])

The client is a thin JSON wrapper — anything that can POST JSON
(curl, requests, a load balancer health check) speaks the same
protocol; the payload schema is in ``repro_torch.service.server``.
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request


class ServiceError(RuntimeError):
    """HTTP-level failure; carries the status code and server message."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServiceClient:
    def __init__(self, base_url: str, *, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _call(self, path: str, payload: dict | None = None) -> dict:
        data = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                message = json.loads(exc.read()).get("error", str(exc))
            except Exception:  # noqa: BLE001 — non-JSON error body
                message = str(exc)
            raise ServiceError(exc.code, message) from exc

    # --- endpoints ---------------------------------------------------------

    def predict(self, workload: str, *, sizes: str | None = None,
                targets=None, core_counts=(1,), strategies=None,
                modes=None, runtime: bool = True, seed: int = 0,
                window_size: int | None = None) -> dict:
        payload: dict = {
            "workload": workload,
            "core_counts": list(core_counts),
            "runtime": runtime,
            "seed": seed,
        }
        if sizes is not None:
            payload["sizes"] = sizes
        if targets is not None:
            payload["targets"] = list(targets)
        if strategies is not None:
            payload["strategies"] = list(strategies)
        if modes is not None:
            payload["modes"] = list(modes)
        if window_size is not None:
            payload["window_size"] = window_size
        return self._call("/predict", payload)

    def explore(self, workload: str, *, sizes: str | None = None,
                space: dict | None = None, agent: str = "hillclimb",
                budget: int = 256, seed: int = 0,
                objective: str | None = None, mode: str | None = None,
                inner: str | None = None, refresh: bool = False) -> dict:
        """Run a config-space search on the server's explore lane.

        Blocks until the search completes (searches are budget-bounded;
        size ``timeout`` accordingly) and returns the full
        ``run_explore`` result dict."""
        payload: dict = {
            "workload": workload,
            "agent": agent,
            "budget": budget,
            "seed": seed,
        }
        if sizes is not None:
            payload["sizes"] = sizes
        if space is not None:
            payload["space"] = space
        if objective is not None:
            payload["objective"] = objective
        if mode is not None:
            payload["mode"] = mode
        if inner is not None:
            payload["inner"] = inner
        if refresh:
            payload["refresh"] = True
        return self._call("/explore", payload)

    def stats(self) -> dict:
        return self._call("/stats")

    def healthz(self) -> dict:
        return self._call("/healthz")

    def wait_ready(self, timeout: float = 10.0) -> None:
        """Poll /healthz until the server answers (startup races)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                self.healthz()
                return
            except (ServiceError, OSError):
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
