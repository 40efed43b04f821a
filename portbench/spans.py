"""What the readers of the program's own spans and counters share.

The program (``repro_torch.runtime.tracing``) keeps its spans and
counters while a profiler runs; they are read here once, after the
window, and only those inside the traced window count.  Every number is
a request's mean (``len(ctx.work)``; in the chat cell a request is a
batch).  A reader returns None where there is nothing to read: a
program without the module, or a window without the span or counter.

* :func:`device_ms`: device time of the kernels that start inside the
  device-side spans of a ``record_function`` range that the program
  names (a kernel belongs to the innermost range it was launched in);
* :func:`idle_ms`: time in which no device operation ran (the window
  less the union of ``ctx.trace.kernels``) while the host was inside
  the program's spans of a name, or outside every one of them;
* :func:`counter_sum`, :func:`counter_mean`: the program's counters.
"""
from __future__ import annotations

import importlib

import numpy as np

from portbench import core
from portbench.trace import _merge

#: Every family's prefill, and the layers inside it.
PREFILL = "model.prefill"

_kept: dict = {"spans": [], "counts": []}


def records() -> dict | None:
    """Every span ``(name, start_ns, end_ns, parent, thread)`` and count
    ``(name, t_ns, value, parent)`` the program has kept so far (taken
    from it and held here, so every reader sees them), or None where the
    program has no such module."""
    core.import_program()
    try:
        tracing = importlib.import_module("repro_torch.runtime.tracing")
    except ImportError:
        return None
    spans, counts = tracing.take()
    _kept["spans"] += spans
    _kept["counts"] += counts
    return _kept


def _rows(intervals) -> np.ndarray:
    return np.array(list(intervals), dtype=np.int64).reshape(-1, 2)


def _measure(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the intersection of two sets of disjoint, sorted
    ``[start, end]`` rows."""
    if not len(a) or not len(b):
        return 0
    lengths = a[:, 1] - a[:, 0]
    before = np.concatenate([[0], np.cumsum(lengths)])

    def upto(t):                                  # |a ∩ (-inf, t]|
        i = np.searchsorted(a[:, 0], t, side="right") - 1
        inside = np.clip(t - a[np.maximum(i, 0), 0], 0,
                         lengths[np.maximum(i, 0)])
        return np.where(i >= 0, before[np.maximum(i, 0)] + inside, 0)

    return int((upto(b[:, 1]) - upto(b[:, 0])).sum())


def _idle(ctx) -> np.ndarray:
    """The window's idle intervals: the window less the union of every
    device operation."""
    w0, w1 = ctx.trace.window
    busy = _merge(_rows((max(s, w0), min(e, w1))
                        for _, s, e in ctx.trace.kernels
                        if e > w0 and s < w1))
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def _host(ctx, name: str) -> np.ndarray | None:
    """The union of the program's spans named ``name``, cut to the
    window, or None where there are none (or no program records)."""
    rec = records()
    if rec is None:
        return None
    w0, w1 = ctx.trace.window
    rows = _rows((max(s, w0), min(e, w1)) for n, s, e, _, _ in rec["spans"]
                 if n == name and e > w0 and s < w1)
    return _merge(rows) if len(rows) else None


def device_ms(ctx, name: str):
    """Device ms a request of the kernels that start inside the
    device-side spans of ``name`` (their union, within the window)."""
    spans = ctx.trace.spans.get(name)
    if not spans or not ctx.work:
        return None
    w0, w1 = ctx.trace.window
    sp = _merge(_rows(spans))
    k = _rows((s, e) for _, s, e in ctx.trace.kernels)
    i = np.searchsorted(sp[:, 0], k[:, 0], side="right") - 1
    inside = (i >= 0) & (k[:, 0] < sp[np.maximum(i, 0), 1])
    k = np.clip(k[inside], w0, w1)
    busy = _merge(k[k[:, 1] > k[:, 0]])
    return float((busy[:, 1] - busy[:, 0]).sum()) / len(ctx.work) / 1e6


def idle_ms(ctx, name: str):
    """Device-idle ms a request while the host is inside the program's
    spans named ``name``."""
    host = _host(ctx, name)
    if host is None or not ctx.work:
        return None
    return _measure(_idle(ctx), host) / len(ctx.work) / 1e6


def edge_idle_ms(ctx):
    """Device-idle ms a request while the host is outside every
    ``model.prefill`` span: the request's edges."""
    host = _host(ctx, PREFILL)
    if host is None or not ctx.work:
        return None
    idle = _idle(ctx)
    total = int((idle[:, 1] - idle[:, 0]).sum())
    return (total - _measure(idle, host)) / len(ctx.work) / 1e6


def _values(ctx, match) -> list | None:
    rec = records()
    if rec is None:
        return None
    w0, w1 = ctx.trace.window
    return [v for n, t, v, _ in rec["counts"] if match(n) and w0 <= t <= w1]


def counter_sum(ctx, prefix: str):
    """The sum a request of the values of the counters whose names
    start with ``prefix``."""
    vals = _values(ctx, lambda n: n.startswith(prefix))
    if not vals or not ctx.work:
        return None
    return sum(vals) / len(ctx.work)


def counter_mean(ctx, name: str):
    """The mean of the values of the counter ``name``."""
    vals = _values(ctx, lambda n: n == name)
    return sum(vals) / len(vals) if vals else None
