"""The traced window: ``torch.profiler`` over the window, read from its
raw events in memory (no Chrome trace is written).

What the readers get (:class:`Trace`):

* ``kernels``: every device operation (kernels, copies, sets) as
  ``(name, start_ns, end_ns)``;
* ``spans``: the device-side spans of the ``record_function`` ranges,
  ``{name: [(start_ns, end_ns), ...]}`` in time order;
* ``window``: the host's ``(start_ns, end_ns)`` of the window range;
* ``busy_s``: the union of the device operations' intervals inside the
  window (several streams overlap, so durations are not summed);
* ``breakdown``: the device operations that took most time, and the
  longest idle gaps of the device, each named by the innermost host
  operation that was running at the gap's middle.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

WINDOW = "portbench.window"


@dataclasses.dataclass
class Trace:
    kernels: list
    spans: dict
    window: tuple
    busy_s: float
    breakdown: dict

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def device_s(self, match) -> float:
        """Seconds of device operations whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e9


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a one-item list that
    holds the :class:`Trace` once the block has ended (or None)."""
    out = [None]
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            yield out
    out[0] = read(prof)


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of ``[start, end]`` rows, sorted, as disjoint rows."""
    if not len(intervals):
        return intervals
    iv = intervals[np.argsort(intervals[:, 0])]
    runmax = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > runmax[:-1]
    starts = iv[new, 0]
    ends = runmax[np.r_[np.nonzero(new)[0][1:] - 1, len(iv) - 1]]
    return np.stack([starts, ends], axis=1)


def _annotation(e) -> bool:
    """Whether a raw event is a ``record_function`` range (on the host or
    its span on the device), across torch versions."""
    if hasattr(e, "is_user_annotation"):
        return e.is_user_annotation()
    return "annotation" in e.activity_type()


def read(prof, top: int = 10) -> Trace:
    from torch.autograd import DeviceType

    kernels, spans, host = [], {}, []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if _annotation(e):
                spans.setdefault(name, []).append((s, s + d))
            else:
                kernels.append((name, s, s + d))
        elif name == WINDOW:
            window = (s, s + d)
        else:
            host.append((name, s, s + d))
    if window is None:
        raise RuntimeError("the profiler lost the window's range")
    for v in spans.values():
        v.sort()
    w0, w1 = window
    iv = np.array([(max(s, w0), min(e, w1)) for _, s, e in kernels
                   if e > w0 and s < w1], dtype=np.int64).reshape(-1, 2)
    busy = _merge(iv)
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    return Trace(kernels, spans, window, busy_s,
                 _breakdown(kernels, busy, window, host, top))


def _breakdown(kernels, busy, window, host, top: int) -> dict:
    by_name: dict = {}
    for n, s, e in kernels:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    edges = np.concatenate([[window[0]], busy.reshape(-1), [window[1]]])
    gaps = edges.reshape(-1, 2)                     # [idle start, idle end]
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    gaps = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])][:top]
    hs = np.array([h[1] for h in host], dtype=np.int64)
    he = np.array([h[2] for h in host], dtype=np.int64)
    idle = []
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        label = (host[inside[np.argmax(hs[inside])]][0] if len(inside)
                 else "(no host operation)")
        idle.append([label[:200], float(g1 - g0) / 1e9])
    return {"device_ops": [[n[:200], t / 1e9] for n, t in ops],
            "idle_gaps": idle}
