"""The program's spans and counters, recorded only while a
``torch.profiler`` session is active.

* :func:`span` (a context manager) and :func:`spanned` (the same around
  a whole function) mark a part of the program.  While a profiler runs,
  the part is a ``record_function`` range, so the profile holds its host
  range and the device-side span of the kernels launched in it, and the
  span is also kept here as ``(name, start_ns, end_ns, parent, thread)``.
  ``parent`` is the index of the enclosing span of the same thread (-1
  for none): remat recomputes layers on autograd's own thread, whose
  spans do not nest in the caller's.
* :func:`count` keeps ``(name, t_ns, value, parent)``: how often a site
  synchronised the host with the device, or what a layer observed.  A
  value may be a 0-dim device tensor, kept as it is: reading it would
  synchronise inside the traced window.
* :func:`take` returns what was kept since the last call and forgets it,
  every value as a Python number (a tensor read then, after the window).

The switch is the profiler itself (``_profiler_enabled``); there is no
flag.  With no profiler a span is one shared no-op context and a count
returns at once: one check each.  The timestamps are ``time.time_ns()``,
the clock of the profiler's host events (epoch nanoseconds), read
inside the ``record_function`` range, so a span lies within its range.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

enabled = torch._C._autograd._profiler_enabled

_NOOP = contextlib.nullcontext()
_local = threading.local()
_spans: list = []       # [name, start_ns, end_ns | None, parent, thread]
_counts: list = []      # [name, t_ns, value, parent]


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "range", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        stack = _stack()
        self.rec = [self.name, time.time_ns(), None,
                    stack[-1] if stack else None, threading.get_ident()]
        _spans.append(self.rec)
        stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        _stack().pop()
        return self.range.__exit__(*exc)


def span(name: str):
    """A context manager: a span named ``name`` while a profiler runs,
    else nothing."""
    return _Span(name) if enabled() else _NOOP


def spanned(name: str):
    """Decorator: every call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value=1) -> None:
    """Keep ``value`` (a number, or a 0-dim tensor read at :func:`take`)
    under ``name`` while a profiler runs."""
    if enabled():
        stack = _stack()
        _counts.append([name, time.time_ns(), value,
                        stack[-1] if stack else None])


def take() -> tuple[list, list]:
    """The spans that have ended and the counts, each a list of tuples
    (``(name, start_ns, end_ns, parent, thread)`` and ``(name, t_ns,
    value, parent)``, ``parent`` an index into the spans returned, -1
    for none), in the order they began; they are forgotten, spans still
    open are kept.  A tensor value is read here (``.item()``)."""
    global _spans, _counts
    spans, counts = _spans, _counts
    _spans = [r for r in spans if r[2] is None]
    _counts = []
    done = [r for r in spans if r[2] is not None]
    index = {id(r): i for i, r in enumerate(done)}

    def parent(rec) -> int:
        return -1 if rec is None else index.get(id(rec), -1)

    return ([(n, s, e, parent(p), t) for n, s, e, p, t in done],
            [(n, t, v.item() if isinstance(v, torch.Tensor) else v,
              parent(p)) for n, t, v, p in counts])
