"""The port's spans and counters (``repro_torch.runtime.tracing``): off
without a profiler, on the profiler's clock with one, nested per
thread, and at the prefill path's layer boundaries."""
from __future__ import annotations

import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.reduced import reduced_arch
from repro_torch.launch import serve
from repro_torch.runtime import tracing

LAYERS = ("layer.attention", "layer.moe", "layer.mamba2")


@pytest.fixture(autouse=True)
def _empty():
    tracing.take()
    yield
    tracing.take()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_enters_no_range_and_records_nothing(monkeypatch):
    def no_range(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not tracing.enabled()

    @tracing.spanned("f")
    def f(x):
        return x + 1

    with tracing.span("a"):
        tracing.count("c", 5)
        assert f(1) == 2
    assert tracing.span("a") is tracing.span("b")   # one shared no-op
    assert tracing.take() == ([], [])


def test_counters_record_only_while_on():
    tracing.count("c", 2)
    with _cpu_profile():
        tracing.count("c", 3)
        with tracing.span("s"):
            tracing.count("d")
    tracing.count("c", 4)
    spans, counts = tracing.take()
    assert [(n, v, p) for n, _, v, p in counts] == [("c", 3, -1),
                                                    ("d", 1, 0)]
    assert spans[0][0] == "s" and spans[0][1] <= counts[1][1] <= spans[0][2]


def _host_events(prof) -> dict:
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def test_spans_are_the_profilers_ranges_on_its_clock():
    """Each span is a host range of the profiler with the same name and
    nesting; it lies inside its range, and its start and end are within
    50 us of the range's (the median over 100 spans: the clocks agree)."""
    x = torch.randn(32, 32)

    @tracing.spanned("t.inner")
    def inner():
        return x @ x

    def step():
        with tracing.span("t.outer"):
            inner()

    with _cpu_profile():
        step()                                       # warm up
    tracing.take()
    with _cpu_profile() as prof:
        for _ in range(100):
            step()
    spans, _ = tracing.take()
    events = _host_events(prof)
    slack = 50_000
    for name in ("t.outer", "t.inner"):
        mine = [(s, e) for n, s, e, _, _ in spans if n == name]
        theirs = events[name]
        assert len(mine) == len(theirs) == 100
        starts, ends = [], []
        for (s, e), (a, b) in zip(mine, theirs):
            assert a - slack <= s <= e <= b + slack
            starts.append(abs(s - a))
            ends.append(abs(b - e))
        assert statistics.median(starts) <= slack
        assert statistics.median(ends) <= slack
    outer = {i for i, r in enumerate(spans) if r[0] == "t.outer"}
    for n, s, e, parent, _ in spans:
        if n == "t.inner":
            assert parent in outer
            assert spans[parent][1] <= s <= e <= spans[parent][2]
    # the profiler nests them alike
    for (a, b), (c, d) in zip(events["t.outer"], events["t.inner"]):
        assert a <= c <= d <= b


def test_each_thread_keeps_its_own_parent_chain(monkeypatch):
    """A span entered on another thread (autograd's, which recomputes
    remat'ed layers) does not take the caller's open span as parent."""
    monkeypatch.setattr(tracing, "enabled", lambda: True)

    def worker():
        with tracing.span("w.outer"):
            with tracing.span("w.inner"):
                tracing.count("w.count")

    with tracing.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        tracing.count("main.count")
    spans, counts = tracing.take()
    idx = {r[0]: i for i, r in enumerate(spans)}
    assert spans[idx["main"]][3] == -1
    assert spans[idx["w.outer"]][3] == -1
    assert spans[idx["w.inner"]][3] == idx["w.outer"]
    assert spans[idx["w.outer"]][4] != spans[idx["main"]][4]
    assert spans[idx["w.inner"]][4] == spans[idx["w.outer"]][4]
    assert dict((n, p) for n, _, _, p in counts) == {
        "w.count": idx["w.inner"], "main.count": idx["main"]}


def test_take_keeps_the_spans_still_open():
    with _cpu_profile():
        with tracing.span("open"):
            with tracing.span("done"):
                pass
            first, _ = tracing.take()
        second, _ = tracing.take()
    assert [(r[0], r[3]) for r in first] == [("done", -1)]
    assert [(r[0], r[3]) for r in second] == [("open", -1)]


def _prefill(arch: str, length: int = 24, rows: int = 2):
    spec = reduced_arch(arch)
    cfg = spec.config
    model = spec.family.init(cfg, device="cpu", seed=0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (rows, length))
    caches = serve.new_caches(spec, cfg, rows, length + 1, {}, device="cpu")
    with _cpu_profile():
        spec.family.prefill(model, serve.prefill_batch(cfg, tokens, {}, "cpu"),
                            cfg, caches)
    return cfg, tracing.take()


def _in_one_prefill(spans) -> dict:
    """Spans by name, after checking that every layer span's chain of
    parents reaches the one ``model.prefill`` span."""
    roots = [i for i, r in enumerate(spans) if r[0] == "model.prefill"]
    assert len(roots) == 1 and spans[roots[0]][3] == -1
    for r in spans:
        if r[0] in LAYERS:
            p = r[3]
            while p != -1 and p != roots[0]:
                p = spans[p][3]
            assert p == roots[0], r
    by: dict = {}
    for r in spans:
        by[r[0]] = by.get(r[0], 0) + 1
    return by


def test_a_mixtral_prefill_spans_each_attention_call_and_moe_layer():
    cfg, (spans, counts) = _prefill("mixtral-8x7b")
    by = _in_one_prefill(spans)
    assert by == {"model.prefill": 1, "layer.attention": cfg.layers,
                  "layer.moe": cfg.layers}
    names = [c[0] for c in counts]
    # q and k each take RoPE; on the CPU nothing synchronises
    assert names.count("host_sync.rope_freqs") == 2 * cfg.layers
    assert names.count("host_sync.moe_counts") == cfg.layers
    assert all(c[2] == 0 for c in counts if c[0].startswith("host_sync."))
    load = [c[2] for c in counts if c[0] == "moe.expert_load"]
    assert len(load) == cfg.layers
    assert all(1.0 <= v <= cfg.moe.num_experts for v in load)


def test_a_zamba2_prefill_spans_each_attention_call_and_mamba2_layer():
    cfg, (spans, counts) = _prefill("zamba2-1.2b")
    by = _in_one_prefill(spans)
    assert by == {"model.prefill": 1, "layer.attention": cfg.num_groups,
                  "layer.mamba2": cfg.layers}
    assert [c[0] for c in counts] == ["host_sync.rope_freqs"] * (
        2 * cfg.num_groups)


def test_a_train_step_keeps_its_ranges_and_spans_the_remat_recompute():
    """``train_step.RANGES`` go through the same spans; remat's recompute
    of each Mamba2 layer is a second ``layer.mamba2`` span, inside the
    backward's (on the CPU the backward runs on the caller's thread)."""
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train.train_step import (
        RANGES, build_train_step, init_state,
    )

    spec = reduced_arch("zamba2-1.2b")
    cfg = spec.config
    model = spec.family.init(cfg, device="cpu", seed=0)
    step = build_train_step(lambda m, b: spec.family.loss_fn(m, b, cfg),
                            make_optimizer(spec, 10))
    tok = torch.randint(0, cfg.vocab, (2, 16))
    state = init_state(model, make_optimizer(spec, 10))
    with _cpu_profile() as prof:
        step(state, {"tokens": tok, "labels": tok})
    spans, _ = tracing.take()
    names = [r[0] for r in spans]
    assert [n for n in names if n.startswith("train_step.")] == list(RANGES)
    assert set(RANGES) <= set(_host_events(prof))
    mamba = [r for r in spans if r[0] == "layer.mamba2"]
    assert len(mamba) == 2 * cfg.layers
    parents = {spans[r[3]][0] for r in mamba}
    assert parents == {RANGES[0], RANGES[1]}
