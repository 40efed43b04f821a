"""Reading the program's spans and counters against a trace: device time
by layer, idle time by where the host was, and the counters, each a
request's mean, on synthetic traces and records."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import core, spans
from portbench.run import Context, read_metric
from portbench.trace import Trace, _merge

WINDOW = (1000, 2000)
#: The readers of the program's spans and counters.
NEW = ("attention_ms.prefill", "moe_ms.prefill", "mamba2_ms.prefill",
       "attention_idle_ms.prefill", "moe_idle_ms.prefill",
       "mamba2_idle_ms.prefill", "edge_idle_ms.prefill",
       "host_syncs.prefill", "expert_load.prefill")


def _ctx(workload, kernels, device_spans=None, requests=2):
    iv = np.array([(s, e) for _, s, e in kernels]).reshape(-1, 2)
    m = _merge(iv)
    busy = float((m[:, 1] - m[:, 0]).sum()) / 1e9 if len(m) else 0.0
    tr = Trace(kernels, device_spans or {}, WINDOW, busy, {})
    return Context(core.find_cell(workload), tr, [(1, 64)] * requests,
                   2 ** 30, None)


@pytest.fixture
def program(monkeypatch):
    """Install synthetic program records: ``program(spans, counts)``."""
    def install(sp, counts=()):
        rec = {"spans": [(n, s, e, -1, 1) for n, s, e in sp],
               "counts": [(n, t, v, -1) for n, t, v in counts]}
        monkeypatch.setattr(spans, "records", lambda: rec)
    return install


# kernels: busy 1100-1200, 1300-1400, 1500-1600, 1700-1750 (+ one before
# the window); idle 1000-1100, 1200-1300, 1400-1500, 1600-1700, 1750-2000
KERNELS = [("k", 900, 990), ("a1", 1100, 1150), ("a2", 1150, 1200),
           ("m", 1300, 1400), ("a3", 1500, 1600), ("head", 1700, 1750)]


def test_device_time_of_the_kernels_inside_a_layers_device_spans():
    ctx = _ctx("mixtral-8x7b-16l.prefill-long", KERNELS, {
        "layer.attention": [(1100, 1200), (1500, 1600)],
        "layer.moe": [(1300, 1400)]})
    assert spans.device_ms(ctx, "layer.attention") == pytest.approx(
        200 / 2 / 1e6)
    assert spans.device_ms(ctx, "layer.moe") == pytest.approx(100 / 2 / 1e6)
    assert spans.device_ms(ctx, "layer.mamba2") is None
    # two streams overlapping inside one span count once
    ctx.trace.kernels = KERNELS + [("a4", 1120, 1180)]
    assert spans.device_ms(ctx, "layer.attention") == pytest.approx(
        200 / 2 / 1e6)


def test_idle_time_by_where_the_host_was(program):
    """Layer spans nested in the prefill's; a gap that straddles a span's
    edge counts only its part inside; records outside the window are
    ignored; the layers and the edges together are at most the idle."""
    program([
        ("model.prefill", 1050, 1760),
        ("layer.attention", 1080, 1150),    # gap 1000-1100: 20 inside
        ("layer.moe", 1250, 1450),          # gaps 1250-1300, 1400-1450
        ("layer.attention", 1480, 1520),    # gap 1400-1500: 20 inside
        ("layer.attention", 1490, 1510),    # nested in the one above
        ("layer.attention", 500, 800),      # before the window
        ("model.prefill", 2100, 2300),      # after it
    ])
    ctx = _ctx("mixtral-8x7b-16l.prefill-long", KERNELS)
    att = spans.idle_ms(ctx, "layer.attention")
    moe = spans.idle_ms(ctx, "layer.moe")
    edge = spans.edge_idle_ms(ctx)
    assert att == pytest.approx(40 / 2 / 1e6)
    assert moe == pytest.approx(100 / 2 / 1e6)
    # outside 1050-1760: 1000-1050 and 1760-2000 are idle
    assert edge == pytest.approx(290 / 2 / 1e6)
    assert spans.idle_ms(ctx, "layer.mamba2") is None
    idle = (ctx.trace.window_s - ctx.trace.busy_s) * 1e3 / 2
    assert att + moe + edge <= idle


def test_a_span_straddling_the_window_is_cut_to_it(program):
    program([("model.prefill", 900, 1050), ("model.prefill", 1950, 2100)])
    ctx = _ctx("zamba2-1.2b.prefill-long", KERNELS)
    # idle outside the two cut spans: 1050-1100, 1200-1300, 1400-1500,
    # 1600-1700, 1750-1950
    assert spans.edge_idle_ms(ctx) == pytest.approx(550 / 2 / 1e6)


def test_counters_a_request_in_the_window(program):
    program([], [("host_sync.rope_freqs", 1100, 1), ("host_sync.moe_counts",
                                                     1200, 3),
                 ("host_sync.rope_freqs", 2500, 1), ("moe.expert_load",
                                                     1300, 1.5),
                 ("moe.expert_load", 1400, 1.25), ("moe.expert_load", 10, 9)])
    ctx = _ctx("mixtral-8x7b-16l.prefill-chat", KERNELS)
    assert spans.counter_sum(ctx, "host_sync.") == pytest.approx(4 / 2)
    assert spans.counter_mean(ctx, "moe.expert_load") == pytest.approx(1.375)
    assert spans.counter_mean(ctx, "moe.other") is None


def test_without_the_programs_records_every_reader_finds_nothing(
        monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: None)
    for cell in ("mixtral-8x7b-16l.prefill-long", "zamba2-1.2b.prefill-long"):
        ctx = _ctx(cell, KERNELS)
        for m in core.find_cell(cell).per_layer:
            if m["name"] in NEW:
                assert read_metric(m["name"], ctx) is None, m["name"]


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_its_layer(program, metric):
    program([("model.prefill", 1050, 1760), ("layer.attention", 1080, 1150),
             ("layer.moe", 1250, 1450), ("layer.mamba2", 1600, 1700)],
            [("host_sync.moe_counts", 1260, 3), ("moe.expert_load", 1270, 2)])
    ctx = _ctx("mixtral-8x7b-16l.prefill-long", KERNELS, {
        "layer.attention": [(1100, 1200)], "layer.moe": [(1300, 1400)],
        "layer.mamba2": [(1500, 1600)]})
    want = {"attention_ms.prefill": 100 / 2e6, "moe_ms.prefill": 100 / 2e6,
            "mamba2_ms.prefill": 100 / 2e6,
            "attention_idle_ms.prefill": 20 / 2e6,
            "moe_idle_ms.prefill": 100 / 2e6,
            "mamba2_idle_ms.prefill": 100 / 2e6,
            "edge_idle_ms.prefill": 290 / 2e6,
            "host_syncs.prefill": 1.5, "expert_load.prefill": 2.0}
    assert read_metric(metric, ctx) == pytest.approx(want[metric])


def test_the_programs_records_reach_the_readers():
    """The records come from the program's own module, once, and stay
    for every reader of the run."""
    from repro_torch.runtime import tracing
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("model.prefill"):
            tracing.count("host_sync.rope_freqs", 1)
    rec = spans.records()
    assert rec is not None
    assert any(r[0] == "model.prefill" for r in rec["spans"])
    assert spans.records() is rec and tracing.take() == ([], [])
