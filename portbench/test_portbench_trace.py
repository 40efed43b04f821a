"""Reading a trace: the union of device intervals, the idle gaps, the
split of a step by its ranges, and rooflines that a kernel running at
its least time reads as 100 %."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import core, counts, readers
from portbench.run import Context, read_metric
from portbench.trace import Trace, _breakdown, _merge

PEAK = {"bfloat16_flops": 989e12, "bytes_per_s": 3.35e12}


def test_merge_takes_the_union_of_overlapping_intervals():
    iv = np.array([[5, 9], [0, 3], [2, 4], [8, 12], [20, 21]])
    assert _merge(iv).tolist() == [[0, 4], [5, 12], [20, 21]]


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    busy = np.array([[10, 20], [50, 60]])
    host = [("outer", 0, 100), ("aten::item", 25, 45), ("x", 61, 62)]
    out = _breakdown([("k", 10, 20), ("k", 50, 60)], busy, (0, 100), host, 10)
    assert out["device_ops"] == [["k", 20e-9]]
    assert out["idle_gaps"][0] == ["outer", 40e-9]          # 60..100
    assert ["aten::item", 30e-9] in out["idle_gaps"]        # 20..50
    assert ["outer", 10e-9] in out["idle_gaps"]             # 0..10


def _ctx(workload, kernels, spans=None, work=None, window=(0, 10 ** 9)):
    cell = core.find_cell(workload)
    iv = np.array([(s, e) for _, s, e in kernels]).reshape(-1, 2)
    m = _merge(iv)
    busy = float((m[:, 1] - m[:, 0]).sum()) / 1e9 if len(m) else 0.0
    tr = Trace(kernels, spans or {}, window, busy, {})
    return Context(cell, tr, work, 2 ** 30, PEAK)


def test_a_kernel_at_its_least_time_reads_100_percent():
    work = [(1, 4096)] * 3
    cell = core.find_cell("mixtral-8x7b-16l.prefill-long")
    calls = [c for r, s in work for c in counts.family(cell.config)
             .attention_calls(cell.config["sizes"], r, s)]
    least = max(sum(counts.attention_flops(c) for c in calls)
                / PEAK["bfloat16_flops"],
                sum(counts.attention_bytes(c, 2) for c in calls)
                / PEAK["bytes_per_s"])
    ns = int(round(least * 1e9))
    name = "void flash_tc::flash_tc_kernel<128, true>(flash::Params)"
    ctx = _ctx(cell.name, [(name, 0, ns), ("gemm", ns, 2 * ns)], work=work)
    assert readers.roofline(ctx, readers.B4_FWD, "attention", False) == \
        pytest.approx(100.0, rel=1e-6)
    assert readers.roofline(ctx, readers.B5_FWD, "scan", False) is None
    ctx.peak = None
    assert readers.roofline(ctx, readers.B4_FWD, "attention", False) is None


GEMM = ("void (anonymous namespace)::grouped_gemm_kernel<{}>(CUtensorMap, "
        "CUtensorMap, CUtensorMap, int const*, __nv_bfloat16*, int, int, int)")


def test_the_expert_gemms_at_their_least_time_read_100_percent():
    work = [(1, 2048), (4, 512)]
    cell = core.find_cell("mixtral-8x7b-16l.prefill-chat")
    calls = [c for r, s in work for c in counts.family(cell.config)
             .expert_calls(cell.config["sizes"], r, s)]
    assert len(calls) == 2 * 16
    least = max(sum(counts.expert_flops(c) for c in calls)
                / PEAK["bfloat16_flops"],
                sum(counts.expert_bytes(c, 2) for c in calls)
                / PEAK["bytes_per_s"])
    ns = int(round(least * 1e9))
    kern = [(GEMM.format(0), 0, ns // 3), (GEMM.format(1), ns // 3, ns),
            ("void (anonymous namespace)::moe_combine_kernel(x)", ns, 2 * ns)]
    ctx = _ctx(cell.name, kern, work=work)
    got = read_metric("moe_gemm_roofline.prefill", ctx)
    assert got == pytest.approx(100.0, rel=1e-6)
    ctx.trace.kernels = [(n, 2 * s, 2 * e) for n, s, e in kern[:2]]
    assert read_metric("moe_gemm_roofline.prefill", ctx) == pytest.approx(
        50.0, rel=1e-6)
    zamba = _ctx("zamba2-1.2b.prefill-long", kern, work=work)
    assert read_metric("moe_gemm_roofline.prefill", zamba) is None


def test_a_step_splits_into_its_ranges():
    spans = {"train_step.forward": [(0, 100), (1000, 1100)],
             "train_step.optimizer": [(500, 600), (1500, 1600)]}
    kern = [("f", 10, 50), ("b", 150, 350), ("b", 400, 450), ("o", 510, 590),
            ("f", 1010, 1050), ("b", 1200, 1300), ("o", 1520, 1560)]
    ctx = _ctx("zamba2-1.2b.train-4k", kern, spans, work=[(4, 4096)] * 2)
    assert readers.range_ms(ctx, "backward") == pytest.approx(350 / 2 / 1e6)
    assert readers.range_ms(ctx, "optimizer") == pytest.approx(120 / 2 / 1e6)
    ctx.work = [(4, 4096)] * 3
    assert readers.range_ms(ctx, "backward") is None
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 550e-9))


def test_kernel_names_match_their_own_kernel_only():
    names = {
        "void flash_tc::flash_tc_kernel<64, true>(flash::Params)": "b4f",
        "void flash_split::split_kernel<__nv_bfloat16, 64>(x)": "b4f",
        "void flash_bwd_tc::dq_kernel<64>(flash_bwd::Params)": "b4b",
        "void (anonymous namespace)::ssd_scan_kernel<float>(P)": "b5f",
        "void (anonymous namespace)::cb_kernel<__nv_bfloat16>(P)": "b5f",
        "void ssd_bwd::grad_kernel<__nv_bfloat16>(ssd_bwd::P)": "b5b",
        "ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_tn": None,
        GEMM.format(0): "moe", GEMM.format(1): "moe",
        "void (anonymous namespace)::moe_gather_kernel(x)": None,
    }
    pats = {"b4f": readers.B4_FWD, "b4b": readers.B4_BWD,
            "b5f": readers.B5_FWD, "b5b": readers.B5_BWD,
            "moe": readers.MOE_GEMM}
    for name, want in names.items():
        got = [k for k, p in pats.items() if p.search(name)]
        assert got == ([want] if want else []), name
