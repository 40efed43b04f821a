"""The port's HLO readers (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``) on the same HLO text: the programs of
``tests/analysis/``, a hand-written module with every collective, and
the optimized HLO the reference's ``ModelTraceSource.lowered_hlo()``
returns for one architecture of each family, prefill and decode.  Equal
means: parsed computations, cost dicts, ``op_class_mix``, collective
statistics, op histograms and largest buffers equal; traces and their
``info`` bit-identical; VMEM hit rates within 1e-12."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.analysis import buffers as ref_buffers
from repro.analysis import hlo as ref_hlo
from repro.analysis import hlo_cost as ref_cost
from repro.analysis import hlo_trace as ref_trace
from repro.analysis import roofline as ref_roofline
from repro.workloads.model_trace import ModelTraceSource as RefSource

from repro_torch.analysis import buffers, hlo, hlo_cost, hlo_trace, roofline

RATE_TOL = 1e-12

# One architecture of each family (transformer, moe, ssm, hybrid,
# encdec, vlm), prefill and decode.
MODEL_CELLS = [(arch, step) for arch in (
    "llama3-8b", "mixtral-8x7b", "mamba2-780m", "zamba2-1.2b",
    "seamless-m4t-medium", "phi-3-vision-4.2b") for step in
    ("prefill", "decode")]

COLLECTIVES_HLO = """HloModule sharded, num_partitions=8

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(%a, %b)
}

ENTRY %main (p0: f32[128,1024], p1: bf16[64,256]) -> f32[128,1024] {
  %p0 = f32[128,1024]{1,0} parameter(0)
  %p1 = bf16[64,256]{1,0} parameter(1)
  %ar = f32[128,1024]{1,0} all-reduce(%p0), replica_groups=[2,4]<=[8], to_apply=%add
  %ag = bf16[256,256]{1,0} all-gather(%p1), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
  %rs = f32[32,1024]{1,0} reduce-scatter(%p0), replica_groups=[2,4]<=[8], dimensions={0}, to_apply=%add
  %a2a = bf16[64,256]{1,0} all-to-all(%p1), replica_groups={{0,1},{2,3},{4,5},{6,7}}, dimensions={0}
  %cp = f32[128,1024]{1,0} collective-permute(%p0), source_target_pairs={{0,1},{1,0}}
  %ags = (bf16[64,256]{1,0}, bf16[512,256]{1,0}) all-gather-start(%p1), replica_groups=[1,8]<=[8], dimensions={0}
  %agd = bf16[512,256]{1,0} all-gather-done(%ags)
  %cv = f32[64,256]{1,0} convert(%p1)
  %ars = (f32[128,1024]{1,0}, f32[64,256]{1,0}) all-reduce-start(%p0, %cv), replica_groups=[2,4]<=[8], to_apply=%add
  %ard = (f32[128,1024]{1,0}, f32[64,256]{1,0}) all-reduce-done(%ars)
  ROOT %out = f32[128,1024]{1,0} add(%ar, %cp)
}
"""

TUPLE_HLO = """
%comp (p: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %p = (s32[], f32[8,8]{1,0}) parameter(0)
  %g = f32[8,8]{1,0} get-tuple-element(%p), index=1
  %d = f32[8,8]{1,0} dot(%g, %g), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  ROOT %t = (s32[], f32[8,8]{1,0}, /*index=2*/f32[8,8]{1,0}) tuple(%g, %d, %d)
}
"""


def _compiled(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def _scan(n, trips, body=lambda x: jnp.tanh(x @ x)):
    def f(x):
        y, _ = jax.lax.scan(lambda c, _: (body(c), None), x, None,
                            length=trips)
        return y.sum()
    return _compiled(f, jnp.ones((n, n), jnp.float32))


def _nested_scan():
    def outer(x, _):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=5)
        return y, None

    def f(x):
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y.sum()
    return _compiled(f, jnp.ones((64, 64), jnp.float32))


def _fused_dus():
    def f(big, upd):
        def body(c, i):
            return jax.lax.dynamic_update_slice_in_dim(c, upd, i, 0), None
        out, _ = jax.lax.scan(body, big, jnp.arange(64))
        return out.sum()
    return _compiled(f, jnp.zeros((512, 1024), jnp.float32),
                     jnp.ones((1, 1024), jnp.float32))


def _bf16_program():
    """bf16 operands on ``xla:cpu``: converts and convert fusions."""
    def f(a, b):
        return jnp.tanh(a @ b).astype(jnp.bfloat16) * 2
    return _compiled(f, jnp.ones((256, 512), jnp.bfloat16),
                     jnp.ones((512, 256), jnp.bfloat16))


HAND_PROGRAMS = {
    "scan_trips": lambda: _scan(128, 12),
    "nested_scan": _nested_scan,
    "dot_contracting": lambda: _compiled(
        lambda x, y: x @ y, jnp.ones((32, 48), jnp.float32),
        jnp.ones((48, 16), jnp.float32)),
    "elementwise": lambda: _compiled(
        lambda x: (x * 2 + 1).sum(), jnp.ones((1024, 1024), jnp.float32)),
    "fused_dus": _fused_dus,
    "trace_roundtrip": lambda: _scan(256, 6),
    "refined_memory": lambda: _scan(128, 8),
    "bf16_converts": _bf16_program,
    "collectives": lambda: COLLECTIVES_HLO,
    "tuple_parser": lambda: TUPLE_HLO,
}


@pytest.fixture(scope="module")
def texts():
    """HLO text per case, each compiled or lowered once per module."""
    cache: dict = {}

    def get(case):
        if case not in cache:
            if isinstance(case, tuple):
                cache[case] = RefSource(*case).lowered_hlo()
            else:
                cache[case] = HAND_PROGRAMS[case]()
        return cache[case]
    return get


CASES = list(HAND_PROGRAMS) + MODEL_CELLS


def _ids(case):
    return case if isinstance(case, str) else "/".join(case)


def _computations(comps) -> dict:
    return {name: ([vars(i) for i in c.instrs], dict(c.shapes))
            for name, c in comps.items()}


def _trace_fields(t):
    return (t.addresses, t.bb_ids, t.shared_mask, t.inst_ids)


def _assert_traces_equal(got, want):
    (tg, ig), (tw, iw) = got, want
    for a, b in zip(_trace_fields(tg), _trace_fields(tw)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tg.bb_names == tw.bb_names
    assert ig == iw


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cost_readers_equal_reference(texts, case):
    txt = texts(case)
    assert _computations(hlo_cost.parse_computations(txt)) == \
        _computations(ref_cost.parse_computations(txt))
    model, ref = hlo_cost.HloCostModel(txt), ref_cost.HloCostModel(txt)
    assert (model.entry, model.num_partitions) == \
        (ref.entry, ref.num_partitions)
    cost = hlo_cost.loop_aware_cost(txt)
    assert cost == ref_cost.loop_aware_cost(txt)
    assert model.entry_cost().as_dict() == cost
    for elem in (2.0, 8.0):
        assert hlo_cost.op_class_mix(cost, elem_bytes=elem) == \
            ref_cost.op_class_mix(cost, elem_bytes=elem)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_collective_and_buffer_readers_equal_reference(texts, case):
    txt = texts(case)
    assert hlo.num_partitions(txt) == ref_hlo.num_partitions(txt)
    assert hlo.collective_stats(txt).as_dict() == \
        ref_hlo.collective_stats(txt).as_dict()
    assert hlo.collective_summary(txt) == ref_hlo.collective_summary(txt)
    assert hlo.op_histogram(txt) == ref_hlo.op_histogram(txt)
    for top, min_bytes in ((8, 0), (20, 64 * 2**20), (50, 4096)):
        got = buffers.largest_buffers(txt, top=top, min_bytes=min_bytes)
        want = ref_buffers.largest_buffers(txt, top=top,
                                           min_bytes=min_bytes)
        assert [dataclasses.astuple(b) for b in got] == \
            [dataclasses.astuple(b) for b in want]
        assert buffers.format_buffers(got) == ref_buffers.format_buffers(want)
    for min_bytes in (0, 8 * 2**20):
        assert buffers.bf16_legalization_overhead(txt, min_bytes) == \
            ref_buffers.bf16_legalization_overhead(txt, min_bytes)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_trace_reader_equal_reference(texts, case):
    txt = texts(case)
    for kw in (dict(), dict(loop_cap=1), dict(loop_cap=3, refs_cap=4),
               dict(granule=256, max_refs=2_000)):
        _assert_traces_equal(hlo_trace.hlo_to_trace(txt, **kw),
                             ref_trace.hlo_to_trace(txt, **kw))
    trace, info = hlo_trace.hlo_to_trace(txt)
    ref, _ = ref_trace.hlo_to_trace(txt)
    if len(trace):
        rate = hlo_trace.vmem_hit_rate(trace, device="cpu")
        assert abs(rate - ref_trace.vmem_hit_rate(ref)) <= RATE_TOL
        got = hlo_trace.refined_memory_term(info["touched_bytes"], trace,
                                            device="cpu")
        want = ref_trace.refined_memory_term(info["touched_bytes"], ref)
        assert got.keys() == want.keys()
        for k in got:
            assert abs(got[k] - want[k]) <= RATE_TOL * max(1.0, abs(want[k]))


def test_hand_programs_keep_their_reference_properties(texts):
    """The properties ``tests/analysis/`` holds the reference to, held
    by the port's readers on the same programs."""
    cost = hlo_cost.loop_aware_cost(texts("scan_trips"))
    assert cost["flops"] == pytest.approx(12 * 2 * 128 ** 3, rel=0.05)
    cost = hlo_cost.loop_aware_cost(texts("nested_scan"))
    assert cost["flops"] == pytest.approx(15 * 2 * 64 ** 3, rel=0.05)
    cost = hlo_cost.loop_aware_cost(texts("dot_contracting"))
    assert cost["flops"] == pytest.approx(2 * 32 * 48 * 16, rel=0.02)
    assert hlo_cost.loop_aware_cost(texts("fused_dus"))["bytes"] < 64 * 2**20
    comps = hlo_cost.parse_computations(texts("tuple_parser"))
    assert {"dot", "tuple"} <= {i.op for i in comps["comp"].instrs}
    stats = hlo.collective_stats(texts("collectives"))
    assert hlo.num_partitions(texts("collectives")) == 8
    assert set(stats.counts) == {"all-reduce", "all-gather",
                                 "reduce-scatter", "all-to-all",
                                 "collective-permute"}
    trace, info = hlo_trace.hlo_to_trace(texts("trace_roundtrip"),
                                         loop_cap=2)
    assert info["loop_scale"] >= 3.0
    assert hlo_trace.vmem_hit_rate(trace, device="cpu") > 0.5
    assert buffers.bf16_legalization_overhead(texts("bf16_converts"),
                                              min_bytes=0) > 0


def test_roofline_equal_reference():
    from repro.configs import SHAPES as REF_SHAPES

    from repro_torch.configs import SHAPES

    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in REF_SHAPES.items()}
    kw = dict(arch="a", shape="train_4k", mesh="pod", kind="train",
              compute_s=1.0, memory_s=0.5, collective_s=0.25,
              model_flops_chip=197e12 * 0.8, hlo_flops_chip=197e12,
              chips=256, useful_bytes_chip=3e11)
    rows, ref_rows = [], []
    for over in ({}, {"memory_s": 2.0}, {"collective_s": 3.0},
                 {"shape": "decode_32k", "kind": "decode"}):
        r = roofline.Roofline(**{**kw, **over})
        q = ref_roofline.Roofline(**{**kw, **over})
        assert r.row() == q.row()
        assert (r.useful_compute_s, r.memory_fraction) == \
            (q.useful_compute_s, q.memory_fraction)
        rows.append(r)
        ref_rows.append(q)
    assert roofline.format_table(rows) == ref_roofline.format_table(ref_rows)
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(kind, 8e9, 4096, 256) == \
            ref_roofline.model_flops(kind, 8e9, 4096, 256)
    rec = {"arch": "llama3-8b", "shape": "prefill_32k", "mesh": "multipod",
           "kind": "prefill", "active_param_count": 8_030_261_248,
           "cost": {"flops": 3.1e15, "bytes accessed": 2.2e12},
           "collectives": {"ici_bytes": 4.5e10}}
    assert roofline.from_record(rec).row() == \
        ref_roofline.from_record(rec).row()
