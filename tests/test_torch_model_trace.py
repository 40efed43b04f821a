"""``model/<arch>/{prefill,decode,train}`` cells of the port against the
JAX package's: the parity contract of the port's graph source
(``repro_torch.analysis.aten_trace``) and the source's registry, store
and Session integration.  The ``train`` cells of four architectures
(dense, MoE, hybrid, SSM) hold the port's recording of the loss and its
gradient against the reference's lowered ``jax.value_and_grad``.

The reference's trace is the optimized HLO of the step as ``xla:cpu``
compiles it (fused, bf16 legalized to f32, the layers a ``while`` loop
over stacked weights, read by ``hlo_to_trace`` with the loop body
emitted twice); the port's is ATen's unfused plain path with the layers
unrolled.  The two programs are not the same, so the contract is written
per cell, with a cause for each bound (:data:`CONTRACT`):

* determinism: two processes give one declared fingerprint and
  bit-identical traces, with shared and private references;
* matmul FLOPs (``dominant_flop_ops["dot"]``), touched bytes and the
  number of references, as port / reference ratios within the cell's
  bounds;
* hit rates on ``tpu-v5e``'s VMEM and the Table-5 CPUs at cores 1 and
  4 (the port's Session on every trace), level by level: the port's
  rate lies within 0.05 of the range the reference's rate spans when
  its two named program differences are undone in the reading of its
  own HLO (:func:`_reference_reading`), one at a time and together:

  - loop-body buffer reuse: ``hlo_to_trace`` names a ``while`` body's
    buffers by instruction, so the second layer re-touches the first
    layer's lines, where the port's unrolled layers touch fresh
    buffers; undone by naming the body's buffers per iteration;
  - ``xla:cpu``'s bf16 legalization: the step's bf16 weights and
    activations are converted to f32 copies (``convert`` and
    convert-only fusions), which write and read lines the port's bf16
    program never touches; undone by reading each such copy as its bf16
    operand.

  Each level's cause is the span of those four readings at that level,
  and its gap to the reference is at most that span plus 0.05.

The bounds are set by cell class from the causes, not per cell from the
readings."""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis.hlo_cost import loop_aware_cost as ref_cost
from repro.analysis.hlo_trace import hlo_to_trace as ref_hlo_to_trace
from repro.workloads import model_trace as ref_model_trace
from repro.workloads import registry as ref_registry
from repro.workloads.model_trace import ModelTraceSource as RefSource

from repro_torch.analysis import aten_trace
from repro_torch.analysis.hlo_cost import (
    HloCostModel, _BODY_RE, _OPERANDS_RE, _TRIP_RE, _shape_elems_bytes,
)
from repro_torch.analysis.hlo_trace import _TraceState
from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
from repro_torch.core.trace.types import LabeledTrace, trace_from_blocks
from repro_torch.validate.store import ArtifactStore
from repro_torch.workloads import model_trace
from repro_torch.workloads import registry
from repro_torch.workloads.model_trace import ModelTraceSource, arch_slug

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TABLE5 = ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P")
VMEM = ("tpu-v5e", 1, "VMEM")
UNNAMED = 0.05       # what a gap may hold beyond its named cause
RATE_TOL = 1e-6      # the port's predict vs the float64 oracle
#: The reference's readings besides the one as compiled: each program
#: difference undone, then both (:func:`_reference_reading`).
READINGS = (
    (("fresh_body", True),),
    (("legalized", False),),
    (("fresh_body", True), ("legalized", False)),
)


@dataclass(frozen=True)
class Bound:
    lo: float
    hi: float
    cause: str


@dataclass(frozen=True)
class CellClass:
    dot: Bound
    touched: Bound
    refs: Bound


_SAME_DOTS = Bound(0.999, 1.001, "the same matmuls, counted exactly in "
                   "both graphs (2 x result x contracted extent)")
_WEIGHT_READS = (
    "weights dominate a decode step: the reference reads each stacked "
    "[L, ...] weight whole as the operand of every layer's dynamic-slice "
    "and writes and reads an f32 copy of it (xla:cpu's bf16 "
    "legalization); the port reads each layer's bf16 weights once.  Both "
    "read the whole KV cache (the plain attention masks all max_len "
    "positions, as the reference's decode does)")
_UNFUSED = (
    "ATen writes and reads a buffer per unfused op, XLA's fused program "
    "fewer; the reference adds its f32 weight copies and whole-stack "
    "slice reads")
_ROUTED = ("routed tokens only: the port runs each expert on the tokens "
           "routed to it, with no one-hot dispatch/combine einsums over "
           "[groups, tokens, experts, capacity] and no capacity-padded "
           "expert slots")
_CHUNK = ("B5's chunk of 64 pads the 32-step prompt to 64 and forms "
          "64 x 64 intra-chunk products and decay matrices, where the "
          "reference's reduced chunk of 8 forms four 8 x 8 blocks")

DENSE_PREFILL = CellClass(
    _SAME_DOTS,
    Bound(0.6, 1.2, _UNFUSED),
    Bound(0.8, 1.5, "more unfused ops, so more buffers of up to "
          "refs_cap references each"))
DENSE_DECODE = CellClass(
    _SAME_DOTS,
    Bound(0.15, 0.5, _WEIGHT_READS),
    Bound(0.4, 0.8, "decode buffers are a few lines each, so references "
          "follow touched lines: " + _WEIGHT_READS))
MOE_PREFILL = CellClass(
    Bound(0.3, 0.8, _ROUTED),
    Bound(0.25, 0.7, _UNFUSED + "; and " + _ROUTED),
    Bound(1.0, 1.6, "the port's per-expert gather, products and "
          "index_add_ are unfused ops of their own"))
MOE_DECODE = CellClass(
    Bound(0.2, 0.6, _ROUTED),
    Bound(0.08, 0.3, _WEIGHT_READS + "; and " + _ROUTED),
    Bound(0.4, 0.8, "references follow touched lines (see bytes)"))
SSD_PREFILL = CellClass(
    Bound(1.3, 2.5, _CHUNK),
    Bound(1.5, 3.5, _CHUNK + "; and the reference's trace emits 2 of its "
          "4 chunk-loop trips (loop_scale 2)"),
    Bound(0.8, 1.5, "more unfused ops; fewer refs for the reference's "
          "capped chunk loop"))
SSD_DECODE = CellClass(
    _SAME_DOTS,
    Bound(0.2, 0.6, _WEIGHT_READS),
    Bound(0.4, 0.8, "references follow touched lines (see bytes)"))

_B4_BACKWARD = ("B4's closed-form backward forms Q K^T again to rebuild "
                "P: one attention product a layer more than the "
                "reference's autodiff")
DENSE_TRAIN = CellClass(
    Bound(1.0, 1.05, "the same model matmuls, plus one: " + _B4_BACKWARD),
    Bound(0.85, 1.1, "a training step's activations, gradients and remat "
          "recomputation weigh most in both programs; ATen's unfused "
          "buffers and the reference's f32 weight copies come near to "
          "cancelling"),
    Bound(0.95, 1.15, "references follow touched lines (see bytes)"))
MOE_TRAIN = CellClass(
    Bound(0.75, 0.9, _ROUTED + " (their gradients too)"),
    Bound(0.7, 0.95, _ROUTED + " (their gradients too)"),
    Bound(1.3, 1.9, "the port's per-expert gather, products and "
          "index_add_, and their gradients, are unfused ops of their own"))
SSD_TRAIN = CellClass(
    Bound(1.25, 1.55, _CHUNK + ", in the forward, its recomputation and "
          "the backward alike"),
    Bound(1.25, 1.8, _CHUNK + ", three times a layer"),
    Bound(0.95, 1.25, "more unfused ops; fewer refs for the reference's "
          "capped chunk loop"))

#: The 24 cells and the class whose bounds hold each.
CONTRACT = {
    "arctic-480b/prefill": MOE_PREFILL,
    "arctic-480b/decode": MOE_DECODE,
    "codeqwen1.5-7b/prefill": DENSE_PREFILL,
    "codeqwen1.5-7b/decode": DENSE_DECODE,
    "deepseek-67b/prefill": DENSE_PREFILL,
    "deepseek-67b/decode": DENSE_DECODE,
    "llama3-8b/prefill": DENSE_PREFILL,
    "llama3-8b/decode": DENSE_DECODE,
    "mamba2-780m/prefill": SSD_PREFILL,
    "mamba2-780m/decode": SSD_DECODE,
    "mixtral-8x7b/prefill": MOE_PREFILL,
    "mixtral-8x7b/decode": MOE_DECODE,
    "phi-3-vision-4.2b/prefill": DENSE_PREFILL,   # vlm
    "phi-3-vision-4.2b/decode": DENSE_DECODE,
    "seamless-m4t-medium/prefill": DENSE_PREFILL,  # encdec
    "seamless-m4t-medium/decode": DENSE_DECODE,
    "yi-34b/prefill": DENSE_PREFILL,
    "yi-34b/decode": DENSE_DECODE,
    "zamba2-1.2b/prefill": SSD_PREFILL,           # hybrid
    "zamba2-1.2b/decode": SSD_DECODE,
    "llama3-8b/train": DENSE_TRAIN,
    "mixtral-8x7b/train": MOE_TRAIN,
    "mamba2-780m/train": SSD_TRAIN,
    "zamba2-1.2b/train": SSD_TRAIN,
}
CELLS = sorted(CONTRACT)


_CALLS_RE = re.compile(r"calls=%?([^\s,)]+)")


def _reference_reading(txt: str, *, fresh_body: bool = False,
                       legalized: bool = True) -> LabeledTrace:
    """``hlo_to_trace`` (granule 512, refs_cap 16, loop_cap 2) of the
    reference's HLO, with either program difference undone:
    ``fresh_body`` names every buffer of a ``while`` body per iteration
    (no loop-body buffer reuse); ``legalized=False`` reads every f32
    ``convert`` of a bf16 operand, and every fusion that only converts
    one, as that operand (no bf16 legalization).  With neither, the
    trace is ``hlo_to_trace``'s, bit for bit."""
    model = HloCostModel(txt)
    state = _TraceState(512, 16)
    params = {i.name for i in model.comps[model.entry].instrs
              if i.op == "parameter"}

    def upcast_of(comp, ins) -> str | None:
        ops = _OPERANDS_RE.findall(ins.rest.split(")")[0])
        if (len(ops) != 1 or "f32[" not in ins.shape_txt
                or "bf16[" not in comp.shapes.get(ops[0], "")):
            return None
        if ins.op == "fusion":
            m = _CALLS_RE.search(ins.rest)
            body = model.comps.get(m.group(1)) if m else None
            if body is None or {i.op for i in body.instrs} - {
                    "parameter", "convert", "bitcast"}:
                return None
        elif ins.op != "convert":
            return None
        return ops[0]

    def emit(comp_name: str, prefix: str, depth: int):
        comp = model.comps.get(comp_name)
        if comp is None:
            return
        scope = prefix if depth and fresh_body else comp_name
        alias: dict[str, str] = {}
        for ins in comp.instrs:
            if ins.op in ("parameter", "constant", "get-tuple-element",
                          "tuple", "bitcast", "after-all"):
                continue
            if ins.op == "while":
                body, mt = _BODY_RE.search(ins.rest), _TRIP_RE.search(ins.rest)
                for it in range(min(int(mt.group(1)) if mt else 1, 2)):
                    emit(body.group(1), f"{prefix}/{ins.name}@{it}",
                         depth + 1)
                continue
            src = None if legalized else upcast_of(comp, ins)
            if src is not None:
                alias[ins.name] = alias.get(src, src)
                continue
            addrs, mask = [], []
            named = [(o, o in params) for o in (
                alias.get(o, o) for o in
                _OPERANDS_RE.findall(ins.rest.split(")")[0])[:6])]
            for name, shared in named + [(ins.name, False)]:
                shape = (comp.shapes.get(name, "") if name != ins.name
                         else ins.shape_txt)
                _, nbytes = _shape_elems_bytes(shape)
                if nbytes <= 0:
                    continue
                buf = state.buffer(f"{scope}/{comp_name}/{name}", nbytes,
                                   shared)
                r = state.refs_for(buf)
                addrs.append(r)
                mask.append(np.full(len(r), shared))
            if addrs:
                state.blocks.append((f"{ins.op}:{prefix}",
                                     np.concatenate(addrs),
                                     np.concatenate(mask)))

    emit(model.entry, "main", 0)
    return trace_from_blocks(state.blocks)


def _port_trace(t) -> LabeledTrace:
    return LabeledTrace(t.addresses, t.bb_ids, t.shared_mask, t.inst_ids,
                        t.bb_names)


def _rates(session, trace) -> dict:
    out = {}
    for targets, cores in ((TABLE5, (1, 4)), (("tpu-v5e",), (1,))):
        res = session.predict(trace, PredictionRequest(
            targets=targets, core_counts=cores, respect_core_limit=False))
        for p in res.predictions:
            for lvl, v in p.hit_rates.items():
                out[(p.target, p.cores, lvl)] = v
    return out


def measure_cells() -> dict:
    """Per cell, the port's and the reference's readings (each step
    recorded and lowered once)."""
    session = Session(device="cpu")
    out = {}
    for cell in CELLS:
        arch, step = cell.split("/")
        src = registry.resolve(f"model/{arch_slug(arch)}/{step}", "smoke")
        rec = aten_trace.record_model_step(arch, step)
        txt = RefSource(arch, step).lowered_hlo()
        ref, ref_info = ref_hlo_to_trace(txt)
        ref = _port_trace(ref)
        out[cell] = {
            "source": src, "rec": rec, "trace": src.trace(),
            "info": src.info, "cost": aten_trace.recording_cost(rec),
            "ref_trace": ref, "ref_info": ref_info,
            "ref_cost": ref_cost(txt),
            "rates": _rates(session, src.trace()),
            "ref_rates": _rates(session, ref),
            "as_read": _reference_reading(txt),
            "readings": {kw: _rates(session,
                                    _reference_reading(txt, **dict(kw)))
                         for kw in READINGS},
        }
    return out


@pytest.fixture(scope="module")
def measured():
    return measure_cells()


def level_ranges(m: dict, readings=READINGS) -> dict:
    """Per (target, cores, level): the lowest and highest rate of the
    reference's readings (as compiled and with each or both program
    differences undone)."""
    out = {}
    for key, rate in m["ref_rates"].items():
        vals = [rate] + [m["readings"][kw][key] for kw in readings]
        out[key] = (min(vals), max(vals))
    return out


def contract_rows(measured: dict) -> list[dict]:
    """The contract's readings per cell: port / reference ratios; the
    largest hit-rate gap and its level's cause (the span of the
    reference's readings there); the largest distance of a level's port
    rate outside its range, and outside the range of the loop-body
    reading alone; the VMEM rates."""

    def outside(m, ranges):
        return max(max(lo - m["rates"][k], m["rates"][k] - hi, 0.0)
                   for k, (lo, hi) in ranges.items())

    rows = []
    for cell in CELLS:
        m = measured[cell]
        ranges = level_ranges(m)
        gap, key = max((abs(m["rates"][k] - m["ref_rates"][k]), k)
                       for k in m["rates"])
        rows.append({
            "cell": cell,
            "dot": (m["cost"]["dominant_flop_ops"]["dot"]
                    / m["ref_cost"]["dominant_flop_ops"]["dot"]),
            "touched": (m["info"]["touched_bytes"]
                        / m["ref_info"]["touched_bytes"]),
            "refs": f"{len(m['trace'])}/{len(m['ref_trace'])}",
            "max_gap": gap,
            "gap_level": key,
            "cause": ranges[key][1] - ranges[key][0],
            "outside": outside(m, ranges),
            "outside_loop_body_only": outside(
                m, level_ranges(m, READINGS[:1])),
            "vmem": (m["rates"][VMEM], m["ref_rates"][VMEM]),
        })
    return rows


_DIGEST = """
import hashlib, json, sys
from repro_torch.workloads import registry
out = {}
for name in sys.argv[1:]:
    src = registry.resolve(name, "smoke")
    t = src.trace()
    h = hashlib.sha1()
    for a in (t.addresses, t.bb_ids, t.shared_mask):
        h.update(a.tobytes())
    out[name] = [src.declared_fingerprint, h.hexdigest(), len(t)]
print(json.dumps(out))
"""


def _digest(trace) -> str:
    h = hashlib.sha1()
    for a in (trace.addresses, trace.bb_ids, trace.shared_mask):
        h.update(a.tobytes())
    return h.hexdigest()


def test_two_processes_give_one_fingerprint_and_bit_identical_traces(
        measured):
    names = [f"model/{arch_slug(c.split('/')[0])}/{c.split('/')[1]}"
             for c in CELLS]
    # one process on one CPU thread, one on four: the recording does not
    # depend on the thread count the caller runs with
    procs = [subprocess.Popen([sys.executable, "-c", _DIGEST, *names],
                              cwd=ROOT, env={
                                  "PYTHONPATH": str(ROOT / "src"),
                                  "PATH": "/usr/bin:/bin",
                                  "OMP_NUM_THREADS": threads},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for threads in ("1", "4")]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    for cell, name in zip(CELLS, names):
        m = measured[cell]
        assert outs[0][name] == [m["source"].declared_fingerprint,
                                 _digest(m["trace"]), len(m["trace"])]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_meets_its_contract(measured, cell):
    m, bounds = measured[cell], CONTRACT[cell]
    trace, ref = m["trace"], m["ref_trace"]
    # a recording is a pure function of the step: the same bits again
    again, _ = aten_trace.recording_to_trace(m["rec"])
    assert _digest(again) == _digest(trace)
    assert trace.shared_mask.any() and not trace.shared_mask.all()
    assert m["info"]["loop_scale"] == 1.0

    ratios = {
        "dot": (m["cost"]["dominant_flop_ops"]["dot"]
                / m["ref_cost"]["dominant_flop_ops"]["dot"]),
        "touched": (m["info"]["touched_bytes"]
                    / m["ref_info"]["touched_bytes"]),
        "refs": len(trace) / len(ref),
    }
    for key, ratio in ratios.items():
        b = getattr(bounds, key)
        assert b.lo <= ratio <= b.hi, (cell, key, ratio, b.cause)

    # the reading as compiled is the reference's own trace
    assert _digest(m["as_read"]) == _digest(ref)
    rates, ref_rates = m["rates"], m["ref_rates"]
    assert rates.keys() == ref_rates.keys()
    for key, (lo, hi) in level_ranges(m).items():
        gap, cause = abs(rates[key] - ref_rates[key]), hi - lo
        assert gap <= cause + UNNAMED, (cell, key, gap, cause)
        assert lo - UNNAMED <= rates[key] <= hi + UNNAMED, (
            cell, key, rates[key], lo, hi)


def test_op_counts_and_info_have_the_reference_form(measured):
    for cell in CELLS:
        src = measured[cell]["source"]
        counts = vars(src.op_counts)
        assert set(counts) == {"int_ops", "fp_ops", "div_ops", "loads",
                               "stores", "total_bytes"}
        assert all(v > 0 for v in counts.values()), (cell, counts)
        info = src.info
        assert set(info) == {"touched_bytes", "loop_scale", "num_buffers",
                             "num_blocks", "granule", "top_buffers"}
        assert info["granule"] == model_trace.GRANULE
        tops = info["top_buffers"]
        assert len(tops) == 8
        assert [b["bytes"] for b in tops] == sorted(
            (b["bytes"] for b in tops), reverse=True)
        assert all(set(b) == {"bytes", "op", "name"} for b in tops)


def test_fingerprint_keys_follow_the_reference_with_the_port_stamp():
    """C8: the reference's keys with ``jax`` replaced by ``torch`` and
    the graph source's stamp."""
    got = model_trace.fingerprint_kwargs("llama3-8b", "decode")
    want = ref_model_trace.fingerprint_kwargs("llama3-8b", "decode")
    assert set(got) == set(want) - {"jax", "loop_cap"} | {"torch",
                                                          "graph_source"}
    assert {k: got[k] for k in want if k not in ("jax", "loop_cap")} == \
        {k: v for k, v in want.items() if k not in ("jax", "loop_cap")}
    assert got["torch"] == torch.__version__
    assert got["graph_source"] == model_trace.GRAPH_SOURCE
    for name in ("model/llama3_8b/decode", "model/zamba2_1_2b/prefill"):
        assert registry.declared_fingerprint(name) != \
            ref_registry.declared_fingerprint(name)
    assert (model_trace.STEPS, model_trace.GRANULE, model_trace.REFS_CAP,
            model_trace.MODEL_TRACE_VERSION) == (
        ref_model_trace.STEPS, ref_model_trace.GRANULE,
        ref_model_trace.REFS_CAP, ref_model_trace.MODEL_TRACE_VERSION)


@pytest.mark.parametrize("step", ["train", "prefill", "decode"])
def test_example_inputs_and_cache_kwargs_follow_the_reference(step):
    """The concrete inputs have the shapes and dtypes of the reference's
    ``input_specs`` at each smoke shape, and the same ``cache_kwargs``."""
    from repro.configs import reduced as ref_reduced

    from repro_torch.configs import list_archs
    from repro_torch.configs import reduced

    name = {"train": "SMOKE_SHAPE", "prefill": "SMOKE_PREFILL",
            "decode": "SMOKE_DECODE"}[step]
    shape, ref_shape = getattr(reduced, name), getattr(ref_reduced, name)
    assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == \
        (ref_shape.name, ref_shape.seq_len, ref_shape.global_batch,
         ref_shape.kind)
    for arch in list_archs():
        spec, ref = reduced.reduced_arch(arch), ref_reduced.reduced_arch(arch)
        got, want = spec.example_inputs(shape), ref.input_specs(ref_shape)
        assert list(got) == list(want), arch
        for key, x in got.items():
            assert tuple(x.shape) == want[key].shape, (arch, key)
            assert str(x.dtype).removeprefix("torch.") == \
                str(want[key].dtype), (arch, key)
        again = spec.example_inputs(shape)
        assert all(torch.equal(again[k], got[k]) for k in got)
        assert spec.cache_kwargs(shape) == ref.cache_kwargs(ref_shape)


def test_arch_slug_and_unknown_step():
    assert arch_slug("llama3-8b") == "llama3_8b"
    assert arch_slug("zamba2-1.2b") == "zamba2_1_2b"
    with pytest.raises(ValueError, match="unknown model step"):
        ModelTraceSource("llama3-8b", "finetune")
    with pytest.raises(ValueError, match="no recorded form"):
        aten_trace.step_call("llama3-8b", "finetune")


def test_warm_store_answers_without_recording(tmp_path, monkeypatch):
    """A warm store answers ``op_counts`` and ``info`` from its workload
    meta: the second source never records."""
    store = ArtifactStore(tmp_path)
    name = "model/mixtral_8x7b/decode"
    first = registry.resolve(name, "smoke", store=store)
    first.trace()
    counts, info = first.op_counts, first.info
    meta = store.get_json("workload", first.declared_fingerprint)
    assert meta["refs"] == len(first.trace())
    assert meta["workload"] == name

    def no_recording(*args, **kwargs):
        raise AssertionError("a warm store must not record")

    monkeypatch.setattr(aten_trace, "record_model_step", no_recording)
    monkeypatch.setattr(aten_trace, "record", no_recording)
    fresh = registry.resolve("model/mixtral-8x7b/decode", "smoke",
                             store=store)
    assert fresh.op_counts == counts
    assert fresh.info == info
    with pytest.raises(AssertionError, match="must not record"):
        fresh.trace()


def test_train_cells_resolve_and_raise_a11b():
    """A ``train`` cell resolves and records the loss and its gradient;
    the backward's ops are in the trace (the gradient products: more
    matmul FLOPs than twice the forward's) and, with remat, so is the
    recomputation of each checkpointed layer."""
    src = registry.resolve("model/llama3_8b/train", "smoke")
    assert src.declared_fingerprint
    trace = src.trace()
    assert trace.shared_mask.any() and not trace.shared_mask.all()
    assert all(v > 0 for v in vars(src.op_counts).values())
    assert src.info["touched_bytes"] > 0
    ops = [e.op for e in aten_trace.record_model_step("llama3-8b",
                                                      "train").events]
    forward = [e.op for e in aten_trace.record_model_step(
        "llama3-8b", "prefill").events]
    assert "silu_backward" in ops and len(ops) > 2 * len(forward)
    # each block's SwiGLU runs in the forward and again in its remat
    assert ops.count("silu") == 2 * forward.count("silu") > 0


@pytest.mark.parametrize("name", ["model/llama3_8b/decode",
                                  "model/seamless_m4t_medium/prefill",
                                  "model/zamba2_1_2b/decode"])
def test_session_predict_on_a_model_cell_matches_the_oracle(name):
    """The batched SDCM on the CPU within 1e-6 of the float64 oracle,
    with the cell's op counts driving the runtime."""
    src = registry.resolve(name, "smoke")
    req = PredictionRequest(targets=TABLE5 + ("tpu-v5e",),
                            core_counts=(1, 2, 4), counts=src.op_counts,
                            respect_core_limit=False)
    got = Session(device="cpu", cache_model="batched").predict(src, req)
    want = Session(device="cpu",
                   cache_model=AnalyticalSDCM(backend="numpy")).predict(
        src, req)
    assert len(got.predictions) == len(want.predictions) == 4 * 3
    for a, b in zip(got.predictions, want.predictions):
        assert a.hit_rates.keys() == b.hit_rates.keys()
        for lvl in a.hit_rates:
            assert abs(a.hit_rates[lvl] - b.hit_rates[lvl]) <= RATE_TOL
        assert a.t_pred_s > 0


if __name__ == "__main__":
    # the contract's readings as a table (PERF.md §6):
    #   PYTHONPATH=src python tests/test_torch_model_trace.py
    print("| cell | dot | touched bytes | refs port/ref | max gap (level) "
          "| cause there | outside range | outside, loop body alone "
          "| VMEM port / ref |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in contract_rows(measure_cells()):
        target, cores, lvl = r["gap_level"]
        print(f"| {r['cell']} | {r['dot']:.4f} | {r['touched']:.3f} "
              f"| {r['refs']} | {r['max_gap']:.3f} ({target} {cores} {lvl})"
              f" | {r['cause']:.3f} | {r['outside']:.3f} "
              f"| {r['outside_loop_body_only']:.3f} | "
              + " / ".join(f"{v:.3f}" for v in r["vmem"]) + " |")
