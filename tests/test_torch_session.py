"""The whole slice: the port's ``Session.predict`` against the JAX
package's on the same workloads, grid and request — atx and mvt on the
full grid (three Table-5 CPUs, gpu-sm, tpu-v5e; cores 1/2/4; two
strategies), every other PolyBench maker on a lighter one."""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from repro.api import AnalyticalSDCM as RefSDCM
from repro.api import PredictionRequest as RefRequest
from repro.api import Session as RefSession
from repro.workloads import polybench as ref_pb

from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
from repro_torch.workloads import polybench as pb

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)

TARGETS = ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P", "gpu-sm", "tpu-v5e")
GRID = dict(targets=TARGETS, core_counts=(1, 2, 4),
            strategies=("round_robin", "uniform"), seed=3)
# every other maker, on a lighter grid (one Table-5 CPU and the GPU)
LIGHT_GRID = dict(targets=("i7-5960X", "gpu-sm"), core_counts=(1, 4),
                  strategies=("round_robin",), seed=3)
FULL_GRID_MAKERS = ("atx", "mvt")
BUILD_COUNTERS = ("trace_builds", "rd_builds", "mimic_builds",
                  "interleave_builds", "profile_builds", "profile_hits")


def counters(stats):
    return {k: getattr(stats, k) for k in BUILD_COUNTERS}


@pytest.fixture(scope="module", params=list(FULL_GRID_MAKERS) + sorted(
    set(pb.MAKERS) - set(FULL_GRID_MAKERS)))
def both(request):
    """(port workload, port result pieces, reference pieces) for one
    workload: numpy-backend and batched predictions of each package."""
    abbr = request.param
    grid = GRID if abbr in FULL_GRID_MAKERS else LIGHT_GRID
    ref_w = ref_pb.make_workload(abbr, "smoke")
    port_w = pb.make_workload(abbr, "smoke")
    ref_req = RefRequest(counts=ref_w.op_counts, **grid)
    port_req = PredictionRequest(counts=port_w.op_counts, **grid)

    ref_sess = RefSession()
    ref_numpy = ref_sess.predict(ref_w, ref_req)
    ref_stats = counters(ref_sess.stats)
    ref_sess.cache_model = RefSDCM(backend="batched")
    ref_batched = ref_sess.predict(ref_w, ref_req)

    port_sess = Session(device="cpu")
    port_numpy = port_sess.predict(port_w, port_req)
    port_stats = counters(port_sess.stats)
    port_batched_sess = Session(device="cpu", cache_model="batched")
    port_batched = port_batched_sess.predict(port_w, port_req)
    return dict(
        ref_numpy=ref_numpy, ref_batched=ref_batched, ref_stats=ref_stats,
        port_numpy=port_numpy, port_batched=port_batched,
        port_stats=port_stats, port_batched_sess=port_batched_sess,
        port_w=port_w, port_req=port_req,
    )


def test_numpy_backend_json_is_equal(both):
    assert both["port_numpy"].to_json() == both["ref_numpy"].to_json()
    assert both["port_numpy"].to_table() == both["ref_numpy"].to_table()


def test_batched_backend_agrees(both):
    got, ref = both["port_batched"], both["ref_batched"]
    assert len(got) == len(ref) == len(both["ref_numpy"]) > 0
    assert got.trace_id == ref.trace_id
    for g, r, o in zip(got, ref, both["ref_numpy"]):
        assert (g.target, g.cores, g.strategy, g.mode, g.runtime_model) == (
            r.target, r.cores, r.strategy, r.mode, r.runtime_model)
        assert g.hit_rates.keys() == r.hit_rates.keys()
        for lvl in g.hit_rates:
            assert g.hit_rates[lvl] == pytest.approx(r.hit_rates[lvl], abs=1e-6)
            assert g.hit_rates[lvl] == pytest.approx(o.hit_rates[lvl], abs=1e-6)
        for f in ("t_pred_s", "t_mem_s", "t_cpu_s"):
            assert getattr(g, f) == pytest.approx(getattr(r, f), rel=1e-5)


def test_build_counters_equal(both):
    assert both["port_stats"] == both["ref_stats"]
    assert both["port_stats"]["profile_builds"] > 0


def test_warm_predict_rebuilds_nothing(both):
    sess = both["port_batched_sess"]
    before = dataclasses.replace(sess.stats)
    again = sess.predict(both["port_w"], both["port_req"])
    assert again.to_json() == both["port_batched"].to_json()
    assert sess.stats.profile_builds == before.profile_builds
    assert sess.stats.trace_builds == before.trace_builds
    assert sess.stats.kernel_shapes == before.kernel_shapes
    assert sess.stats.profile_hits > before.profile_hits
    assert {"trace", "reuse_profile", "cache_model",
            "runtime_model"} <= set(sess.stage_seconds)


def test_predict_many_equals_sequential(both):
    sess = Session(device="cpu", cache_model="batched")
    w = both["port_w"]
    req1 = both["port_req"]
    req2 = PredictionRequest(targets=("EPYC 7702P",), core_counts=(2,),
                             counts=w.op_counts)
    many = sess.predict_many([(w, req1), (w, req2)])
    seq = [Session(device="cpu", cache_model="batched").predict(w, r)
           for r in (req1, req2)]
    assert [m.to_json() for m in many] == [s.to_json() for s in seq]


def test_uncached_session_matches_reference_counters():
    ref_w = ref_pb.make_workload("atx", "smoke")
    port_w = pb.make_workload("atx", "smoke")
    kw = dict(targets=("i7-5960X",), core_counts=(1, 2))
    ref = RefSession(cache=False)
    ref_out = ref.predict(ref_w, RefRequest(**kw))
    port = Session(device="cpu", cache=False)
    port_out = port.predict(port_w, PredictionRequest(**kw))
    assert counters(port.stats) == counters(ref.stats)
    assert json.loads(port_out.to_json()) == json.loads(ref_out.to_json())


def test_hit_rates_convenience_matches_reference():
    ref_w = ref_pb.make_workload("dbn", "smoke")
    port_w = pb.make_workload("dbn", "smoke")
    want = RefSession().hit_rates(ref_w, "Xeon E5-2699 v4", 4,
                                  strategy="chunked")
    got = Session(device="cpu").hit_rates(port_w, "Xeon E5-2699 v4", 4,
                                          strategy="chunked")
    assert got == want
    got_b = Session(device="cpu", cache_model=AnalyticalSDCM("batched")
                    ).hit_rates(port_w, "Xeon E5-2699 v4", 4,
                                strategy="chunked")
    for lvl in want:
        assert got_b[lvl] == pytest.approx(want[lvl], abs=1e-6)


# --- binned and streaming sessions -------------------------------------------

from repro.api.stages import MimicProfileBuilder as RefBuilder  # noqa: E402
from repro.workloads.polybench import make_atax as ref_make_atax  # noqa: E402

from repro_torch.api import MimicProfileBuilder  # noqa: E402
from repro_torch.core.reuse import distance  # noqa: E402

SLICE_REQ = dict(targets=("i7-5960X", "tpu-v5e"), core_counts=(1, 2, 4),
                 strategies=("round_robin", "chunked", "uniform"),
                 respect_core_limit=False)


@pytest.fixture(scope="module")
def atax32():
    return make_atax_pair()


def make_atax_pair():
    return pb.make_atax(n=32), ref_make_atax(n=32)


def same_profile(a, b):
    assert a.distances.tolist() == b.distances.tolist()
    assert a.counts.tolist() == b.counts.tolist()
    assert a.total == b.total


def cell_artifacts(sess, w, req):
    return [sess.artifacts(w, c.cores, strategy=c.strategy, seed=req.seed,
                           line_size=c.target.levels[0].line_size)
            for c in req.cells()]


@pytest.mark.parametrize("window", [None, 512])
def test_binned_session_matches_reference(atax32, window):
    port_w, ref_w = atax32
    req, ref_req = PredictionRequest(**SLICE_REQ), RefRequest(**SLICE_REQ)
    port = Session(device="cpu", binned=True, window_size=window,
                   cache_model="batched")
    ref = RefSession(binned=True, window_size=window)
    got = port.predict(port_w, req)
    want = ref.predict(ref_w, ref_req)
    exact = Session(device="cpu").predict(port_w, req)
    assert len(got) == len(want) == len(exact) > 0
    for g, r, e in zip(got, want, exact):
        assert (g.target, g.cores, g.strategy) == (r.target, r.cores,
                                                    r.strategy)
        for lvl in r.hit_rates:
            assert g.hit_rates[lvl] == pytest.approx(r.hit_rates[lvl],
                                                     abs=1e-6)
            assert abs(g.hit_rates[lvl] - e.hit_rates[lvl]) < 1e-3
    for a, b in zip(cell_artifacts(port, port_w, req),
                    cell_artifacts(ref, ref_w, ref_req)):
        assert a.binned and b.binned
        assert a.window_size == b.window_size == window
        same_profile(a.prd, b.prd)
        same_profile(a.crd, b.crd)


@pytest.mark.parametrize("ws", [128, 1 << 14])
def test_streaming_session_is_bit_equal_to_in_memory(atax32, ws):
    port_w, ref_w = atax32
    req = PredictionRequest(counts=port_w.op_counts, **SLICE_REQ)
    exact = Session(device="cpu").predict(port_w, req)
    sess = Session(device="cpu", window_size=ws)
    got = sess.predict(port_w, req)
    assert got.to_json() == exact.to_json()
    # one streaming build per profile cell, none served from the
    # in-memory cells
    assert sess.stats.streaming_builds == sess.stats.profile_builds > 0
    ref = RefSession(window_size=ws).predict(
        ref_w, RefRequest(counts=ref_w.op_counts, **SLICE_REQ))
    assert got.to_json() == ref.to_json()


def test_request_window_size_overrides_session(atax32):
    port_w, _ = atax32
    one = dict(targets=("i7-5960X",), core_counts=(2,))
    sess = Session(device="cpu")
    sess.predict(port_w, PredictionRequest(window_size=200, **one))
    assert sess.stats.streaming_builds == 1
    streaming = Session(device="cpu", window_size=128)
    distance.WINDOWS.clear()
    streaming.predict(port_w, PredictionRequest(window_size=0, **one))
    assert streaming.stats.streaming_builds == 0
    assert not distance.WINDOWS  # no stage streamed behind the Session
    sess_b = Session(device="cpu", profile_builder=MimicProfileBuilder(
        "cpu", window_size=64))
    sess_b.artifacts(port_w, 2)
    assert sess_b.stats.streaming_builds == 1


class StagesOnlyBuilder:
    """A builder with only the ``ProfileBuilder`` protocol's stages (no
    streaming hooks)."""

    def __init__(self):
        self.inner = MimicProfileBuilder("cpu")

    def private_traces(self, trace, cores):
        return self.inner.private_traces(trace, cores)

    def interleave(self, privates, strategy, seed):
        return self.inner.interleave(privates, strategy, seed)

    def profile(self, trace, line_size):
        return self.inner.profile(trace, line_size)


@pytest.mark.parametrize("ws", [None, 256])
def test_builder_without_streaming_hooks(atax32, ws):
    """A protocol-only builder runs in both modes through its own
    stages: the shared trace is materialized, the predictions equal the
    default builder's."""
    port_w, _ = atax32
    req = PredictionRequest(counts=port_w.op_counts, **SLICE_REQ)
    sess = Session(device="cpu", profile_builder=StagesOnlyBuilder(),
                   window_size=ws)
    got = sess.predict(port_w, req)
    assert got.to_json() == Session(device="cpu").predict(
        port_w, req).to_json()
    arts = cell_artifacts(sess, port_w, req)
    assert all(a.shared is not None and a.window_size == ws for a in arts)
    assert sess.stats.streaming_builds == (sess.stats.profile_builds
                                           if ws else 0)


def test_artifact_flags_and_fingerprints_match_reference(atax32):
    port_w, ref_w = atax32
    for kw in (dict(), dict(binned=True), dict(window_size=256),
               dict(binned=True, window_size=256)):
        port = Session(device="cpu", **kw)
        ref = RefSession(**kw)
        for cores in (1, 4):
            for strategy in ("round_robin", "uniform"):
                a = port.artifacts(port_w, cores, strategy=strategy)
                b = ref.artifacts(ref_w, cores, strategy=strategy)
                assert (a.binned, a.window_size) == (b.binned, b.window_size)
                assert (a.shared is None) == (b.shared is None)
                assert len(a.privates) == len(b.privates)
        # binned cells take the port's own store key (ROADMAP queue C,
        # C4); every other cell keeps the reference's
        assert ((port.builder.store_fingerprint
                 == ref.builder.store_fingerprint)
                is not kw.get("binned", False))
        assert vars(port.stats).get("streaming_builds") == \
            ref.stats.streaming_builds
    assert (MimicProfileBuilder("cpu", binned=True).store_fingerprint
            == RefBuilder(binned=True).store_fingerprint.replace(
                "repro.", "repro_torch.", 1))


def test_binned_needs_a_binned_builder():
    with pytest.raises(ValueError, match="binned"):
        Session(device="cpu", profile_builder=MimicProfileBuilder("cpu"),
                binned=True)
    Session(device="cpu", profile_builder=MimicProfileBuilder(
        "cpu", binned=True), binned=True)
