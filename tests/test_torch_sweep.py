"""The port's fused config sweep (``repro_torch.api.batched.sweep_grid``)
against its own ``batched_hit_rates`` and host ECM model, and against
the JAX package's ``sweep_grid``: rates bit-identical to the port's
predict rows and within 1e-6 of the reference's, ``t_pred_s`` within rel
1e-12 of the port's host ``ECMRuntimeModel`` and within the reference's
float32 bound (rel 1e-5) of the reference's, ``inner="pallas"`` (B1's
per-reference form; the reference's Pallas kernel in interpret mode)
within 1e-6 of ``inner="vmap"``, one SDCM call per sweep in either, and
no new launch shape on a repeat sweep."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import Session as RefSession
from repro.core.runtime_model import OpCounts as RefCounts
from repro.explore import FusedSweepEvaluator as RefEvaluator
from repro.explore import SearchSpace as RefSpace

from repro_torch.api import Session, batched
from repro_torch.api.batched import (
    SweepGeometry,
    batched_hit_rates,
    pack_profile_device,
    shape_count,
    sweep_grid,
)
from repro_torch.api.stages import shared_level_index
from repro_torch.core.incore import ECMRuntimeModel, timings_of
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.core.runtime_model import OpCounts
from repro_torch.explore import FusedSweepEvaluator, SearchSpace
from repro_torch.hw.targets import resolve_target
from repro_torch.kernels.sdcm import a_max_bucket
from repro_torch.workloads.polybench import make_atax

torch.set_num_threads(1)

COUNTS = dict(int_ops=3000, fp_ops=1500, div_ops=10, loads=3000,
              stores=1500, total_bytes=4500 * 8)
SPACE = dict(sets=(64, 512, 4096, 32768), ways=(1, 4, 8, 16),
             line_sizes=(64, 128), latency_cy=(20.0, 36.0),
             beta_cy=(2.0, 5.0), cores=(1, 2, 4),
             strategies=("round_robin", "uniform"))
RATE_TOL = 1e-6        # the reference's hit-rate bound
ECM_RTOL = 1e-12       # float64 chain vs the host ECM model
REF_T_RTOL = 1e-5      # the reference's float32 chain bound


@pytest.fixture(scope="module")
def setup():
    w = make_atax(n=32)
    space = SearchSpace(**SPACE)
    session = Session(device="cpu", cache_model="batched")
    ev = FusedSweepEvaluator(w, space, session=session,
                             counts=OpCounts(**COUNTS))
    configs = space.configs()
    return w, space, session, ev, configs, ev.evaluate(configs)


def applied_items(session, w, ev, configs):
    """The sequential path: one applied target + artifact set per config,
    exactly what ``Session.predict`` would evaluate."""
    return [
        (cfg.apply(ev.base, ev.level_idx),
         session.artifacts(w, cfg.cores, strategy=cfg.strategy,
                           line_size=cfg.line_size))
        for cfg in configs
    ]


def test_sweep_rates_bit_identical_to_batched_hit_rates(setup):
    w, _space, session, ev, configs, res = setup
    items = applied_items(session, w, ev, configs)
    names = [lvl.name for lvl in ev.base.levels]
    want = np.array([[r[n] for n in names]
                     for r in batched_hit_rates(items, device="cpu")])
    assert res.rates.tolist() == want.tolist()


@pytest.mark.parametrize("mode", ["throughput", "latency"])
def test_sweep_runtime_matches_the_host_ecm_model(setup, mode):
    w, space, session, _ev, configs, _res = setup
    ev = FusedSweepEvaluator(w, space, session=session, mode=mode,
                             counts=OpCounts(**COUNTS))
    res = ev.evaluate(configs)
    assert np.all(res.t_pred_s > 0)
    model = ECMRuntimeModel()
    names = [lvl.name for lvl in ev.base.levels]
    for ci, (target, _art) in enumerate(
            applied_items(session, w, ev, configs)):
        host = model.runtime(
            target, dict(zip(names, res.rates[ci])), OpCounts(**COUNTS),
            configs[ci].cores, mode=mode)["t_pred_s"]
        assert res.t_pred_s[ci] == pytest.approx(host, rel=ECM_RTOL, abs=0)


@pytest.mark.parametrize("inner", ["vmap", "pallas"])
def test_sweep_matches_the_reference(setup, inner):
    """The reference's sweep on the same configs: its rates within 1e-6,
    its float32 runtime chain within rel 1e-5; its Pallas inner runs in
    interpret mode, as its own tests run it."""
    from repro.workloads.polybench import make_atax as ref_atax

    _w, space, session, ev, configs, res = setup
    ref_space = RefSpace(**SPACE)
    ref = RefEvaluator(ref_atax(n=32), ref_space,
                       session=RefSession(cache_model="batched"),
                       counts=RefCounts(**COUNTS), inner=inner)
    # the reference compiles one kernel per row shape and profile pair:
    # its round-robin groups keep this within the file's time
    sample = [c for c in configs if c.strategy == "round_robin"]
    if inner == "pallas":
        sample = [c for c in sample if c.sets <= 512][:24]
    ref_cfgs = [ref_space.configs()[configs.index(c)] for c in sample]
    assert [c.key() for c in ref_cfgs] == [c.key() for c in sample]
    want = ref.evaluate(ref_cfgs)
    got = FusedSweepEvaluator(_w, space, session=session, inner=inner,
                              counts=OpCounts(**COUNTS)).evaluate(sample)
    assert np.max(np.abs(got.rates - want.rates)) <= RATE_TOL
    np.testing.assert_allclose(got.t_pred_s, want.t_pred_s, rtol=REF_T_RTOL)


def test_pallas_inner_matches_vmap_inner(setup):
    w, space, session, _ev, configs, res = setup
    ev = FusedSweepEvaluator(w, space, session=session, inner="pallas",
                             counts=OpCounts(**COUNTS))
    got = ev.evaluate(configs)
    assert np.max(np.abs(got.rates - res.rates)) <= RATE_TOL
    np.testing.assert_allclose(got.t_pred_s, res.t_pred_s, rtol=RATE_TOL)


def test_one_kernel_call_per_sweep(setup, monkeypatch):
    """One SDCM call per ``sweep_grid`` call (one per profile group of a
    batch): a ragged rates call for ``inner="vmap"``, a ragged
    per-reference call for ``inner="pallas"`` (every distinct
    set-associative (level, assoc, blocks) of the call in it; the
    reference dispatches once per distinct (level, assoc, blocks))."""
    w, space, session, _ev, configs, _res = setup
    calls = {"sdcm_rates_ragged": 0, "sdcm_hit_probs_ragged": 0}
    records = []

    def counting(name):
        fn = getattr(batched, name)

        def wrapped(*args):
            calls[name] += 1
            if name == "sdcm_hit_probs_ragged":
                records.append(args[1].shape[0])
            return fn(*args)
        return wrapped

    for name in calls:
        monkeypatch.setattr(batched, name, counting(name))
    groups = {(c.line_size, c.cores, c.strategy) for c in configs}
    ev = FusedSweepEvaluator(w, space, session=session,
                             counts=OpCounts(**COUNTS))
    ev.evaluate(configs)
    assert calls == {"sdcm_rates_ragged": len(groups),
                     "sdcm_hit_probs_ragged": 0}
    assert ev.stats.fused_dispatches == len(groups)

    calls.update(sdcm_rates_ragged=0)
    pe = FusedSweepEvaluator(w, space, session=session, inner="pallas",
                             counts=OpCounts(**COUNTS))
    pe.evaluate(configs)
    assert calls == {"sdcm_rates_ragged": 0,
                     "sdcm_hit_probs_ragged": len(groups)}
    assert pe.stats.fused_dispatches == len(groups)
    # each call's records: the distinct set-associative (profile, assoc,
    # blocks) of its group
    want = []
    for line, cores, strategy in groups:
        geom = pe._geometry([c for c in configs if (c.line_size, c.cores,
                             c.strategy) == (line, cores, strategy)],
                            line, cores)
        want.append(len({(lv >= pe.shared_idx, a, b)
                         for lv in range(geom.assoc.shape[1])
                         for a, b in zip(geom.assoc[:, lv],
                                         geom.blocks[:, lv]) if a < b}))
    assert sorted(records) == sorted(want) and min(want) > 1


def test_repeat_sweeps_add_no_shape(setup):
    w, space, session, ev, configs, _res = setup
    pe = FusedSweepEvaluator(w, space, session=session, inner="pallas",
                             counts=OpCounts(**COUNTS))
    pe.evaluate(configs)                # warm both evaluators' shapes
    warm_session = session.stats.kernel_shapes
    before = shape_count()
    assert pe.evaluate(configs).rates.shape == (len(configs), 3)
    ev.evaluate(configs)
    assert shape_count() == before
    assert session.stats.kernel_shapes == warm_session
    groups = {(c.line_size, c.cores, c.strategy) for c in configs}
    assert ev.stats.profile_groups == pe.stats.profile_groups == len(groups)


def test_geometry_is_the_applied_targets(setup):
    """The staged geometry IS the applied target's geometry: the
    invariant the bit identity rests on."""
    _w, space, _session, ev, configs, _res = setup
    base = resolve_target(space.target)
    for line in space.line_sizes:
        cfgs = [c for c in configs if c.line_size == line][:12]
        geom = ev._geometry(cfgs, line, 1)
        for ci, cfg in enumerate(cfgs):
            tgt = cfg.apply(base, ev.level_idx)
            for lv, lvl in enumerate(tgt.levels):
                assert geom.assoc[ci, lv] == lvl.effective_assoc
                assert geom.blocks[ci, lv] == lvl.num_lines
            assert geom.delta[ci].tolist() == list(tgt.level_latency_cy)
            assert geom.trans_beta[ci].tolist() == (
                list(tgt.level_beta_cy[1:]) + [tgt.ram_beta_cy])
    assert shared_level_index(base) == ev.shared_idx


@pytest.mark.parametrize("assoc,blocks", [
    (1, 64), (8, 8), (9, 4096), (16, 32 << 20), (33, 1 << 21),
    (64, 1 << 25), (20, 20), (65, 65), (4096, 4096)])
def test_buckets_follow_the_predict_rule(assoc, blocks):
    """``_sweep_buckets`` gives every row the bucket ``a_max_bucket``
    (the predict's rule) gives it, up to 2M sets of 16 ways."""
    got = batched._sweep_buckets(np.array([[assoc]], dtype=np.float64),
                                 np.array([[blocks]], dtype=np.float64))
    assert int(got[0, 0]) == a_max_bucket(assoc, blocks)


def test_assoc_above_the_limit_raises():
    with pytest.raises(ValueError, match="exceeds"):
        batched._sweep_buckets(np.array([[8.0, 65.0]]),
                               np.array([[64.0, 4096.0]]))
    with pytest.raises(ValueError, match="exceeds"):
        SearchSpace(ways=(128,))


def _geom(c, levels=3, assoc=4.0, blocks=512.0):
    return SweepGeometry(
        assoc=np.full((c, levels), assoc), blocks=np.full((c, levels), blocks),
        trans_beta=np.ones((c, levels)), delta=np.ones((c, levels)),
        cores=np.ones(c))


def test_errors_and_empty_profiles():
    prof = ReuseProfile(np.array([-1, 0, 5, 900]), np.array([3, 4, 5, 6]), 18)
    empty = ReuseProfile(np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    full = pack_profile_device(prof, device="cpu")
    none = pack_profile_device(empty, device="cpu")
    with pytest.raises(ValueError, match="unknown sweep inner"):
        sweep_grid(full, full, _geom(2), shared_idx=2, inner="scan")
    with pytest.raises(ValueError, match="needs timings"):
        sweep_grid(full, full, _geom(2), shared_idx=2,
                   counts=OpCounts(**COUNTS))
    with pytest.raises(ValueError, match="shape mismatch"):
        dataclasses.replace(_geom(2), cores=np.ones(3))
    for inner in ("vmap", "pallas"):
        res = sweep_grid(full, none, _geom(4), shared_idx=2, inner=inner)
        assert np.all(res.rates[:, 2] == 0.0)
        assert np.all(res.rates[:, :2] > 0.0)
        res = sweep_grid(none, full, _geom(4), shared_idx=2, inner=inner)
        assert np.all(res.rates[:, :2] == 0.0)
    res = sweep_grid(full, full, _geom(0), shared_idx=2,
                     counts=OpCounts(**COUNTS),
                     timings=timings_of(resolve_target("i7-5960X")))
    assert res.rates.shape == (0, 3) and res.t_pred_s.shape == (0,)


def test_llc_miss_objective_without_counts(setup):
    _w, space, session, _ev, configs, _res = setup
    from repro_torch.core.trace.types import trace_from_blocks

    trace = trace_from_blocks([("b", np.arange(0, 4096, 8), True)] * 3)
    ev = FusedSweepEvaluator(trace, space, session=session)
    assert ev.objective == "llc_miss"
    res = ev.evaluate(configs[:8])
    assert res.t_pred_s is None
    assert np.array_equal(res.scores, 1.0 - res.rates[:, -1])
    with pytest.raises(ValueError, match="op counts"):
        FusedSweepEvaluator(trace, space, session=session,
                            objective="runtime")
