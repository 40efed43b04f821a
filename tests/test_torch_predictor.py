"""The CRD helpers, the Fig. 7 tasklist and the deprecated
``PPTMulticorePredictor`` shim: the port (``device="cpu"``) against the
JAX package — profiles equal, tasklist JSON byte for byte, predictions
and ground truth equal."""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from repro.core import predictor as ref_predictor
from repro.core import tasklist as ref_tasklist
from repro.core.reuse import crd as ref_crd
from repro.core.reuse.profile import profile_from_trace as ref_profile_from_trace
from repro.core.runtime_model import OpCounts as RefOpCounts
from repro.core.trace.types import trace_from_blocks as ref_from_blocks
from repro.hw.targets import CPU_TARGETS as REF_CPU_TARGETS

from repro_torch.core import predictor, tasklist
from repro_torch.core.reuse import crd
from repro_torch.core.reuse.profile import ReuseProfile, profile_from_trace
from repro_torch.core.runtime_model import OpCounts
from repro_torch.core.trace.types import trace_from_blocks
from repro_torch.hw.targets import CPU_TARGETS

torch.set_num_threads(1)

COUNTS = dict(int_ops=3000, fp_ops=1500, div_ops=10, loads=3000,
              stores=1500, total_bytes=4500 * 8)


def strided_workload(from_blocks, iters=1500, stride=8):
    """The reference predictor test's workload."""
    blocks = [("OUT__1__.entry", np.array([0, 8]), True)]
    a0, b0 = 1 << 20, 2 << 20
    for i in range(iters):
        blocks.append(("OUT__1__.for.body",
                       np.array([a0 + stride * i, b0 + stride * (i % 128), 0]),
                       np.array([False, False, True])))
    return from_blocks(blocks)


def same_profile(a, b) -> bool:
    return (np.array_equal(a.distances, b.distances)
            and np.array_equal(a.counts, b.counts) and a.total == b.total)


@pytest.fixture(scope="module")
def traces():
    return (strided_workload(trace_from_blocks),
            strided_workload(ref_from_blocks))


@pytest.mark.parametrize("strategy", ["round_robin", "uniform", "chunked"])
@pytest.mark.parametrize("cores", [1, 2, 4])
def test_crd_helpers_equal_reference(traces, cores, strategy):
    port_t, ref_t = traces
    got = crd.multicore_profiles(port_t, cores, strategy=strategy,
                                 line_size=64, seed=2, device="cpu")
    want = ref_crd.multicore_profiles(ref_t, cores, strategy=strategy,
                                      line_size=64, seed=2)
    assert (got.num_cores, got.strategy) == (want.num_cores, want.strategy)
    assert len(got.private) == len(want.private) == cores
    assert all(same_profile(a, b) for a, b in zip(got.private, want.private))
    assert same_profile(got.shared, want.shared)
    assert same_profile(profile_from_trace(port_t.addresses, 64, device="cpu"),
                        ref_profile_from_trace(ref_t.addresses, 64))


def test_profile_merge_and_scale():
    a = ReuseProfile(np.array([-1, 0, 5]), np.array([2, 3, 4]), 9)
    b = ReuseProfile(np.array([0, 7]), np.array([1, 1]), 2, 0.25)
    m = a.merged_with(b)
    assert m.distances.tolist() == [-1, 0, 5, 7]
    assert m.counts.tolist() == [2, 4, 4, 1] and m.total == 11
    assert m.error_bound == 0.25
    assert ReuseProfile.merge([a, a]).error_bound is None
    assert ReuseProfile.merge([]).total == 0
    s = b.scaled(2.5)
    assert s.counts.tolist() == [2, 2] and s.total == 4
    assert s.error_bound == 0.25
    assert a.with_error_bound(0.1).error_bound == 0.1


def port_predictor(name):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        return predictor.PPTMulticorePredictor(CPU_TARGETS[name],
                                               device="cpu")


def ref_predictor_for(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return ref_predictor.PPTMulticorePredictor(REF_CPU_TARGETS[name])


@pytest.mark.parametrize("name", sorted(CPU_TARGETS))
def test_predictor_equals_reference(traces, name):
    port_t, ref_t = traces
    port, ref = port_predictor(name), ref_predictor_for(name)
    got = port.sweep_cores(port_t, [1, 2, 4, 8], OpCounts(**COUNTS))
    want = ref.sweep_cores(ref_t, [1, 2, 4, 8], RefOpCounts(**COUNTS))
    for g, w in zip(got, want):
        assert (g.target, g.num_cores, g.strategy) == (
            w.target, w.num_cores, w.strategy)
        assert g.hit_rates == w.hit_rates
        for f in ("t_pred_s", "t_mem_s", "t_cpu_s"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-12)
    for cores in (1, 4):
        assert port.ground_truth_hit_rates(port_t, cores) == \
            ref.ground_truth_hit_rates(ref_t, cores)
        rates, prd, crd_p = port.hit_rates(port_t, cores, strategy="uniform")
        r_rates, r_prd, r_crd = ref.hit_rates(ref_t, cores, strategy="uniform")
        assert rates == r_rates
        assert same_profile(prd, r_prd) and same_profile(crd_p, r_crd)


def test_tasklist_json_is_byte_identical(traces, tmp_path):
    port_t, ref_t = traces
    name = "i7-5960X"
    p = port_predictor(name).predict(port_t, 4, OpCounts(**COUNTS),
                                     keep_profiles=True)
    r = ref_predictor_for(name).predict(ref_t, 4, RefOpCounts(**COUNTS),
                                        keep_profiles=True)
    port_task = tasklist.Task("strided", 4, OpCounts(**COUNTS), 8,
                              p.private_profile, p.shared_profile)
    ref_task = ref_tasklist.Task("strided", 4, RefOpCounts(**COUNTS), 8,
                                 r.private_profile, r.shared_profile)
    tasklist.save_tasklist([port_task], str(tmp_path / "port.json"))
    ref_tasklist.save_tasklist([ref_task], str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()
    for path in ("port.json", "ref.json"):
        (loaded,) = tasklist.load_tasklist(str(tmp_path / path))
        assert loaded.name == "strided" and loaded.num_cores == 4
        assert same_profile(loaded.private_profile, p.private_profile)
        assert same_profile(loaded.shared_profile, p.shared_profile)
        assert vars(loaded.counts) == vars(OpCounts(**COUNTS))
