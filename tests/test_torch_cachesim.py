"""The exact-LRU simulator and its stage: ``core/cachesim.py``,
``ExactLRU`` and ``Session.ground_truth_hit_rates`` of the port
(``device="cpu"``) against the JAX package's, equal as integers and as
floats."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.api import ExactLRU as RefExactLRU
from repro.api import PredictionRequest as RefRequest
from repro.api import Session as RefSession
from repro.core import cachesim as ref_cachesim
from repro.workloads import registry as ref_registry

from repro_torch.api import ExactLRU, PredictionRequest, Session
from repro_torch.api.stages import ProfileArtifacts
from repro_torch.core import cachesim
from repro_torch.core.levels import CacheLevelConfig
from repro_torch.core.trace.types import trace_from_blocks
from repro_torch.hw.targets import resolve_target
from repro_torch.workloads import registry

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)

TARGETS = ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P", "gpu-sm", "tpu-v5e")


def brute_force_lru(addresses, cfg: CacheLevelConfig) -> np.ndarray:
    """Straightforward set-associative LRU (the reference test's)."""
    sets: list[list[int]] = [[] for _ in range(cfg.num_sets)]
    hits = np.zeros(len(addresses), dtype=bool)
    for i, a in enumerate(addresses):
        line = a // cfg.line_size
        ways = sets[line % cfg.num_sets]
        if line in ways:
            hits[i] = True
            ways.remove(line)
        elif len(ways) >= cfg.effective_assoc:
            ways.pop()
        ways.insert(0, line)
    return hits


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("geometry", [(256, 16, 1), (256, 16, 4),
                                      (512, 32, 2), (1024, 64, 16)])
def test_level_mask_equals_reference_and_brute_force(geometry, seed):
    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, 4096, int(rng.integers(1, 500)))
    cfg = CacheLevelConfig("T", *geometry)
    got = cachesim.simulate_level(addrs, cfg, device="cpu")
    assert got.dtype == torch.bool and got.device.type == "cpu"
    ref_cfg = ref_cachesim.CacheLevelConfig("T", *geometry)
    assert np.array_equal(got.numpy(),
                          ref_cachesim.simulate_level(addrs, ref_cfg))
    assert np.array_equal(got.numpy(), brute_force_lru(addrs, cfg))


def test_fully_associative():
    cfg = CacheLevelConfig("FA", 4 * 64, 64, 1000)  # 4 lines
    hit = cachesim.simulate_level(np.array([0, 64, 128, 192, 0]), cfg,
                                  device="cpu")
    assert hit.tolist() == [False] * 4 + [True]
    hit = cachesim.simulate_level(np.array([0, 64, 128, 192, 256, 0]), cfg,
                                  device="cpu")
    assert hit.tolist() == [False] * 6


@pytest.mark.parametrize("n", [0, 1, 5000])
def test_hierarchy_results_equal_reference(n):
    rng = np.random.default_rng(3)
    addrs = rng.integers(0, 1 << 16, size=n)
    geoms = [("L1", 1024, 64, 4), ("L2", 16 * 1024, 64, 8),
             ("L3", 64 * 1024, 64, 1 << 20)]
    got = cachesim.simulate_hierarchy(
        addrs, [CacheLevelConfig(*g) for g in geoms], device="cpu")
    want = ref_cachesim.simulate_hierarchy(
        addrs, [ref_cachesim.CacheLevelConfig(*g) for g in geoms])
    assert [vars(r) for r in got] == [vars(r) for r in want]
    if n:
        assert got[1].accesses == got[0].accesses - got[0].hits
        assert got[1].cumulative_hit_rate >= got[0].cumulative_hit_rate


def test_empty_hierarchy_input():
    (res,) = cachesim.simulate_hierarchy(
        [], [CacheLevelConfig("L1", 1024, 64, 4)], device="cpu")
    assert (res.hits, res.accesses, res.cumulative_hit_rate) == (0, 0, 1.0)


@pytest.fixture(scope="module", params=["polybench/atx", "polybench/mvt",
                                        "synthetic/stride"])
def workload_pair(request):
    return (registry.resolve(request.param, "smoke"),
            ref_registry.resolve(request.param, "smoke"))


def test_ground_truth_equals_reference(workload_pair):
    port_w, ref_w = workload_pair
    port, ref = Session(device="cpu"), RefSession()
    for target in TARGETS:
        for cores in (1, 2, 4):
            got = port.ground_truth_hit_rates(port_w, target, cores)
            assert got == ref.ground_truth_hit_rates(ref_w, target, cores), (
                target, cores)


def test_exact_lru_cache_model_equals_reference(workload_pair):
    port_w, ref_w = workload_pair
    kw = dict(targets=TARGETS, core_counts=(1, 2, 4),
              strategies=("round_robin", "uniform"), seed=2)
    port = Session(device="cpu", cache_model=ExactLRU())
    assert port.cache_model.device == torch.device("cpu")
    got = port.predict(port_w, PredictionRequest(**kw))
    want = RefSession(cache_model=RefExactLRU()).predict(
        ref_w, RefRequest(**kw))
    assert got.cache_model == want.cache_model == "exact-lru"
    assert got.to_json() == want.to_json()
    # the stage alone, on the Session's artifacts
    target = resolve_target("i7-5960X")
    art = port.artifacts(port_w, 4, line_size=64)
    assert (ExactLRU(device="cpu").hit_rates(target, art)
            == port.ground_truth_hit_rates(port_w, target, 4))


def test_private_levels_aggregate_over_cores():
    w = registry.resolve("atx", "smoke")
    target = resolve_target("i7-5960X")
    art = Session(device="cpu").artifacts(w, 4, line_size=64)
    rates = ExactLRU(device="cpu").hit_rates(target, art)
    priv = list(target.levels)[:2]
    misses = np.zeros(2, dtype=np.int64)
    for p in art.privates:
        for i, r in enumerate(cachesim.simulate_hierarchy(
                p.addresses, priv, device="cpu")):
            misses[i] += r.accesses - r.hits
    total = sum(len(p) for p in art.privates)
    for i, lvl in enumerate(priv):
        assert rates[lvl.name] == 1.0 - misses[i] / total


def small_trace(iters=400, stride=8, from_blocks=trace_from_blocks):
    """The reference's streaming-session test trace."""
    blocks = [("OUT__1__.entry", np.array([0, 8]), True)]
    a0, b0 = 1 << 20, 2 << 20
    for i in range(iters):
        blocks.append(("OUT__1__.for.body",
                       np.array([a0 + stride * i, b0 + stride * (i % 64), 0]),
                       np.array([False, False, True])))
    return from_blocks(blocks)


def test_exact_lru_rejects_streaming_and_trace_less_artifacts():
    target = resolve_target("i7-5960X")
    art = Session(device="cpu", window_size=256).artifacts(small_trace(), 2)
    assert art.shared is None and art.has_traces
    with pytest.raises(ValueError, match="streaming"):
        ExactLRU(device="cpu").hit_rates(target, art)
    bare = ProfileArtifacts(
        trace_id="t", cores=2, strategy="round_robin", seed=0, line_size=64,
        privates=[], shared=None, prd=art.prd, crd=art.crd)
    assert not bare.has_traces
    with pytest.raises(ValueError, match="need_traces=True"):
        ExactLRU(device="cpu").hit_rates(target, bare)
    assert ExactLRU.needs_traces


def test_ground_truth_works_on_streaming_session():
    """ground_truth_hit_rates forces in-memory artifacts, so a streaming
    Session still serves exact-LRU validation."""
    from repro.core.trace.types import trace_from_blocks as ref_from_blocks

    trace = small_trace()
    target = resolve_target("i7-5960X")
    want = RefSession().ground_truth_hit_rates(
        small_trace(from_blocks=ref_from_blocks), target.name, 4)
    streaming = Session(device="cpu", window_size=256)
    assert streaming.ground_truth_hit_rates(trace, target, 4) == want
    assert Session(device="cpu").ground_truth_hit_rates(trace, target, 4) == want
