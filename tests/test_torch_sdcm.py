"""SDCM maths (paper Eq. 1-3): the kernel's plain PyTorch version
against the JAX package's Pallas kernel (interpret mode) and float64
oracle; the port's batched grid against the reference's on the
reference's own profiles; composition invariance and launch-shape
accounting.  Tests of the CUDA kernel itself are marked ``cuda``."""
from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AnalyticalSDCM as RefSDCM
from repro.api import Session as RefSession
from repro.api import batched as ref_batched
from repro.core import sdcm as ref_sdcm
from repro.core.reuse.profile import profile_from_distances as ref_profile
from repro.core.trace.types import trace_from_blocks as ref_trace_from_blocks
from repro.hw.targets import ALL_TARGETS as REF_TARGETS
from repro.kernels.sdcm import sdcm_hit_probs as ref_sdcm_hit_probs

from repro_torch import interop
from repro_torch.api import AnalyticalSDCM, ProfileArtifacts, batched
from repro_torch.core import sdcm
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.kernels import sdcm as kernel
from repro_torch.api import PredictionRequest, Session
from repro_torch.workloads.polybench import make_atax

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)

GEOMS = [(1, 64), (4, 512), (8, 4096), (20, 327680), (64, 1024),
         (16, 327680), (64, 64), (262144, 262144)]


def distances(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.array([-1, 0, 1, 7, 8, 19, 20, 21, 63, 64, 65], np.int64),
        rng.integers(-1, 60_000, n),
    ])[: max(n, 1)]


@pytest.mark.parametrize("n", [1, 7, 1024, 1025])
@pytest.mark.parametrize("assoc,blocks", [(1, 64), (4, 512), (8, 4096),
                                          (20, 327680)])
def test_plain_hit_probs_vs_pallas_kernel_and_oracle(n, assoc, blocks):
    d = distances(n, n + assoc).astype(np.float32)
    got = kernel.sdcm_hit_probs(torch.from_numpy(d), assoc, blocks)
    assert got.dtype == torch.float32 and got.shape == (len(d),)
    pallas = np.asarray(ref_sdcm_hit_probs(
        jnp.asarray(d), assoc=assoc, blocks=blocks, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=0)
    oracle = ref_sdcm.phit_given_d_np(d.astype(np.int64), assoc, blocks)
    np.testing.assert_allclose(got.numpy(), oracle, atol=5e-5, rtol=0)


@pytest.mark.parametrize("assoc,blocks", GEOMS)
def test_plain_phit_vs_float64_oracle(assoc, blocks):
    d = np.concatenate([distances(200, assoc),
                        np.random.default_rng(1).integers(0, 2_000_000, 60)])
    a_max = kernel.a_max_bucket(assoc, blocks)
    got = kernel.phit_plain(torch.from_numpy(d), torch.tensor(float(assoc)),
                            torch.tensor(float(blocks)), a_max).numpy()
    oracle = ref_sdcm.phit_given_d_np(d, assoc, blocks)
    np.testing.assert_allclose(got, oracle, atol=1e-8, rtol=0)


def test_float64_oracle_is_bit_identical():
    d = distances(300, 4)
    for assoc, blocks in GEOMS[:6]:
        assert np.array_equal(sdcm.phit_given_d_np(d, assoc, blocks),
                              ref_sdcm.phit_given_d_np(d, assoc, blocks))
    p = ref_profile(d)
    port_p = interop.profile_from_arrays(p.distances, p.counts, p.total)
    assert sdcm.hit_rate(port_p, 8, 512) == ref_sdcm.hit_rate(p, 8, 512)


def small_trace(iters=400, stride=8):
    blocks = [("entry", np.array([0, 8]), True)]
    a0, b0 = 1 << 20, 2 << 20
    for i in range(iters):
        blocks.append((
            "body", np.array([a0 + stride * i, b0 + stride * (i % 64), 0]),
            np.array([False, False, True]),
        ))
    return ref_trace_from_blocks(blocks)


def carried_target(ref_t):
    fields = dataclasses.asdict(ref_t)
    fields.pop("name")
    fields.pop("levels", None)
    return interop.target_from_fields(
        ref_t.name, [dataclasses.asdict(lv) for lv in ref_t.levels], **fields)


def carried_artifacts(art):
    def prof(p):
        return interop.profile_from_arrays(p.distances, p.counts, p.total)
    return ProfileArtifacts(
        trace_id=art.trace_id, cores=art.cores, strategy=art.strategy,
        seed=art.seed, line_size=art.line_size, privates=[], shared=None,
        prd=prof(art.prd), crd=prof(art.crd))


@pytest.fixture(scope="module")
def reference_grid():
    """Every geometry of all five targets, on the reference's profiles."""
    trace = small_trace()
    sess = RefSession()
    items = []
    for name, t in REF_TARGETS.items():
        for cores in (1, 2, 4):
            for strategy in ("round_robin", "uniform"):
                items.append((t, sess.artifacts(
                    trace, cores, strategy=strategy,
                    line_size=t.levels[0].line_size)))
    return items


def test_batched_grid_on_reference_profiles(reference_grid):
    ref_batched_rates = ref_batched.batched_hit_rates(reference_grid)
    ref_oracle = RefSDCM(backend="numpy").hit_rates_grid(reference_grid)
    port_items = [(carried_target(t), carried_artifacts(a))
                  for t, a in reference_grid]
    got = batched.batched_hit_rates(port_items, device="cpu")
    via_stage = AnalyticalSDCM("batched", device="cpu").hit_rates_grid(
        port_items)
    assert got == via_stage
    assert len(got) == len(ref_oracle)
    for g, rb, ro in zip(got, ref_batched_rates, ref_oracle):
        assert g.keys() == ro.keys()
        for lvl in g:
            assert g[lvl] == pytest.approx(ro[lvl], abs=1e-6)
            assert g[lvl] == pytest.approx(rb[lvl], abs=1e-6)
    numpy_backend = AnalyticalSDCM("numpy").hit_rates_grid(port_items)
    assert numpy_backend == ref_oracle  # the oracle path: same bits


def mixed_rows(g, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(g):
        m = int(rng.integers(1, 70))
        dist = np.unique(rng.integers(0, 400_000, m))
        if rng.random() < 0.7:
            dist = np.concatenate([[-1], dist[1:]])
        counts = rng.integers(1, 1000, len(dist)).astype(np.int64)
        prof = ReuseProfile(dist.astype(np.int64), counts, int(counts.sum()))
        assoc, blocks = GEOMS[int(rng.integers(0, len(GEOMS)))]
        rows.append((i, "L", prof, assoc, blocks))
    return rows


def rates_of(rows):
    out = np.zeros(len(rows))
    for grp in batched.pack_grid(rows, device="cpu"):
        r = kernel.sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks,
                              grp.a_max)
        out[grp.rows] = r[:len(grp.rows)].numpy()
    return out


def test_composition_invariance_in_a_4096_row_batch():
    rows = mixed_rows(4096, 0)
    batch = rates_of(rows)
    assert np.isfinite(batch).all()
    for i in range(0, 4096, 16):
        alone = rates_of([rows[i]])
        assert alone[0] == batch[i], i  # identical bits


def ragged_rates(rows):
    return kernel.sdcm_rates_ragged(
        *batched.pack_ragged(rows, device="cpu")).numpy()


def test_ragged_plain_equals_the_per_group_plain_version():
    rows = mixed_rows(300, 3)
    assert np.array_equal(ragged_rates(rows), rates_of(rows))  # same bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ragged_rows_are_composition_invariant(seed):
    """Any split of the rows, in any order, gives each row its bits."""
    rows = mixed_rows(200, 10 + seed)
    whole = ragged_rates(rows)
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, 200), size=5, replace=False))
    got = np.full(200, np.nan)
    for part in np.split(rng.permutation(200), cuts):
        got[part] = ragged_rates([rows[i] for i in part])
    assert np.array_equal(got, whole)


def test_ragged_records_out_of_range_give_nan():
    d = torch.tensor([0.0, 5.0, 100.0], dtype=torch.float64)
    p = torch.tensor([0.5, 0.25, 0.25], dtype=torch.float64)
    meta = torch.tensor([[0, 3, 4, 512, 8],     # the whole stream
                         [1, 3, 4, 512, 8],     # past its end
                         [0, 3, 4, 512, 12],    # no such bucket
                         [0, 0, 4, 512, 8]],    # empty: rate 0
                        dtype=torch.float64)
    got = kernel.sdcm_rates_ragged(d, p, meta)
    want = kernel.sdcm_rates_plain(d[None], p[None],
                                   torch.tensor([4.0], dtype=torch.float64),
                                   torch.tensor([512.0], dtype=torch.float64),
                                   8)
    assert got[0] == want[0]
    assert torch.isnan(got[1:3]).all() and got[3] == 0.0
    with pytest.raises(ValueError):
        kernel.sdcm_rates_ragged(d, p, meta[:, :4].contiguous())
    with pytest.raises(TypeError):
        kernel.sdcm_rates_ragged(d.float(), p, meta)


def test_one_predict_is_one_ragged_call(monkeypatch):
    calls = []
    real = batched.sdcm_rates_ragged

    def counted(*args):
        calls.append(args[2].shape[0])
        return real(*args)

    monkeypatch.setattr(batched, "sdcm_rates_ragged", counted)
    monkeypatch.setattr(batched, "_SHAPES", set())
    w = make_atax(n=32)
    req = PredictionRequest(targets=("i7-5960X", "EPYC 7702P"),
                            core_counts=(1, 2, 4), counts=w.op_counts)
    sess = Session(device="cpu", cache_model="batched")
    sess.predict(w, req)
    assert len(calls) == 1  # every row of the predict in one call
    assert calls[0] == sum(len(t.levels) for t in
                           (c.target for c in req.cells()))
    assert sess.stats.kernel_shapes > 1  # over several row-shape groups


def test_launch_shape_accounting_matches_reference_groups(monkeypatch):
    rows = mixed_rows(300, 1)
    sizes = {}
    for _, _, p, a, b in rows:
        k = ref_batched._row_shape_key(p, a, b)
        sizes[k] = sizes.get(k, 0) + 1
    want = {("grid", a_max, ref_batched._pow2(n), m)
            for (a_max, m), n in sizes.items()}
    groups = batched.pack_grid(rows, device="cpu")
    assert {g.signature for g in groups} == want
    assert len(groups) == len(want)  # one launch per row-shape group

    monkeypatch.setattr(batched, "_SHAPES", set())
    for sig in sorted(want):
        assert batched._record_signature(sig) == 1
    assert batched.shape_count() == len(want)
    for sig in want:
        assert batched._record_signature(sig) == 0
    assert batched._SHAPES == want


def test_set_associativity_beyond_the_kernel_raises():
    prof = ReuseProfile(np.array([0, 100]), np.array([1, 1]), 2)
    with pytest.raises(ValueError, match="A_MAX"):
        batched.pack_grid([(0, "L", prof, 128, 4096)], device="cpu")
    with pytest.raises(ValueError, match="A_MAX"):
        kernel.sdcm_hit_probs(torch.zeros(4), 65, 4096)
    d = torch.tensor([[0.0, 100.0]], dtype=torch.float64)
    p = torch.tensor([[0.5, 0.5]], dtype=torch.float64)
    out = kernel.sdcm_rates(d, p, torch.tensor([32.0], dtype=torch.float64),
                            torch.tensor([4096.0], dtype=torch.float64), 16)
    assert torch.isnan(out).all()  # a wrong bucket cannot pass silently


def test_empty_and_degenerate_rows_follow_the_oracle():
    empty = ReuseProfile(np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    one = ReuseProfile(np.array([-1, 0, 3]), np.array([2, 1, 1]), 4)
    t = carried_target(REF_TARGETS["i7-5960X"])
    for prof in (empty, one):
        art = ProfileArtifacts("x", 1, "round_robin", 0, 64, [], None,
                               prof, prof)
        got = batched.batched_hit_rates([(t, art)], device="cpu")[0]
        want = AnalyticalSDCM("numpy").hit_rates(t, art)
        for lvl in want:
            assert got[lvl] == pytest.approx(want[lvl], abs=1e-12)
    assert batched.batched_hit_rates([], device="cpu") == []


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "a_max",
                                 "geometry_shape"])
def test_wrapper_rejects_malformed_inputs(bad):
    d = torch.zeros(4, 8, dtype=torch.float64)
    p = torch.zeros(4, 8, dtype=torch.float64)
    a = torch.ones(4, dtype=torch.float64)
    b = torch.full((4,), 8.0, dtype=torch.float64)
    a_max = 8
    if bad == "dtype":
        d = d.float()
    elif bad == "shape":
        p = torch.zeros(4, 9, dtype=torch.float64)
    elif bad == "contiguity":
        d = torch.zeros(8, 4, dtype=torch.float64).t()
    elif bad == "a_max":
        a_max = 12
    else:
        a = torch.ones(3, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        kernel.sdcm_rates(d, p, a, b, a_max)


def test_hit_probs_wrapper_rejects_malformed_inputs():
    with pytest.raises(TypeError):
        kernel.sdcm_hit_probs(torch.zeros(4, dtype=torch.float64), 8, 512)
    with pytest.raises(ValueError):
        kernel.sdcm_hit_probs(torch.zeros(2, 2), 8, 512)
    with pytest.raises(ValueError):
        kernel.sdcm_hit_probs(torch.zeros(4), 0, 512)


def test_cpu_tensors_take_the_plain_version_without_launching():
    before = dict(kernel.LAUNCHES)
    d = torch.from_numpy(distances(100, 3).astype(np.float32))
    assert torch.equal(kernel.sdcm_hit_probs(d, 8, 512),
                       kernel.sdcm_hit_probs_plain(d, 8, 512))
    assert kernel.LAUNCHES == before


# --- the per-reference forms: ragged records, and the mode-start sum --------

PHIT_TOL = 1e-6       # kernel vs plain, P(h|D) (float32 output)


def phit_mode_emulated(d, assoc: int, blocks: int, a_max: int,
                       stirling_from: float = 64.0) -> torch.Tensor:
    """``csrc/sdcm.cu::phit_mode`` step for step in torch float64: T at
    the mode from logarithms (``log_binom``: Stirling's series of both
    lgammas from D - k + 1 = ``stirling_from``, ln n! below), then one walk
    up the terms' ratios from T_0 = 1, rescaled by 2^-600 past 2^600, and
    the sum read against the mode's term; the kernel's rules around the
    sum.  The card's log, exp and tables are not torch's lgamma, so it
    gives the kernel's numerics, not its bits."""
    d = torch.as_tensor(d, dtype=torch.float64)
    a, b = float(assoc), float(blocks)
    if a >= b:                     # fully associative: the stack rule
        return torch.where(d < 0, 0.0, (d < b).to(d.dtype))
    p = min(max(a / b, 1e-30), 1.0 - 1e-7)
    dd = d.clamp_min(a)            # the sum's domain, D >= A
    mode = torch.clamp(torch.floor((dd + 1.0) * p), max=a - 1.0)
    x, y = dd + 1.0, dd - mode + 1.0
    r = 1.0 / (x * y)
    ix, iy = y * r, x * r
    series = ((y - 0.5) * torch.log1p(mode * iy) + mode * torch.log(x) - mode
              + (ix - iy) / 12.0 - (ix ** 3 - iy ** 3) / 360.0)
    diff = torch.where(y < stirling_from,
                       torch.lgamma(x) - torch.lgamma(y), series)
    log_binom = diff - torch.lgamma(mode + 1.0)
    t_mode = torch.exp(log_binom + mode * math.log(p)
                       + (dd - mode) * math.log1p(-p))
    q_up = p / (1.0 - p)
    u, total, u_mode = (torch.ones_like(dd) for _ in range(3))
    top = dd.clone()
    for k in range(1, int(a)):
        u = u * (top * (1.0 / k) * q_up)
        total = total + u
        top = top - 1.0
        u_mode = torch.where(mode == k, u, u_mode)
        big = u > 2.0 ** 600
        u, total, u_mode = (torch.where(big, t * 2.0 ** -600, t)
                            for t in (u, total, u_mode))
    out = (t_mode * (total / u_mode)).clamp_max(1.0)
    if a > a_max:
        out = torch.full_like(out, math.nan)
    out = torch.where(d <= a - 1.0, 1.0, out)
    return torch.where(d < 0, 0.0, out)


def chip_mix(n: int, seed: int) -> np.ndarray:
    """``chip_smoke.py``'s ``[hit_probs]`` draw at a CPU size: a quarter
    first touches, a quarter below 64, a quarter below 4,096 and a
    quarter below 2,000,000."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n)
    return np.where(kind == 0, -1,
                    np.where(kind == 1, rng.integers(0, 64, n),
                             np.where(kind == 2, rng.integers(0, 4096, n),
                                      rng.integers(0, 2_000_000, n)))
                    ).astype(np.float32)


def chip_geometries():
    """``chip_smoke.py``'s ``geometries()``: every level of the Table-5
    CPUs, gpu-sm and tpu-v5e, then (1, 512), (64, 4096), (8, 8)."""
    from repro_torch.hw.targets import ALL_TARGETS

    geoms = [(lvl.effective_assoc, lvl.num_lines)
             for name in ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P",
                          "gpu-sm", "tpu-v5e")
             for lvl in ALL_TARGETS[name].levels]
    return list(dict.fromkeys(geoms + [(1, 512), (64, 4096), (8, 8)]))


#: where a start at k = 0 underflows ((1 - p)^D < 1e-308: p near 1, or
#: long D) or one at A - 1 does (p^(A-1) < 1e-308: tiny p), or both
UNDERFLOW_GEOMS = [(63, 64), (64, 1 << 26), (16, 1 << 26), (1, 512),
                   (8, 16), (64, 4096)]


def underflow_stream() -> np.ndarray:
    rng = np.random.default_rng(7)
    return np.concatenate([
        np.arange(60, 400), np.array([710, 720, 1000, 5000, 45_000,
                                      1 << 20, 1 << 26, 1 << 28]),
        rng.integers(0, 1 << 26, 200)]).astype(np.float32)


@pytest.mark.parametrize("stream", ["chip-mix", "underflow"])
def test_mode_start_sum_matches_the_plain_version(stream):
    """The per-reference kernel's sum from the mode (emulated in f64)
    against the plain version's log-space sum, both cast to float32, at
    every geometry ``[hit_probs]`` runs and at the underflow geometries."""
    if stream == "chip-mix":
        d, geoms = chip_mix(4096, 0), chip_geometries()
    else:
        d, geoms = underflow_stream(), UNDERFLOW_GEOMS
    dt = torch.from_numpy(d)
    worst = 0.0
    for assoc, blocks in geoms:
        a_max = kernel.a_max_bucket(assoc, blocks)
        got = phit_mode_emulated(dt, assoc, blocks, a_max).float()
        want = kernel.sdcm_hit_probs_plain(dt, assoc, blocks)
        assert torch.isfinite(got).all()
        worst = max(worst, float((got - want).abs().max()))
    assert worst <= PHIT_TOL


@pytest.mark.parametrize("assoc,blocks,pallas", [
    (8, 4096, True), (20, 327680, True), (63, 64, True),
    # the Pallas kernel's float32 log-space sum is 4.9e-4 off its own
    # float64 oracle here (at D in the millions): the oracle alone
    (64, 1 << 26, False)])
def test_mode_start_sum_matches_the_reference(assoc, blocks, pallas):
    """The same against the JAX package: its float64 oracle within
    PHIT_TOL, and its Pallas kernel (float32, interpret mode) within the
    2e-5 that the plain version is held to against it."""
    d = np.concatenate([chip_mix(1024, assoc), underflow_stream()])
    got = phit_mode_emulated(torch.from_numpy(d), assoc, blocks,
                             kernel.a_max_bucket(assoc, blocks)).float()
    oracle = ref_sdcm.phit_given_d_np(d.astype(np.int64), assoc, blocks)
    np.testing.assert_allclose(got.numpy(), oracle, atol=PHIT_TOL, rtol=0)
    if pallas:
        kern = np.asarray(ref_sdcm_hit_probs(
            jnp.asarray(d), assoc=assoc, blocks=blocks, interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, atol=2e-5, rtol=0)


def test_lgamma_alone_loses_the_bound_at_large_distances():
    """Why ``log_binom`` switches to Stirling's series: at D ~ 1e8 the
    lgamma difference in f64 moves P(h|D) by more than it does."""
    d = torch.tensor([1e8 + 17.0, 3e8 + 5.0, 9e8 + 1.0], dtype=torch.float64)
    for assoc in (16, 64):
        blocks = int(assoc * 1.0e8)   # the mode near the middle of the sum
        series = phit_mode_emulated(d, assoc, blocks, 64)
        direct = phit_mode_emulated(d, assoc, blocks, 64,
                                    stirling_from=math.inf)
        want = kernel.phit_plain(d, torch.tensor(float(assoc)),
                                 torch.tensor(float(blocks)), 64)
        assert float((series - want).abs().max()) < 1e-9
        assert float((direct - series).abs().max()) > 1e-9


def prob_records(geoms, lengths, offsets):
    """``sdcm_hit_probs_ragged``'s records: one per (geometry, slice),
    outputs back to back."""
    meta, at = [], 0
    for (a, b), n, off in zip(geoms, lengths, offsets):
        meta.append((off, n, a, b, kernel.a_max_bucket(a, b), at))
        at += n
    return torch.tensor(meta, dtype=torch.float64), at


def test_ragged_hit_probs_plain_equals_the_per_geometry_plain_version():
    """Bit for bit, each record's slice as ``sdcm_hit_probs_plain`` gives
    it alone: set-associative, fully associative and the A = 1 rule, over
    two slices of one stream (a sweep's PRD and CRD)."""
    d = torch.from_numpy(np.concatenate([chip_mix(300, 1), chip_mix(200, 2)]))
    geoms = [(8, 512), (16, 4096), (1, 64), (20, 327680), (64, 1024),
             (4096, 4096), (8, 512)]
    lengths = [300, 300, 300, 200, 200, 200, 200]
    offsets = [0, 0, 0, 300, 300, 300, 300]
    meta, size = prob_records(geoms, lengths, offsets)
    got = kernel.sdcm_hit_probs_ragged(d, meta, size)
    assert got.dtype == torch.float32 and got.shape == (size,)
    at = 0
    for (a, b), n, off in zip(geoms, lengths, offsets):
        want = kernel.sdcm_hit_probs_plain(d[off:off + n], a, b)
        assert torch.equal(got[at:at + n], want)
        at += n


def test_ragged_hit_probs_records_out_of_range():
    d = torch.from_numpy(chip_mix(64, 3))
    meta = torch.tensor([
        (0, 10, 8, 512, 8, 0),       # fine
        (60, 10, 8, 512, 8, 10),     # past the stream: NaN
        (0, 10, 8, 512, 12, 20),     # no such bucket: NaN
        (0, 10, 20, 512, 8, 30),     # A above its bucket: NaN past D 19
        (0, 10, 8, 512, 8, 45),      # output past ``size``: not written
    ], dtype=torch.float64)
    got = kernel.sdcm_hit_probs_ragged(d, meta, 50)
    assert torch.equal(got[:10], kernel.sdcm_hit_probs_plain(d[:10], 8, 512))
    assert torch.isnan(got[10:30]).all() and torch.isnan(got[40:]).all()
    torch.testing.assert_close(
        got[30:40], kernel.sdcm_hit_probs_plain(d[:10], 20, 512, a_max=8),
        rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(got[30:40]).any() and not torch.isnan(got[30:40]).all()


def test_ragged_hit_probs_wrapper_rejects_malformed_inputs():
    d = torch.zeros(8)
    meta = torch.zeros(1, 6, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        kernel.sdcm_hit_probs_ragged(d.double(), meta, 8)
    with pytest.raises(ValueError, match="meta must be 2-D"):
        kernel.sdcm_hit_probs_ragged(d, meta[0], 8)
    with pytest.raises(ValueError, match="shape"):
        kernel.sdcm_hit_probs_ragged(d, torch.zeros(1, 5,
                                                    dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="size"):
        kernel.sdcm_hit_probs_ragged(d, meta, -1)
    before = dict(kernel.LAUNCHES)
    kernel.sdcm_hit_probs_ragged(d, meta, 8)
    assert kernel.LAUNCHES == before
