"""The port's CUDA kernels on the card: the SDCM kernel's entry points
(the grid forms, and the per-reference forms: one geometry and ragged),
the reuse-histogram kernel's two flags, flash attention (B4, each of its
forms, with the launches counted by form, with and without a sliding
window) and the SSD scan
(B5, f32 and bf16 b/c, column blocks) against their plain PyTorch
versions, launch counting,
composition invariance of the SDCM grid form, bit-reproducibility of
the histogram (from two threads and streams at once too), the MoE
layer's dispatch, grouped GEMM and combine kernels (and the layer
without a host sync), streaming reuse distances, a binned Session and the
reduced serving paths on the card (zamba2, and the windowed MoE
transformer), B4's and B5's gradients (their ``autograd.Function``s)
and a reduced training step, the repeated host syncs of a reduced
mixtral decode against the TS lint rules, the fused config sweep in both inner
forms and the artifact store on the card.  Imports nothing of JAX, so
it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""
from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.api import PredictionRequest, Session, batched
from repro_torch.core.reuse.distance import (
    reuse_distances,
    reuse_distances_streaming,
)
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe as kmoe
from repro_torch.kernels import reuse_hist
from repro_torch.kernels import ssd_scan as scan
from repro_torch.configs.reduced import reduced_arch
from repro_torch.launch import serve
from repro_torch.models import hybrid, moe, transformer
from repro_torch.kernels import sdcm as kernel
from repro_torch.workloads.polybench import make_atax

pytestmark = pytest.mark.cuda

# bf16 attention, besides the absolute 3e-2: max |kernel - plain| over
# max |plain|, since a decode row over 2048 columns has outputs of ~0.04
BF16_SCALED_TOL = 1e-2

GEOMS = [(1, 64), (4, 512), (8, 4096), (20, 327680), (64, 1024),
         (16, 327680), (64, 64), (262144, 262144)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def distances(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        np.array([-1, 0, 1, 7, 8, 19, 20, 21, 63, 64, 65]),
        rng.integers(-1, 2_000_000, n),
    ]).astype(np.float32)


def mixed_rows(g, seed):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(g):
        m = int(rng.integers(1, 257))
        dist = np.unique(rng.integers(0, 1_500_000, m))
        if rng.random() < 0.7:
            dist = np.concatenate([[-1], dist[1:]])
        counts = rng.integers(1, 1000, len(dist)).astype(np.int64)
        prof = ReuseProfile(dist.astype(np.int64), counts, int(counts.sum()))
        assoc, blocks = GEOMS[int(rng.integers(0, len(GEOMS)))]
        rows.append((i, "L", prof, assoc, blocks))
    return rows


@pytest.mark.parametrize("assoc,blocks", GEOMS)
def test_hit_probs_kernel_vs_plain(cuda_device, assoc, blocks):
    d = torch.from_numpy(distances(100_000, assoc)).to(cuda_device)
    before = kernel.LAUNCHES["sdcm_hit_probs"]
    got = kernel.sdcm_hit_probs(d, assoc, blocks)
    assert kernel.LAUNCHES["sdcm_hit_probs"] == before + 1
    assert got.device == d.device and got.dtype == torch.float32
    want = kernel.sdcm_hit_probs_plain(d, assoc, blocks)
    assert float((got - want).abs().max()) <= 1e-6


def test_ragged_hit_probs_kernel_vs_one_geometry_kernel(cuda_device):
    """Every geometry of GEOMS over two slices of one stream (a sweep's
    PRD and CRD) in one ragged launch: each record's P(h|D) element for
    element the one-geometry launch's on its slice, and within 1e-6 of
    the plain version; then streams where a sum started at k = 0 or at A
    - 1 would underflow."""
    d = torch.from_numpy(np.concatenate([distances(20_000, 1),
                                         distances(7_000, 2)])).to(cuda_device)
    slices = ((0, 20_011), (20_011, 7_011))
    meta, at = [], 0
    for off, n in slices:
        for a, b in GEOMS:
            meta.append((off, n, a, b, kernel.a_max_bucket(a, b), at))
            at += n
    before = dict(kernel.LAUNCHES)
    got = kernel.sdcm_hit_probs_ragged(
        d, torch.tensor(meta, dtype=torch.float64, device=cuda_device), at)
    assert kernel.LAUNCHES["sdcm_hit_probs_ragged"] == \
        before["sdcm_hit_probs_ragged"] + 1
    assert kernel.LAUNCHES["sdcm_hit_probs"] == before["sdcm_hit_probs"]
    for off, n, a, b, _, o in meta:
        part = d[off:off + n]
        assert torch.equal(got[o:o + n], kernel.sdcm_hit_probs(part, a, b))
        want = kernel.sdcm_hit_probs_plain(part, a, b)
        assert float((got[o:o + n] - want).abs().max()) <= 1e-6
    rng = np.random.default_rng(7)
    low = torch.from_numpy(np.concatenate([
        np.arange(60, 400), [710, 720, 1000, 5000, 45_000, 1 << 20, 1 << 26],
        rng.integers(0, 1 << 26, 2000)]).astype(np.float32)).to(cuda_device)
    for a, b in ((63, 64), (64, 1 << 26), (16, 1 << 26), (1, 512), (8, 16)):
        err = (kernel.sdcm_hit_probs(low, a, b)
               - kernel.sdcm_hit_probs_plain(low, a, b)).abs().max()
        assert float(err) <= 1e-6


def test_rates_kernel_vs_plain_and_composition_invariance(cuda_device):
    rows = mixed_rows(1024, 2)
    batch = np.zeros(len(rows))
    for grp in batched.pack_grid(rows, device=cuda_device):
        args = (grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        before = kernel.LAUNCHES["sdcm_rates"]
        got = kernel.sdcm_rates(*args)
        assert kernel.LAUNCHES["sdcm_rates"] == before + 1
        want = kernel.sdcm_rates_plain(*args)
        assert float((got - want).abs().max()) <= 1e-6
        batch[grp.rows] = got[:len(grp.rows)].cpu().numpy()
    for i in range(0, len(rows), 4):
        (grp,) = batched.pack_grid([rows[i]], device=cuda_device)
        alone = kernel.sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks,
                                  grp.a_max)
        assert alone[0].item() == batch[i]


def test_ragged_kernel_vs_plain_and_per_group_kernel(cuda_device):
    rows = mixed_rows(1024, 3)
    args = batched.pack_ragged(rows, device=cuda_device)
    before = dict(kernel.LAUNCHES)
    got = kernel.sdcm_rates_ragged(*args)
    assert kernel.LAUNCHES["sdcm_rates_ragged"] == \
        before["sdcm_rates_ragged"] + 1
    want = kernel.sdcm_rates_ragged_plain(*args)
    assert float((got - want).abs().max()) <= 1e-6
    per_group = np.zeros(len(rows))
    for grp in batched.pack_grid(rows, device=cuda_device):
        out = kernel.sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks,
                                grp.a_max)
        per_group[grp.rows] = out[:len(grp.rows)].cpu().numpy()
    assert np.array_equal(got.cpu().numpy(), per_group)  # same bits
    for i in range(0, len(rows), 7):  # each row alone: its bits again
        alone = kernel.sdcm_rates_ragged(
            *batched.pack_ragged([rows[i]], device=cuda_device))
        assert alone.item() == per_group[i]


def test_ragged_records_out_of_range_give_nan_on_the_card(cuda_device):
    d = torch.tensor([0.0, 5.0, 100.0], dtype=torch.float64,
                     device=cuda_device)
    p = torch.full((3,), 1 / 3, dtype=torch.float64, device=cuda_device)
    meta = torch.tensor([[0, 3, 4, 512, 8], [1, 3, 4, 512, 8],
                         [0, 3, 4, 512, 12], [0, 0, 4, 512, 8],
                         [-1, 2, 4, 512, 8], [0, 3, 32, 4096, 16]],
                        dtype=torch.float64, device=cuda_device)
    got = kernel.sdcm_rates_ragged(d, p, meta).cpu()
    want = kernel.sdcm_rates_ragged_plain(d, p, meta).cpu()
    assert torch.isnan(got[[1, 2, 4, 5]]).all() and got[3] == 0.0
    assert torch.equal(got.isnan(), want.isnan())
    assert abs(float(got[0] - want[0])) <= 1e-15


@pytest.mark.parametrize("kw", [dict(), dict(binned=True),
                                dict(window_size=1024)],
                         ids=["exact", "binned", "streaming"])
def test_one_sdcm_launch_per_predict(cuda_device, kw):
    w = make_atax(n=64)
    req = PredictionRequest(targets=("i7-5960X", "EPYC 7702P"),
                            core_counts=(1, 2, 4))
    sess = Session(device=cuda_device, cache_model="batched", **kw)
    for _ in range(2):  # cold, then warm
        before = dict(kernel.LAUNCHES)
        sess.predict(w, req)
        assert kernel.LAUNCHES["sdcm_rates_ragged"] == \
            before["sdcm_rates_ragged"] + 1
        assert kernel.LAUNCHES["sdcm_rates"] == before["sdcm_rates"]


def test_kernel_flags_a_wrong_bucket(cuda_device):
    d = torch.tensor([[0.0, 100.0]], dtype=torch.float64, device=cuda_device)
    p = torch.tensor([[0.5, 0.5]], dtype=torch.float64, device=cuda_device)
    a = torch.tensor([32.0], dtype=torch.float64, device=cuda_device)
    b = torch.tensor([4096.0], dtype=torch.float64, device=cuda_device)
    assert torch.isnan(kernel.sdcm_rates(d, p, a, b, 16)).all()


def test_wrappers_reject_mixed_devices(cuda_device):
    d = torch.zeros(2, 4, dtype=torch.float64, device=cuda_device)
    p = torch.zeros(2, 4, dtype=torch.float64)
    g = torch.ones(2, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        kernel.sdcm_rates(d, p, g, g, 8)


def test_reuse_distances_on_the_card_match_the_cpu(cuda_device):
    rng = np.random.default_rng(4)
    addrs = rng.integers(0, 20_000, 200_000) * 8
    got = reuse_distances(addrs, 64, device=cuda_device)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), reuse_distances(addrs, 64, device="cpu"))


def hist_inputs(n, seed, device):
    rng = np.random.default_rng(seed)
    d = rng.integers(-1, 1 << 28, n)
    if n >= 4:
        d[:4] = [-1, 0, 1, (1 << 40) + 3]
    w = rng.random(n).astype(np.float32)
    return (torch.from_numpy(d).to(device), torch.from_numpy(w).to(device))


@pytest.mark.parametrize("moments", [True, False], ids=["B2", "B3"])
@pytest.mark.parametrize("n", [1, 5, 4096, 4097, 1 << 20])
def test_reuse_hist_kernel_vs_plain(cuda_device, moments, n):
    fn = (reuse_hist.reuse_histogram_moments if moments
          else reuse_hist.reuse_histogram)
    plain = (reuse_hist.reuse_histogram_moments_plain if moments
             else reuse_hist.reuse_histogram_plain)
    name = "reuse_hist_moments" if moments else "reuse_hist"
    d, w = hist_inputs(n, n, cuda_device)
    before = reuse_hist.LAUNCHES[name]
    got = fn(d)
    assert reuse_hist.LAUNCHES[name] == before + 1
    assert got.device == d.device and got.dtype == torch.float64
    # unit weights: integer sums below 2^53, exact in any order
    assert torch.equal(got, plain(d))
    assert torch.equal(got, fn(d))  # bit-reproducible
    got_w, want_w = fn(d, w), plain(d, w)
    assert torch.allclose(got_w, want_w, rtol=1e-12, atol=0.0)


def hist_case(name, device):
    """Inputs where contention or a 64-bit sum would show: one bin for
    2^24 distances (sum past 2^64), the clamped top bin, 2^40-sized
    distances summing past 2^53, and a slice that starts between two
    16-byte words."""
    if name == "one_bin":
        return torch.full((1 << 24,), (1 << 40) + 7, dtype=torch.int64,
                          device=device)
    if name == "top_bin":
        return torch.tensor([1 << 62, (1 << 63) - 1] * 5000 + [-1, 0, 3],
                            dtype=torch.int64, device=device)
    if name == "many_2^40":
        k = torch.arange(300_000, dtype=torch.int64, device=device)
        return (1 << 40) + 4 * k + 3
    rng = np.random.default_rng(9)
    d = torch.from_numpy(rng.integers(-1, 1 << 30, 100_003)).to(device)
    return d[1:]  # 8 bytes past an aligned start, odd length


@pytest.mark.parametrize("moments", [True, False], ids=["B2", "B3"])
@pytest.mark.parametrize("case", ["one_bin", "top_bin", "many_2^40",
                                  "unaligned"])
def test_reuse_hist_exact_at_contention_and_overflow(cuda_device, moments,
                                                     case):
    fn = (reuse_hist.reuse_histogram_moments if moments
          else reuse_hist.reuse_histogram)
    plain = (reuse_hist.reuse_histogram_moments_plain if moments
             else reuse_hist.reuse_histogram_plain)
    d = hist_case(case, cuda_device)
    first, second = fn(d), fn(d)
    assert torch.equal(first, plain(d))  # every sum, above 2^53 too
    assert torch.equal(first, second)    # bit-reproducible


def test_reuse_hist_out_adds_in_place(cuda_device):
    d1, w = hist_inputs(5000, 1, cuda_device)
    d2 = hist_case("top_bin", cuda_device)
    out = reuse_hist.reuse_histogram_moments(d1)
    reuse_hist.reuse_histogram_moments(d2, out=out)
    plain = reuse_hist.reuse_histogram_moments_plain
    assert torch.equal(out, plain(d1) + plain(d2))
    before = out.clone()
    reuse_hist.reuse_histogram_moments(d1, w, out=out)
    assert torch.allclose(out, before + plain(d1, w), rtol=1e-12, atol=0.0)


@pytest.mark.parametrize("streams", ["own", "default"])
def test_reuse_hist_from_two_threads(cuda_device, streams):
    """Two threads launch B2 unit-weight histograms in a loop, each on a
    stream of its own (or both on the default stream): every result
    equals the plain version exactly, so a stream never sees another's
    partial sums in the integer accumulator."""
    rng = np.random.default_rng(11)
    inputs = [torch.from_numpy(np.floor(2.0 ** rng.uniform(0, 40, 1 << 20))
                               .astype(np.int64)).to(cuda_device)
              for _ in range(2)]
    wants = [reuse_hist.reuse_histogram_moments_plain(d) for d in inputs]
    torch.cuda.synchronize()
    barrier = threading.Barrier(2)
    results, errors = ([], []), []

    def work(i):
        try:
            stream = (torch.cuda.Stream(cuda_device) if streams == "own"
                      else torch.cuda.default_stream(cuda_device))
            with torch.cuda.stream(stream):
                barrier.wait()
                for _ in range(50):
                    results[i].append(
                        reuse_hist.reuse_histogram_moments(inputs[i]))
                stream.synchronize()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    for got, want in zip(results, wants):
        assert len(got) == 50
        for hist in got:
            assert torch.equal(hist, want)


def test_reuse_hist_rejects_mixed_devices(cuda_device):
    d = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError):
        reuse_hist.reuse_histogram_moments(d, torch.ones(4))


def test_streaming_on_the_card_matches_in_memory(cuda_device):
    rng = np.random.default_rng(6)
    addrs = rng.integers(0, 30_000, 300_000) * 8
    whole = reuse_distances(addrs, 64, device=cuda_device)
    for ws in (1 << 12, 1 << 16, 1 << 20):
        got = reuse_distances_streaming(addrs, 64, window_size=ws,
                                        device=cuda_device)
        assert got.device.type == "cuda"
        assert torch.equal(got, whole)


@pytest.mark.parametrize("num_sets", [1, 64, 512, 16384])
@pytest.mark.parametrize("method", ["monolithic", "batched", "auto"])
def test_per_set_distances_on_the_card_match_the_cpu(cuda_device, method,
                                                     num_sets):
    from repro_torch.core.reuse.distance import per_set_reuse_distances

    rng = np.random.default_rng(num_sets)
    addrs = rng.integers(0, 1 << 22, 100_000) * 8
    got = per_set_reuse_distances(addrs, line_size=64, num_sets=num_sets,
                                  method=method, device=cuda_device)
    assert got.device.type == "cuda"
    want = per_set_reuse_distances(addrs, line_size=64, num_sets=num_sets,
                                   device="cpu")
    assert torch.equal(got.cpu(), want)


def test_offline_engine_makes_no_host_synchronisation(cuda_device):
    """The dominance count, the offline pass and both per-set methods on
    tensors already on the card, with any host synchronisation an
    error: every size follows from the length alone."""
    from repro_torch.core.reuse.batched import (
        count_leq_before,
        reuse_distances_offline,
    )
    from repro_torch.core.reuse.distance import per_set_reuse_distances

    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.integers(-1, 5000, 300_001)).to(cuda_device)
    lines = torch.from_numpy(rng.integers(0, 40_000, 300_001)).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        counts = count_leq_before(vals)
        rds = reuse_distances_offline(lines)
        per_set = {m: per_set_reuse_distances(lines, line_size=1,
                                              num_sets=512, method=m,
                                              device=cuda_device)
                   for m in ("monolithic", "batched")}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(counts.cpu(), count_leq_before(vals.cpu()))
    assert torch.equal(rds.cpu(), reuse_distances_offline(lines.cpu()))
    want = per_set_reuse_distances(lines.cpu(), line_size=1, num_sets=512,
                                   device="cpu")
    assert all(torch.equal(t.cpu(), want) for t in per_set.values())


@pytest.mark.parametrize("shards", [1, 3])
def test_batched_segments_on_the_card_match_the_cpu(cuda_device, shards):
    from repro_torch.core.reuse.batched import reuse_distances_batched

    rng = np.random.default_rng(8)
    segs = [rng.integers(0, max(int(k) // 3, 1), int(k))
            for k in rng.integers(0, 600, 200)]
    got = reuse_distances_batched(segs, num_shards=shards, device=cuda_device)
    want = reuse_distances_batched(segs, device="cpu")
    assert all(g.device.type == "cuda" and torch.equal(g.cpu(), x)
               for g, x in zip(got, want))


@pytest.mark.parametrize("cores", [1, 2, 4])
def test_ground_truth_on_the_card_matches_the_cpu(cuda_device, cores):
    from repro_torch.api import ExactLRU

    w = make_atax(n=64)
    for target in ("i7-5960X", "EPYC 7702P", "gpu-sm", "tpu-v5e"):
        got = Session(device=cuda_device).ground_truth_hit_rates(
            w, target, cores)
        assert got == Session(device="cpu").ground_truth_hit_rates(
            w, target, cores)
    sess = Session(device=cuda_device, cache_model=ExactLRU())
    assert sess.cache_model.device == cuda_device


@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
def test_sampled_profiles_on_the_card_match_the_cpu(cuda_device, rate,
                                                    window):
    w = make_atax(n=64)
    gpu = Session(device=cuda_device, sampled=rate, window_size=window)
    cpu = Session(device="cpu", sampled=rate, window_size=window)
    for cores in (1, 2, 4):
        a, b = gpu.artifacts(w, cores), cpu.artifacts(w, cores)
        for pa, pb in ((a.prd, b.prd), (a.crd, b.crd)):
            assert np.array_equal(pa.distances, pb.distances)
            assert np.array_equal(pa.counts, pb.counts)
            assert pa.error_bound == pb.error_bound


def test_binned_session_launches_the_histogram_kernel(cuda_device):
    w = make_atax(n=64)
    req = PredictionRequest(targets=("i7-5960X",), core_counts=(1, 2, 4))
    exact = Session(device=cuda_device, cache_model="batched").predict(w, req)
    before = reuse_hist.LAUNCHES["reuse_hist_moments"]
    for kw in (dict(), dict(window_size=1024)):
        binned = Session(device=cuda_device, binned=True,
                         cache_model="batched", **kw).predict(w, req)
        for e, b in zip(exact, binned):
            for lvl, rate in e.hit_rates.items():
                assert abs(rate - b.hit_rates[lvl]) < 1e-3
    assert reuse_hist.LAUNCHES["reuse_hist_moments"] > before


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,q_offset,kv_len", [
    (2, 4, 2, 256, 256, 64, True, 0, None),
    (1, 8, 1, 130, 300, 128, False, 0, 250),     # MQA, ragged, kv_len
    (2, 32, 8, 1000, 1000, 128, True, 0, None),  # GQA, ragged Sq
    (4, 32, 32, 1, 2080, 64, True, 2047, 2048),  # decode step
    (2, 4, 4, 9, 40, 64, True, 20, 29),          # chunk into a cache
    (1, 4, 4, 384, 384, 32, True, 0, None),      # the reference's MHA
    (2, 4, 4, 13, 13, 8, True, 0, None),         # reduced configs' D
])
def test_flash_attention_kernel_vs_plain(cuda_device, dtype, atol, b, h, hkv,
                                         sq, sk, d, causal, q_offset, kv_len):
    gen = torch.Generator(device=cuda_device).manual_seed(sq)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.float32).to(dtype)

    # the model's [B, S, H, D] layout, read through strides
    q = rand(b, sq, h, d).transpose(1, 2)
    k = rand(b, sk, hkv, d).transpose(1, 2)
    v = rand(b, sk, hkv, d).transpose(1, 2)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    assert err <= atol
    if dtype == torch.bfloat16:  # decode outputs are far below atol
        assert err / float(want.float().abs().max()) <= BF16_SCALED_TOL


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("b,h,hkv,sq,sk,q_offset,kv_len,form", [
    (4, 32, 32, 1, 2080, 2047, 2048, "split_kv"),   # decode, 16 splits
    (4, 32, 32, 1, 2080, 1999, 2000, "split_kv"),   # not a multiple of 128
    (2, 32, 8, 1, 400, 386, 387, "split_kv"),       # GQA 4:1 decode
    (2, 8, 8, 1, 16, 0, 1, "split_kv"),             # kv_len 1
    (1, 16, 4, 4, 300, 126, 130, "split_kv"),       # 16 rows; rows 0-1 see
                                                    # none of split 2
    (1, 16, 4, 5, 300, 126, 131, "tensor_core"),    # 20 rows
    (2, 16, 16, 17, 300, 200, 217, "tensor_core"),  # 17 rows
    (2, 8, 2, 200, 256, 0, 200, "tensor_core"),     # prefill, ragged tiles
])
def test_flash_attention_forms_vs_plain(cuda_device, d, b, h, hkv, sq, sk,
                                        q_offset, kv_len, form):
    """Each bf16 form on both sides of the 16-row threshold; the launch
    counts the form it ran on."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + kv_len)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.float32).to(torch.bfloat16)

    q = rand(b, sq, h, d).transpose(1, 2)
    k = rand(b, sk, hkv, d).transpose(1, 2)
    v = rand(b, sk, hkv, d).transpose(1, 2)
    assert fa.kernel_form(q, k, v) == form
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    before = dict(fa.LAUNCHES_BY_FORM)
    total = fa.LAUNCHES["flash_attention"]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES["flash_attention"] == total + 1
    assert fa.LAUNCHES_BY_FORM == {
        f: n + (f == form) for f, n in before.items()}
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got.float()).all()
    refs = [want]
    if form == "split_kv":  # the decomposition the kernel follows
        refs.append(fa.split_kv_plain(q, k, v, **kw))
    for ref in refs:
        err = float((got.float() - ref.float()).abs().max())
        assert err <= 3e-2
        assert err / float(ref.float().abs().max()) <= BF16_SCALED_TOL


@pytest.mark.parametrize("dtype,d,b,h,hkv,sq,sk,q_offset,kv_len,window,form", [
    # mixtral-like prefill, band edges mid-tile (W 100, 64-column tiles)
    (torch.bfloat16, 128, 2, 8, 2, 300, 300, 0, 300, 100, "tensor_core"),
    # a chunk into a cache: the block's first tile (edge 488 of 448..511)
    # lies wholly below the band of warps 2 and 3
    (torch.bfloat16, 64, 1, 16, 16, 100, 720, 600, 700, 113, "tensor_core"),
    # decode: splits 3..5 of 128 columns visited (edge 401 mid-split)
    (torch.bfloat16, 128, 2, 32, 8, 1, 700, 600, 601, 200, "split_kv"),
    # 16 rows per kv head, each row its own edge
    (torch.bfloat16, 64, 1, 16, 4, 4, 1100, 1000, 1004, 130, "split_kv"),
    # the tensor-core f32 form, edge mid-tile (32-column tiles at D 128)
    (torch.float32, 64, 1, 4, 2, 200, 200, 0, 200, 77, "tensor_core_f32"),
    (torch.float32, 128, 2, 8, 2, 300, 300, 0, 300, 100, "tensor_core_f32"),
    # the CUDA-core form in f32 at the reduced D 16; a chunk of 4 rows at
    # D 64 (8 rows per kv head) on the f32 split-KV form (the id names the
    # form it took before that form existed)
    (torch.float32, 16, 2, 4, 2, 9, 40, 20, 29, 16, "simt"),
    (torch.float32, 64, 1, 4, 2, 4, 300, 250, 254, 77, "split_kv_f32"),
], ids=["tc-prefill", "tc-chunk", "split-decode", "split-16-rows",
        "tc-f32-prefill", "tc-f32-prefill-d128", "simt-reduced",
        "simt-f32-chunk"])
def test_flash_attention_window_forms_vs_plain(cuda_device, dtype, d, b, h,
                                               hkv, sq, sk, q_offset, kv_len,
                                               window, form):
    """Each form with a sliding window against the plain version (and
    the split-KV form against its decomposition), at the reference's
    bounds."""
    gen = torch.Generator(device=cuda_device).manual_seed(window)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.float32).to(dtype)

    q = rand(b, sq, h, d).transpose(1, 2)
    k = rand(b, sk, hkv, d).transpose(1, 2)
    v = rand(b, sk, hkv, d).transpose(1, 2)
    assert fa.kernel_form(q, k, v) == form
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len, window=window)
    before = fa.LAUNCHES_BY_FORM[form]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES_BY_FORM[form] == before + 1
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    refs = [fa.flash_attention_plain(q, k, v, **kw)]
    if form in ("split_kv", "split_kv_f32"):
        refs.append(fa.split_kv_plain(q, k, v, **kw,
                                      columns=fa.split_columns(dtype)))
    assert torch.isfinite(got.float()).all()
    for ref in refs:
        err = float((got.float() - ref.float()).abs().max())
        assert err <= atol
        if dtype == torch.bfloat16:
            assert err / float(ref.float().abs().max()) <= BF16_SCALED_TOL


@pytest.mark.parametrize("dtype,d,b,h,hkv,sq,sk,causal,q_offset,kv_len,form", [
    # an encoder: bidirectional self-attention, ragged tiles
    (torch.bfloat16, 64, 2, 16, 16, 300, 300, False, 0, 300, "tensor_core"),
    # cross-attention prefill: 200 target rows over 330 source positions
    (torch.bfloat16, 64, 2, 16, 16, 200, 330, False, 0, 330, "tensor_core"),
    (torch.bfloat16, 96, 2, 8, 8, 330, 200, False, 0, 200, "tensor_core"),
    # cross-attention decode: one row over the whole source
    (torch.bfloat16, 64, 4, 16, 16, 1, 2048, False, 0, 2048, "split_kv"),
    (torch.bfloat16, 96, 2, 8, 8, 1, 1000, False, 0, 1000, "split_kv"),
    # phi-3's head dim 96: causal prefill, decode step, GQA
    (torch.bfloat16, 96, 2, 8, 8, 200, 256, True, 0, 200, "tensor_core"),
    (torch.bfloat16, 96, 2, 32, 32, 1, 2080, True, 2047, 2048, "split_kv"),
    (torch.bfloat16, 96, 1, 16, 4, 4, 300, True, 126, 130, "split_kv"),
    # f32 at D 96: the tensor-core f32 form (twelve 8-wide n-tiles of
    # P V), causal and cross; a decode step on the f32 split-KV form (the
    # id names the form it took before that form existed)
    (torch.float32, 96, 2, 4, 4, 130, 130, True, 0, 130, "tensor_core_f32"),
    (torch.float32, 96, 1, 4, 2, 70, 150, False, 0, 140, "tensor_core_f32"),
    (torch.float32, 96, 2, 4, 4, 1, 300, True, 200, 201, "split_kv_f32"),
    (torch.float32, 64, 1, 4, 4, 100, 37, False, 0, 37, "tensor_core_f32"),
    # the CUDA-core form at D 32 without causality, f32 and bf16
    (torch.float32, 32, 2, 4, 4, 100, 37, False, 0, 37, "simt"),
    (torch.bfloat16, 32, 2, 4, 4, 100, 37, False, 0, 37, "simt"),
], ids=["tc-encoder", "tc-cross", "tc-cross-d96", "split-cross",
        "split-cross-d96", "tc-d96", "split-d96", "split-d96-gqa",
        "tc-f32-d96", "tc-f32-d96-cross", "simt-d96-decode", "tc-f32-cross",
        "simt-f32-cross-d32", "simt-bf16-cross-d32"])
def test_flash_attention_non_causal_and_d96_forms_vs_plain(
        cuda_device, dtype, d, b, h, hkv, sq, sk, causal, q_offset, kv_len,
        form):
    """Bidirectional and cross-attention calls (Sq != Sk) and head dim
    96 on each form, against the plain version (and the split-KV form
    against its decomposition), at the reference's bounds."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq * 7 + sk)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device,
                           dtype=torch.float32).to(dtype)

    q = rand(b, sq, h, d).transpose(1, 2)
    k = rand(b, sk, hkv, d).transpose(1, 2)
    v = rand(b, sk, hkv, d).transpose(1, 2)
    assert fa.kernel_form(q, k, v) == form
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    before = fa.LAUNCHES_BY_FORM[form]
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES_BY_FORM[form] == before + 1
    assert got.dtype == dtype and got.stride() == q.stride()
    atol = 2e-5 if dtype == torch.float32 else 3e-2
    refs = [fa.flash_attention_plain(q, k, v, **kw)]
    if form in ("split_kv", "split_kv_f32"):
        refs.append(fa.split_kv_plain(q, k, v, **kw,
                                      columns=fa.split_columns(dtype)))
    assert torch.isfinite(got.float()).all()
    for ref in refs:
        err = float((got.float() - ref.float()).abs().max())
        assert err <= atol
        if dtype == torch.bfloat16:
            assert err / float(ref.float().abs().max()) <= BF16_SCALED_TOL


@pytest.mark.parametrize("d", [64, 96, 128])
@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,q_offset,kv_len,window", [
    (4, 32, 32, 1, 2080, True, 2047, 2048, None),   # zamba2's step, 32 splits
    (4, 32, 32, 1, 2080, True, 1999, 2000, None),   # not a multiple of 64
    (2, 32, 8, 1, 700, True, 600, 601, None),       # GQA 4:1 (llama3)
    (2, 32, 8, 1, 700, True, 600, 601, 200),        # window: splits 6..9
    (1, 16, 4, 4, 1100, True, 1000, 1004, 130),     # 16 rows, own edges
    (2, 16, 16, 1, 330, False, 0, 330, None),       # cross-attention decode
    (2, 8, 8, 1, 16, True, 0, 1, None),             # kv_len 1
    (1, 16, 4, 4, 300, True, 126, 130, None),       # rows 0-1 see none of
                                                    # split 2
], ids=["zamba2", "kv2000", "gqa", "window", "16-rows", "cross", "kv1",
        "masked-split"])
def test_flash_attention_split_kv_f32_vs_plain(cuda_device, d, b, h, hkv,
                                               sq, sk, causal, q_offset,
                                               kv_len, window):
    """The f32 split-KV form against the plain version and its own
    decomposition (64-column splits) at 2e-5; the launch counts under
    ``split_kv_f32``, and a second launch gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(sq + kv_len + d)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    q = rand(b, sq, h, d).transpose(1, 2)
    k = rand(b, sk, hkv, d).transpose(1, 2)
    v = rand(b, sk, hkv, d).transpose(1, 2)
    assert fa.kernel_form(q, k, v) == "split_kv_f32"
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    before = dict(fa.LAUNCHES_BY_FORM)
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.LAUNCHES_BY_FORM == {
        f: n + (f == "split_kv_f32") for f, n in before.items()}
    assert got.dtype == torch.float32 and got.stride() == q.stride()
    assert torch.isfinite(got).all()
    for ref in (fa.flash_attention_plain(q, k, v, **kw),
                fa.split_kv_plain(q, k, v, **kw,
                                  columns=fa.SPLIT_COLUMNS_F32)):
        assert float((got - ref).abs().max()) <= 2e-5
    assert torch.equal(got, fa.flash_attention(q, k, v, **kw))


def test_flash_attention_f32_decode_backward_takes_the_cuda_core_form(
        cuda_device):
    """Under grad an f32 decode step runs forward on the f32 split-KV form
    (no log-sum-exp kept) and backward on the CUDA-core form; an unaligned
    one runs on the CUDA-core form both ways."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    mod = sys.modules[fa.flash_attention.__module__]
    q = torch.randn(2, 1, 8, 64, generator=gen, device=cuda_device)\
        .transpose(1, 2)
    k, v = (torch.randn(2, 300, 2, 64, generator=gen, device=cuda_device)
            .transpose(1, 2) for _ in range(2))
    base = torch.randn(2, 1, 8 * 64 + 1, generator=gen, device=cuda_device)
    unaligned = base[:, :, :8 * 64].unflatten(-1, (8, 64)).transpose(1, 2)
    kw = dict(causal=True, q_offset=250, kv_len=251)
    for qq, form in ((q, "split_kv_f32"), (unaligned, "simt")):
        assert fa.kernel_form(qq, k, v) == form
        assert fa.backward_form(qq, k, v) == "simt"
        assert not mod.keeps_lse(qq, k, v)
        before = dict(fa.LAUNCHES_BY_FORM), dict(fa.LAUNCHES_BY_BWD_FORM)
        leaves = [t.detach().requires_grad_() for t in (qq, k, v)]
        out = fa.flash_attention(*leaves, **kw)
        g = torch.randn(out.shape, generator=gen, device=cuda_device)
        got = torch.autograd.grad(out, leaves, g)
        assert fa.LAUNCHES_BY_FORM[form] == before[0][form] + 1
        assert fa.LAUNCHES_BY_BWD_FORM["simt_bwd"] == \
            before[1]["simt_bwd"] + 1
        assert float((out - fa.flash_attention_plain(qq, k, v, **kw))
                     .abs().max()) <= 2e-5
        for a, w in zip(got, fa.flash_attention_bwd(qq, k, v, g, **kw)):
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_split_kv_is_deterministic(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16).transpose(1, 2)
               for shape in ((4, 1, 32, 64), (4, 2080, 32, 64),
                             (4, 2080, 32, 64)))
    kw = dict(causal=True, q_offset=2047, kv_len=2048)
    first = fa.flash_attention(q, k, v, **kw)
    assert all(torch.equal(first, fa.flash_attention(q, k, v, **kw))
               for _ in range(3))


@pytest.mark.parametrize("b,s,h,p,n,with_h0", [
    (1, 128, 1, 16, 8, False),
    (2, 131, 3, 64, 64, True),      # prime length: ragged last chunk
    (4, 2048, 64, 64, 64, True),    # zamba2-1.2b prefill
    (2, 512, 48, 64, 128, True),    # mamba2-780m widths
])
def test_ssd_scan_kernel_vs_plain(cuda_device, b, s, h, p, n, with_h0):
    gen = torch.Generator(device=cuda_device).manual_seed(s)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    x, la = rand(b, s, h, p), -torch.nn.functional.softplus(rand(b, s, h))
    bb, cc = rand(b, s, n) * 0.3, rand(b, s, n) * 0.3
    h0 = rand(b, h, n, p) if with_h0 else None
    before = scan.LAUNCHES["ssd_scan"]
    y, final = scan.ssd_scan(x, la, bb, cc, h0)
    assert scan.LAUNCHES["ssd_scan"] == before + 1
    y_want, f_want = scan.ssd_scan_plain(x, la, bb, cc, h0)
    for got, want in ((y, y_want), (final, f_want)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) / scale <= 5e-6


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32-bc", "bf16-bc"])
@pytest.mark.parametrize("b,s,h,p,n", [
    (2, 2039, 4, 64, 64),    # prime length, one column block of 64
    (2, 300, 3, 48, 64),     # P = 48: the column block is masked
    (2, 300, 3, 80, 128),    # N = 128: blocks of 32 columns, the last
                             # one half masked
    (1, 130, 2, 64, 100),    # N = 100: blocks of 32 columns
    (1, 37, 2, 8, 4),        # tiny state
])
def test_ssd_scan_column_blocks_and_bf16_b_c(cuda_device, bc_dtype, b, s, h,
                                             p, n):
    gen = torch.Generator(device=cuda_device).manual_seed(s + n)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    x, la = rand(b, s, h, p), -torch.nn.functional.softplus(rand(b, s, h))
    bb = (rand(b, s, n) * 0.3).to(bc_dtype)
    cc = (rand(b, s, n) * 0.3).to(bc_dtype)
    h0 = rand(b, h, n, p)
    y, final = scan.ssd_scan(x, la, bb, cc, h0)
    y_want, f_want = scan.ssd_scan_plain(x, la, bb, cc, h0)
    # bf16 b, c widen exactly: the plain version on their f32 values agrees
    y_f32, _ = scan.ssd_scan_plain(x, la, bb.float(), cc.float(), h0)
    assert torch.equal(y_want, y_f32)
    for got, want in ((y, y_want), (final, f_want)):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) / scale <= 5e-6


@pytest.mark.parametrize("dtype,form,d", [
    (torch.float32, "tensor_core_f32", 64),
    (torch.bfloat16, "tensor_core", 64),
    (torch.float32, "simt", 16),
])
def test_flash_attention_gradient_on_the_card(cuda_device, dtype, form, d):
    """Under grad the kernel's output has B4's ``grad_fn``; its gradients
    (one launch of the backward kernel, on the same form) equal autograd
    through the plain version on the same card, within 1e-4 of each
    one's largest value in f32 (bf16: the inputs' rounding, 2e-2)."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(
            dtype).requires_grad_()

    q, k, v = rand(2, 8, 256, d), rand(2, 4, 256, d), rand(2, 4, 256, d)
    assert fa.kernel_form(q, k, v) == form
    before = dict(fa.LAUNCHES)
    bwd_form = fa.LAUNCHES_BY_BWD_FORM[f"{form}_bwd"]
    out = fa.flash_attention(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    g = torch.randn(out.shape, generator=gen, device=cuda_device).to(dtype)
    assert fa.backward_form(q, k, v) == form
    got = torch.autograd.grad(out, (q, k, v), g)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 1
    assert fa.LAUNCHES_BY_BWD_FORM[f"{form}_bwd"] == bwd_form + 1
    want = torch.autograd.grad(
        fa.flash_attention_plain(q, k, v, causal=True), (q, k, v), g)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w in zip(got, want):
        assert float((a.float() - w.float()).abs().max()) <= \
            tol * float(w.float().abs().max())


@pytest.mark.parametrize("sq,kw", [
    (300, dict(causal=True)),                                  # tensor-core
    (1, dict(causal=True, q_offset=299, kv_len=300)),          # split-KV
    (200, dict(causal=True, q_offset=40, kv_len=250, window=70)),
], ids=["tensor-core", "split-kv", "offsets-window"])
def test_flash_attention_forward_lse_on_the_card(cuda_device, sq, kw):
    """Under autograd the bf16 forms also write each row's log-sum-exp,
    within 1e-4 of the plain version's, and the output's rounding residual:
    output + residual is within 2^-15 of the largest value of the plain
    version in f32 (P in two bf16 parts: ~16 bits), and the output, like
    the serving launch's, within one bf16 step (2^-8) of it."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(
            torch.bfloat16).transpose(1, 2)

    q, k, v = rand(2, sq, 8, 64), rand(2, 300, 2, 64), rand(2, 300, 2, 64)
    mod = sys.modules[fa.flash_attention.__module__]
    assert mod.keeps_lse(q, k, v)
    args = (kw["causal"], None, kw.get("q_offset", 0), kw.get("kv_len"),
            kw.get("window"))
    out, lse, out_lo = mod._forward(q, k, v, *args, for_grad=True)
    serve = mod._forward(q, k, v, *args)
    o32, want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse - want).abs().max()) <= 1e-4
    assert out_lo.dtype == out.dtype and out_lo.stride() == out.stride()
    err = (out.float() + out_lo.float() - o32).abs().max()
    assert float(err) <= 2.0 ** -15 * float(o32.abs().max())
    for o in (out, serve):
        err = (o.float() - o32).abs().max()
        assert float(err) <= 2.0 ** -8 * float(o32.abs().max())


@pytest.mark.parametrize("sq,d,kw", [
    (300, 64, dict(causal=True)),
    (200, 128, dict(causal=True, q_offset=40, kv_len=250, window=70)),
    (130, 96, dict(causal=False)),
], ids=["d64", "d128-offsets-window", "d96-noncausal"])
def test_flash_attention_f32_forward_lse_on_the_card(cuda_device, sq, d, kw):
    """Under autograd the tensor-core f32 form also writes each row's
    log-sum-exp, within 1e-4 of the plain version's, and no rounding
    residual; its output has the serving launch's bits and is within
    2e-5 of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)\
            .transpose(1, 2)

    q, k, v = rand(2, sq, 8, d), rand(2, 300, 2, d), rand(2, 300, 2, d)
    mod = sys.modules[fa.flash_attention.__module__]
    assert mod.kernel_form(q, k, v) == "tensor_core_f32"
    assert mod.keeps_lse(q, k, v)
    args = (kw["causal"], None, kw.get("q_offset", 0), kw.get("kv_len"),
            kw.get("window"))
    out, lse, out_lo = mod._forward(q, k, v, *args, for_grad=True)
    serve = mod._forward(q, k, v, *args)
    o32, want = fa.flash_attention_plain(q, k, v, **kw, return_lse=True)
    assert out_lo is None and torch.equal(out, serve)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert float((lse - want).abs().max()) <= 1e-4
    assert float((out - o32).abs().max()) <= 2e-5


def test_flash_attention_f32_unaligned_rows_take_the_cuda_core_form(
        cuda_device):
    """An f32 view whose rows are 8 bytes off a 16-byte boundary runs on
    the CUDA-core form, forward and backward, against the plain
    versions."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    base = torch.randn(2, 200, 4 * 64 + 2, generator=gen, device=cuda_device)
    q = base[:, :, :4 * 64].unflatten(-1, (4, 64)).transpose(1, 2)
    k, v = (torch.randn(2, 200, 4, 64, generator=gen, device=cuda_device)
            .transpose(1, 2) for _ in range(2))
    assert fa.kernel_form(q, k, v) == "simt"
    assert fa.kernel_form(q.contiguous(), k, v) == "tensor_core_f32"
    before = dict(fa.LAUNCHES_BY_FORM), dict(fa.LAUNCHES_BY_BWD_FORM)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    g = torch.randn(out.shape, generator=gen, device=cuda_device)
    got = torch.autograd.grad(out, leaves, g)
    assert fa.LAUNCHES_BY_FORM["simt"] == before[0]["simt"] + 1
    assert fa.LAUNCHES_BY_BWD_FORM["simt_bwd"] == before[1]["simt_bwd"] + 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    assert float((out - want).abs().max()) <= 2e-5
    for a, w in zip(got, fa.flash_attention_bwd(q, k, v, g, causal=True)):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())


def test_ssd_scan_gradient_on_the_card(cuda_device):
    """Under grad the kernel's outputs have B5's ``grad_fn``; the
    gradients (one launch of the backward kernel) equal autograd through
    the plain version, at 1e-5 of each one's largest value (f32 sums in
    two orders); the bf16 gradients of b and c round those sums, and
    where a sum lies by a rounding point the two round it one bf16 step
    (at most 2^-7 of its value) apart."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    x = rand(2, 300, 4, 64).requires_grad_()
    la = (-torch.nn.functional.softplus(rand(2, 300, 4))).requires_grad_()
    bb = (rand(2, 300, 64) * 0.3).to(torch.bfloat16).requires_grad_()
    cc = (rand(2, 300, 64) * 0.3).to(torch.bfloat16).requires_grad_()
    before = dict(scan.LAUNCHES)
    y, _ = scan.ssd_scan(x, la, bb, cc)
    assert scan.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    g = rand(*y.shape)
    got = torch.autograd.grad(y, (x, la, bb, cc), g)
    assert scan.LAUNCHES["ssd_scan"] == before["ssd_scan"] + 1
    assert scan.LAUNCHES["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    want = torch.autograd.grad(scan.ssd_scan_plain(x, la, bb, cc)[0],
                               (x, la, bb, cc), g)
    for a, w in zip(got, want):
        w = w.float()
        step = 2.0 ** -7 * w.abs() if a.dtype == torch.bfloat16 else 0.0
        assert bool(((a.float() - w).abs()
                     <= 1e-5 * float(w.abs().max()) + step).all())


# backward kernels, held to the plain versions: max |kernel - plain| over
# the plain gradient's largest |value|.  f32: sums in other orders, and B5's
# in-chunk cumsum by a warp scan; bf16 (B4's tensor-core form): P and dS
# rounded to bf16 as the products' operands, and the outputs' rounding.
BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# ... and row by row (``row_err``): a gradient's rows differ in size (a late
# kv row of a causal dk, dv sees few q rows), so a term lost from the small
# rows hides under the largest value; each row is held to its own rms, at
# chip_smoke.py's ``BWD_ROW_TOL`` (these cases read up to 0.030 in bf16 and
# 9.9e-6 in f32 for B4, 0.013 and 2.1e-3 for B5: dla's suffix sums cancel)
BWD_ROW_TOL = {"flash": {torch.float32: 5e-4, torch.bfloat16: 6e-2},
               "ssd": {torch.float32: 2e-2, torch.bfloat16: 5e-2}}


def row_err(got: torch.Tensor, plain: torch.Tensor) -> float:
    """The largest max |got - plain| of a row (the last dimension) over
    that row's rms of ``plain``, floored at 1e-3 of the whole gradient's
    rms (a row that is zero up to rounding has no relative error)."""
    g, p = got.float(), plain.float()
    floor = max(1e-3 * float(p.pow(2).mean().sqrt()),
                torch.finfo(torch.float32).tiny)
    return float(((g - p).abs().amax(-1)
                  / p.pow(2).mean(-1).sqrt().clamp_min(floor)).max())


@pytest.mark.parametrize("dtype,b,h,hkv,sq,sk,d,kw", [
    (torch.bfloat16, 2, 4, 4, 256, 256, 64, dict(causal=True)),
    (torch.bfloat16, 2, 8, 2, 300, 300, 128, dict(causal=True)),   # GQA
    (torch.bfloat16, 1, 4, 2, 300, 300, 64,
     dict(causal=True, window=50)),                                 # window
    (torch.bfloat16, 2, 4, 4, 200, 330, 64, dict(causal=False)),    # Sq != Sk
    (torch.bfloat16, 2, 4, 4, 200, 200, 96, dict(causal=True)),     # D 96
    (torch.bfloat16, 1, 4, 4, 200, 300, 64,
     dict(causal=True, q_offset=40, kv_len=250)),                   # offsets
    (torch.float32, 2, 4, 4, 256, 256, 64, dict(causal=True)),
    (torch.float32, 2, 8, 2, 130, 130, 16, dict(causal=True)),
    (torch.float32, 1, 4, 2, 300, 300, 8, dict(causal=True, window=37)),
    (torch.float32, 2, 2, 2, 70, 150, 32, dict(causal=False)),
    (torch.float32, 1, 4, 4, 150, 200, 96,
     dict(causal=True, q_offset=30, kv_len=170, window=60)),
    (torch.bfloat16, 2, 4, 4, 130, 130, 16, dict(causal=True)),    # bf16 D 16
    (torch.bfloat16, 2, 8, 2, 1, 300, 64,
     dict(causal=True, q_offset=299, kv_len=300)),  # split-KV forward
    (torch.float32, 2, 8, 2, 300, 300, 128, dict(causal=True)),     # GQA
    (torch.float32, 1, 4, 2, 300, 300, 64,
     dict(causal=True, window=50)),                                 # window
    (torch.float32, 2, 4, 4, 200, 330, 64, dict(causal=False)),     # Sq != Sk
    (torch.float32, 2, 8, 2, 4, 300, 64,
     dict(causal=True, q_offset=290, kv_len=294)),   # 16 rows: CUDA-core
    (torch.float32, 2, 4, 4, 256, 256, 64, dict(causal=True, s_max=20.0)),
    (torch.float32, 1, 8, 2, 300, 300, 128,
     dict(causal=True, s_max=20.0)),                 # sharp softmax
], ids=["tc", "tc-gqa-d128", "tc-window", "tc-noncausal", "tc-d96",
        "tc-offsets", "tc-f32", "simt-f32-gqa-d16", "simt-f32-window-d8",
        "simt-f32-noncausal-d32", "tc-f32-offsets-window-d96",
        "simt-bf16-d16", "tc-after-split-kv", "tc-f32-gqa-d128",
        "tc-f32-window", "tc-f32-noncausal", "simt-f32-16-rows",
        "tc-f32-sharp", "tc-f32-sharp-gqa-d128"])
def test_flash_attention_backward_kernel_vs_plain(cuda_device, dtype, b, h,
                                                  hkv, sq, sk, d, kw):
    """B4's backward kernel, on the form ``backward_form`` picks, against
    the closed form in torch ops and autograd through the plain version,
    on the same inputs (``BWD_TOL``, and row by row ``BWD_ROW_TOL``).
    With ``s_max``, q and k are scaled so that |scale q k^T| reaches it,
    and the plain versions run in f64: such a row's dq is a difference of
    nearly equal terms, and the plain version in f32 is itself ~1e-3 of
    the row floor from its f64 evaluation."""
    kw = dict(kw)
    s_max = kw.pop("s_max", None)
    gen = torch.Generator(device=cuda_device).manual_seed(sq + d)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(
            dtype).transpose(1, 2)

    q, k, v = rand(b, sq, h, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d)
    if s_max is not None:
        c = (s_max / d ** -0.5 / float((q @ k.repeat_interleave(
            h // hkv, dim=1).transpose(-1, -2)).abs().max())) ** 0.5
        q, k = q * c, k * c
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(q, k, v, **kw)
    g = torch.randn(out.shape, generator=gen, device=cuda_device).to(dtype)
    rows = sq * h // hkv
    form = ("simt" if d not in fa.TC_HEAD_DIMS
            else "tensor_core" if dtype == torch.bfloat16
            else "tensor_core_f32" if rows > fa.SPLIT_MAX_ROWS else "simt")
    assert fa.backward_form(q, k, v) == form
    before = fa.LAUNCHES_BY_BWD_FORM[f"{form}_bwd"]
    got = torch.autograd.grad(out, (q, k, v), g)
    assert fa.LAUNCHES_BY_BWD_FORM[f"{form}_bwd"] == before + 1
    if s_max is not None:
        q, k, v = (t.detach().double().requires_grad_() for t in (q, k, v))
        g = g.double()
    closed = fa.flash_attention_bwd(q, k, v, g, **kw)
    auto = torch.autograd.grad(fa.flash_attention_plain(q, k, v, **kw),
                               (q, k, v), g)
    for want in ([w.to(dtype) for w in closed], [w.to(dtype) for w in auto]):
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            err = float((a.float() - w.float()).abs().max())
            assert err <= BWD_TOL[dtype] * float(w.float().abs().max())
            assert row_err(a, w) <= BWD_ROW_TOL["flash"][dtype]


@pytest.mark.parametrize("b,s,h,p,n,with_h0,with_final,x_dt,bc_dt,decay", [
    (2, 2048, 8, 64, 64, True, True, torch.float32, torch.float32, 1.0),
    (2, 300, 4, 64, 128, True, True, torch.float32, torch.float32, 1.0),
    (2, 131, 3, 48, 64, False, True, torch.float32, torch.float32, 1.0),
    (1, 200, 2, 80, 100, True, False, torch.float32, torch.float32, 1.0),
    (2, 256, 4, 64, 64, False, False, torch.float32, torch.bfloat16, 1.0),
    (2, 300, 4, 64, 64, True, True, torch.bfloat16, torch.bfloat16, 1.0),
    (1, 37, 2, 8, 4, True, True, torch.float32, torch.float32, 1.0),
    (2, 700, 4, 64, 64, True, True, torch.float32, torch.float32, 0.01),
    (1, 150, 3, 6, 5, True, True, torch.float32, torch.bfloat16, 0.01),
], ids=["f32", "n128", "ragged-no-h0", "n100-no-final", "bf16-bc",
        "bf16-x-bc", "tiny", "slow-decay", "odd-widths"])
def test_ssd_scan_backward_kernel_vs_plain(cuda_device, b, s, h, p, n,
                                           with_h0, with_final, x_dt, bc_dt,
                                           decay):
    """B5's backward kernel against its algorithm in torch ops
    (``ssd_scan_bwd_plain``) and autograd through the plain scan: f32
    gradients within ``BWD_TOL`` of the largest; bf16 ones (x, b, c in
    bf16) also within one bf16 step (at most 2^-7 of the value)
    elementwise; every row within ``BWD_ROW_TOL`` of its rms.  ``decay``
    scales la: at 0.01 a chunk of 64 steps keeps ~0.6 of its state, so
    that what the passes carry from chunk to chunk counts."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + n)

    def rand(*shape, dt=torch.float32):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    x = rand(b, s, h, p, dt=x_dt).requires_grad_()
    la = (-decay * torch.nn.functional.softplus(rand(b, s, h))
          ).requires_grad_()
    bb = (rand(b, s, n) * 0.3).to(bc_dt).requires_grad_()
    cc = (rand(b, s, n) * 0.3).to(bc_dt).requires_grad_()
    h0 = rand(b, h, n, p).requires_grad_() if with_h0 else None
    inputs = [t for t in (x, la, bb, cc, h0) if t is not None]
    y, final = scan.ssd_scan(x, la, bb, cc, h0)
    gy = rand(*y.shape, dt=x_dt)
    gf = rand(*final.shape) if with_final else None
    outs, gouts = ((y, final), (gy, gf)) if with_final else ((y,), (gy,))
    before = scan.LAUNCHES["ssd_scan_bwd"]
    got = torch.autograd.grad(outs, inputs, gouts)
    assert scan.LAUNCHES["ssd_scan_bwd"] == before + 1
    plain = [t for t in scan.ssd_scan_bwd_plain(
        x.detach(), la.detach(), bb.detach(), cc.detach(),
        None if h0 is None else h0.detach(), gy, gf) if t is not None]
    py, pf = scan.ssd_scan_plain(x, la, bb, cc, h0)
    auto = torch.autograd.grad((py, pf)[:len(outs)], inputs, gouts)
    for want in (plain, auto):
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape
            w = w.float()
            step = 2.0 ** -7 * w.abs() if a.dtype == torch.bfloat16 else 0.0
            assert bool(((a.float() - w).abs() <= BWD_TOL[torch.float32]
                         * float(w.abs().max()) + step).all())
            assert row_err(a, w) <= BWD_ROW_TOL["ssd"][a.dtype]


def test_ssd_scan_bwd_columns_are_the_librarys(cuda_device):
    """``bwd_columns``, which sizes the backward's scratch on meta, gives
    the library's block width at every state size the kernel takes."""
    mod = sys.modules[scan.ssd_scan.__module__]
    lib = mod._bwd_lib()
    sizes = range(1, mod.MAX_N + 1)
    assert [mod.bwd_columns(n) for n in sizes] == \
        [lib.ssd_scan_bwd_columns(n) for n in sizes]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_kernels_are_deterministic(cuda_device, dtype):
    """Two launches of each backward kernel on the same inputs give the
    same bits (fixed-order reductions, no float atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)

    def rand(*shape, dt=dtype):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(dt)

    q, k, v = (rand(2, 300, n, 64).transpose(1, 2) for n in (8, 2, 2))
    g = rand(2, 8, 300, 64)
    kw = dict(causal=True, scale=None, q_offset=0, kv_len=None, window=None)
    mod = sys.modules[fa.flash_attention.__module__]
    if mod.keeps_lse(q, k, v):   # the tensor-core form reads the forward's
        out, lse, out_lo = mod._forward(q, k, v, *kw.values(), for_grad=True)
        kw.update(out=out, lse=lse, out_lo=out_lo)
    first = mod._backward(q, k, v, g, **kw)
    assert all(torch.equal(a, c) for _ in range(2)
               for a, c in zip(first, mod._backward(q, k, v, g, **kw)))
    x, dy = rand(2, 300, 8, 64), rand(2, 300, 8, 64)
    la = -torch.nn.functional.softplus(rand(2, 300, 8, dt=torch.float32))
    bb, cc = rand(2, 300, 128) * 0.3, rand(2, 300, 128) * 0.3
    h0 = rand(2, 8, 128, 64, dt=torch.float32)
    smod = sys.modules[scan.ssd_scan.__module__]
    first = smod._backward(x, la, bb, cc, h0, dy, h0)
    assert all(torch.equal(a, c) for _ in range(2)
               for a, c in zip(first, smod._backward(x, la, bb, cc, h0, dy,
                                                     h0)))


def test_reduced_training_step_on_the_card(cuda_device):
    """One train step of the reduced zamba2 in f32 on the card: B4 once
    per shared-attention site, B5 twice per Mamba2 layer (forward and
    remat); loss, gradient norm and parameters equal the CPU's step from
    the same weights within 1e-4 relative."""
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train.data import synthetic_batch
    from repro_torch.configs.reduced import SMOKE_SHAPE

    spec = reduced_arch("zamba2-1.2b")
    cfg = dataclasses.replace(spec.config, dtype=torch.float32)
    spec = dataclasses.replace(spec, config=cfg)
    batch = synthetic_batch(spec.input_shapes(SMOKE_SHAPE), spec.vocab,
                            seed=0, step=0)
    out = {}
    for dev in ("cpu", cuda_device):
        model = hybrid.init(cfg, device="cpu", seed=3).to(dev)
        opt = make_optimizer(spec, total_steps=10)
        step = build_train_step(lambda m, b: hybrid.loss_fn(m, b, cfg), opt)
        before = (fa.LAUNCHES["flash_attention"], scan.LAUNCHES["ssd_scan"])
        state, metrics = step(init_state(model, opt),
                              {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (metrics, torch.cat([
            p.detach().flatten().cpu() for p in model.parameters()]))
        if dev != "cpu":
            assert fa.LAUNCHES["flash_attention"] - before[0] == \
                cfg.num_groups
            assert scan.LAUNCHES["ssd_scan"] - before[1] == 2 * cfg.layers
    (m_cpu, p_cpu), (m_gpu, p_gpu) = out["cpu"], out[str(cuda_device)]
    for key in ("loss", "grad_norm", "param_norm"):
        assert abs(float(m_gpu[key]) - float(m_cpu[key])) <= \
            1e-4 * abs(float(m_cpu[key]))
    assert torch.isfinite(p_gpu).all()
    assert float((p_gpu - p_cpu).abs().max()) <= 1e-4 * float(
        p_cpu.abs().max())


def test_reduced_serve_launches_both_kernels(cuda_device):
    """The same weights served on the CPU (plain versions) and on the
    card (kernels) give the same greedy tokens."""
    cfg = dataclasses.replace(reduced_arch("zamba2-1.2b").config,
                              dtype=torch.float32)
    model = hybrid.init(cfg, device="cpu", seed=1)
    kw = dict(reduced=True, batch=2, prompt_len=16, gen=4,
              dtype=torch.float32)
    cpu = serve.serve("zamba2-1.2b", device="cpu", model=model, **kw)
    before = (fa.LAUNCHES["flash_attention"], scan.LAUNCHES["ssd_scan"],
              fa.LAUNCHES_BY_FORM["simt"])
    res = serve.serve("zamba2-1.2b", device=cuda_device,
                      model=model.to(cuda_device), **kw)
    # 2 attention sites per forward (5 layers, attn_every 2), 4 forwards;
    # one scan per Mamba2 layer of the prefill.  f32: the CUDA-core form
    assert fa.LAUNCHES["flash_attention"] - before[0] == 2 * 4
    assert fa.LAUNCHES_BY_FORM["simt"] - before[2] == 2 * 4
    assert scan.LAUNCHES["ssd_scan"] - before[1] == 5
    np.testing.assert_array_equal(res["tokens"], cpu["tokens"])


def test_reduced_mixtral_serve_on_the_card(cuda_device):
    """The reduced mixtral (window 16, 4 experts top-2) served past its
    window on the CPU and on the card from the same f32 weights gives
    the same greedy tokens; every attention ran on B4 (f32: the CUDA-core
    form), 2 layers a forward."""
    cfg = dataclasses.replace(reduced_arch("mixtral-8x7b").config,
                              dtype=torch.float32)
    model = transformer.init(cfg, device="cpu", seed=1)
    kw = dict(reduced=True, batch=2, prompt_len=24, gen=4,
              dtype=torch.float32)
    cpu = serve.serve("mixtral-8x7b", device="cpu", model=model, **kw)
    before = fa.LAUNCHES_BY_FORM["simt"]
    res = serve.serve("mixtral-8x7b", device=cuda_device,
                      model=model.to(cuda_device), **kw)
    assert fa.LAUNCHES_BY_FORM["simt"] - before == 2 * 4
    np.testing.assert_array_equal(res["tokens"], cpu["tokens"])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_repeated_syncs_of_a_mixtral_decode_are_ts_sites(cuda_device, dtype):
    """The reduced mixtral (2 layers) prefilled and decoded three steps
    on the card under ``set_sync_debug_mode("warn")``: every port line
    that synchronises more than once in the call is a site the TS rules
    report (flagged or suppressed).  In bf16 the MoE layers take the
    grouped pipeline and no line of ``models/moe.py`` syncs; in f32 they
    take the loop, whose per-layer expert counts (the ``bincount`` line)
    are among the repeated sites."""
    import traceback
    import warnings
    from pathlib import Path

    from repro_torch.lint.analyzers import torch_sync
    from repro_torch.lint.engine import ModuleContext

    root = Path(__file__).resolve().parents[1]
    port = root / "src" / "repro_torch"
    moe_py = "src/repro_torch/models/moe.py"
    count_line = next(
        i for i, text in enumerate((root / moe_py).read_text().splitlines(),
                                   1) if "torch.bincount(experts" in text)
    cfg = dataclasses.replace(reduced_arch("mixtral-8x7b").config,
                              dtype=dtype)
    model = transformer.init(cfg, device=cuda_device, seed=1)
    sites: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if Path(f.filename).is_relative_to(port)]
        if frames:
            site = (Path(frames[-1].filename).relative_to(root).as_posix(),
                    frames[-1].lineno)
            sites[site] = sites.get(site, 0) + 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = serve.serve("mixtral-8x7b", reduced=True, batch=2,
                              prompt_len=24, gen=4, device=cuda_device,
                              model=model, dtype=dtype)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert res["tokens"].shape == (2, 4)
    repeated = {s for s, n in sites.items() if n > 1}
    ts = set()
    for rel in {r for r, _ in repeated}:
        path = root / rel
        ctx = ModuleContext(path, rel, path.read_text())
        ts |= {(rel, ln) for ln in torch_sync.sync_lines(ctx)}
    if dtype == torch.bfloat16:
        assert not [s for s in sites if s[0] == moe_py], sites
    else:
        assert (moe_py, count_line) in repeated
    assert repeated <= ts, sorted(repeated - ts)


SWEEP_SPACE = dict(sets=(64, 512, 4096, 32768), ways=(1, 4, 8, 16),
                   line_sizes=(64, 128), latency_cy=(20.0, 36.0),
                   cores=(1, 2, 4))


@pytest.mark.parametrize("inner", ["vmap", "pallas"])
def test_sweep_on_the_card_matches_the_cpu_port(cuda_device, inner):
    """``sweep_grid`` on the card: one ragged launch per sweep, of the
    rates form (vmap) or of the per-reference form (pallas), the rates
    within 1e-12 (vmap) or 1e-6 (pallas) of the CPU port's and, for vmap,
    bit-identical to ``batched_hit_rates`` on the card."""
    from repro_torch.core.runtime_model import OpCounts
    from repro_torch.explore import FusedSweepEvaluator, SearchSpace

    w = make_atax(n=64)
    space = SearchSpace(**SWEEP_SPACE)
    configs = space.configs()
    counts = OpCounts(int_ops=3000, fp_ops=1500, div_ops=10, loads=3000,
                      stores=1500, total_bytes=4500 * 8)
    gpu_sess = Session(device=cuda_device, cache_model="batched")
    gpu = FusedSweepEvaluator(w, space, session=gpu_sess, counts=counts,
                              inner=inner)
    cpu = FusedSweepEvaluator(w, space, device="cpu", counts=counts,
                              inner=inner)
    name = ("sdcm_rates_ragged" if inner == "vmap"
            else "sdcm_hit_probs_ragged")
    before = dict(kernel.LAUNCHES)
    got = gpu.evaluate(configs)
    launched = {k: kernel.LAUNCHES[k] - before[k] for k in before}
    assert launched[name] == gpu.stats.fused_dispatches > 0
    assert sum(launched.values()) == launched[name]
    groups = {(c.line_size, c.cores, c.strategy) for c in configs}
    assert launched[name] == len(groups)
    want = cpu.evaluate(configs)
    # vmap folds in double on both sides; pallas folds float32 P(h|D),
    # which the card and the host may round one float32 ulp apart
    tol = 1e-12 if inner == "vmap" else 1e-6
    assert np.max(np.abs(got.rates - want.rates)) <= tol
    np.testing.assert_allclose(got.t_pred_s, want.t_pred_s, rtol=tol)
    if inner == "vmap":
        items = [(c.apply(gpu.base, gpu.level_idx),
                  gpu_sess.artifacts(w, c.cores, strategy=c.strategy,
                                     line_size=c.line_size))
                 for c in configs[::5]]
        names = [lvl.name for lvl in gpu.base.levels]
        rows = batched.batched_hit_rates(items, device=cuda_device)
        assert got.rates[::5].tolist() == [[r[n] for n in names]
                                           for r in rows]


def test_store_round_trip_on_the_card(cuda_device, tmp_path):
    """A store warmed on the card serves a fresh card Session and a CPU
    Session: zero profile and reuse-distance builds, the card's profiles,
    the same predict as the card's cold one."""
    from repro_torch.workloads import registry

    req = PredictionRequest(targets=("i7-5960X", "EPYC 7702P"),
                            core_counts=(1, 2, 4))
    cold = Session(device=cuda_device, cache_model="batched",
                   artifact_dir=tmp_path)
    res = cold.predict(registry.resolve("polybench/atx", "smoke"), req)
    assert cold.stats.store_puts == cold.stats.profile_builds > 0
    warm = Session(device=cuda_device, cache_model="batched",
                   artifact_dir=tmp_path)
    again = warm.predict(registry.resolve("polybench/atx", "smoke"), req)
    assert warm.stats.profile_builds == warm.stats.rd_builds == 0
    assert warm.stats.store_hits == cold.stats.store_puts
    assert again.to_json() == res.to_json()
    host = Session(device="cpu", artifact_dir=tmp_path)
    for cores in (1, 2, 4):
        a = cold.artifacts(registry.resolve("polybench/atx", "smoke"), cores)
        b = host.artifacts(registry.resolve("polybench/atx", "smoke"), cores)
        assert np.array_equal(a.crd.counts, b.crd.counts)
    assert host.stats.profile_builds == 0


@pytest.mark.parametrize("name", ["model/llama3_8b/decode",
                                  "model/mixtral_8x7b/prefill",
                                  "model/zamba2_1_2b/decode"])
def test_model_cell_predict_on_the_card_equals_the_cpu(cuda_device, name):
    """A model cell's trace is recorded on the host; its predict on the
    card (one ragged SDCM launch) is within 1e-6 of the CPU port's."""
    from repro_torch.workloads import registry

    src = registry.resolve(name, "smoke")
    req = PredictionRequest(targets=("i7-5960X", "Xeon E5-2699 v4",
                                     "EPYC 7702P", "tpu-v5e"),
                            core_counts=(1, 4), counts=src.op_counts,
                            respect_core_limit=False)
    before = kernel.LAUNCHES["sdcm_rates_ragged"]
    card = Session(device=cuda_device, cache_model="batched").predict(
        src, req)
    assert kernel.LAUNCHES["sdcm_rates_ragged"] == before + 1
    host = Session(device="cpu", cache_model="batched").predict(src, req)
    for a, b in zip(card.predictions, host.predictions):
        assert (a.target, a.cores) == (b.target, b.cores)
        for lvl in a.hit_rates:
            assert abs(a.hit_rates[lvl] - b.hit_rates[lvl]) <= 1e-6


# --- the MoE layer's expert pipeline (kernels/moe) ---------------------------

MOE_D, MOE_F, MOE_E = 4096, 14336, 8


def moe_routing_case(tokens: int, load: str, experts: int = MOE_E,
                     seed: int = 0):
    """Seeded top-2 choices ``idx [T, 2]`` (distinct experts a token) and
    renormalised gates: ``uniform``; ``skewed``, expert 3 chosen by 60 %
    of the tokens; ``empty``, experts 1 and 5 chosen by none."""
    g = torch.Generator().manual_seed(seed)
    if load == "empty":
        pool = torch.tensor([e for e in range(experts) if e not in (1, 5)])
    else:
        pool = torch.arange(experts)
    choice = torch.stack([pool[torch.randperm(len(pool), generator=g)[:2]]
                          for _ in range(tokens)])
    if load == "skewed":
        hot = torch.rand(tokens, generator=g) < 0.6
        other = choice[:, 0].clone()
        other[other == 3] = choice[other == 3, 1]
        choice[hot] = torch.stack([torch.full_like(other, 3), other], 1)[hot]
    gate = torch.rand(tokens, 2, generator=g) + 0.1
    return choice.long(), gate / gate.sum(-1, keepdim=True)


@pytest.fixture(scope="module")
def moe_weights():
    """bf16 ``(wi, wg, wo)`` of 8 experts at mixtral's widths (fan-in
    scaled), drawn once on the card for every case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(7)
    def draw(*shape):
        return (torch.randn(*shape, generator=g, device="cuda")
                / shape[-2] ** 0.5).bfloat16()
    return (draw(MOE_E, MOE_D, MOE_F), draw(MOE_E, MOE_D, MOE_F),
            draw(MOE_E, MOE_F, MOE_D))


MOE_CASES = [(t, load) for t in (1, 256 * 4, 8192)
             for load in ("uniform", "skewed", "empty")]


@pytest.mark.parametrize("tokens,load", MOE_CASES)
def test_moe_dispatch_kernel_vs_plain(cuda_device, tokens, load):
    """Offsets, slots and the gathered rows: equal to the plain version
    (an exact integer and copy pass)."""
    idx, _ = moe_routing_case(tokens, load)
    idx = idx.to(cuda_device)
    xt = torch.randn(tokens, MOE_D, device=cuda_device).bfloat16()
    before = kmoe.LAUNCHES["moe_dispatch"]
    got = kmoe.dispatch(xt, idx, MOE_E)
    assert kmoe.LAUNCHES["moe_dispatch"] == before + 1
    want = kmoe.dispatch_plain(xt, idx, MOE_E)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def assert_bf16_close(got, want):
    """Both sides round the same f32 sums, taken in another order, to
    bf16 once: at most a unit in the last place apart (2^-7 of the
    value), plus the f32 order's error near zero (1e-4 of the scale)."""
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-4 * scale)


@pytest.mark.parametrize("tokens,load", MOE_CASES)
def test_moe_grouped_gemm_kernel_vs_plain(cuda_device, moe_weights, tokens,
                                          load):
    """Both grouped GEMMs (one launch each) against their plain versions
    at mixtral's widths: h = silu(x wg) * (x wi) and yp = h wo, every
    expert's rows in one launch, an expert with no rows skipped."""
    wi, wg, wo = moe_weights
    idx, _ = moe_routing_case(tokens, load, seed=1)
    xt = torch.randn(tokens, MOE_D, device=cuda_device).bfloat16()
    offs, _, xs = kmoe.dispatch_plain(xt, idx.to(cuda_device), MOE_E)
    before = kmoe.LAUNCHES["moe_gemm"]
    h = kmoe.grouped_swiglu(xs, offs, wg, wi)
    assert_bf16_close(h, kmoe.grouped_swiglu_plain(xs, offs, wg, wi))
    yp = kmoe.grouped_down(h, offs, wo)
    assert_bf16_close(yp, kmoe.grouped_down_plain(h, offs, wo))
    assert kmoe.LAUNCHES["moe_gemm"] == before + 2


@pytest.mark.parametrize("tokens,load", MOE_CASES)
def test_moe_combine_kernel_vs_plain(cuda_device, tokens, load):
    """The combine on the same rows: bit for bit the plain version (the
    same products and sums, in expert order, unfused)."""
    idx, gate = moe_routing_case(tokens, load, seed=2)
    idx, gate = idx.to(cuda_device), gate.to(cuda_device)
    _, slot, _ = kmoe.dispatch_plain(
        torch.zeros(tokens, 8, device=cuda_device), idx, MOE_E)
    yp = torch.randn(tokens * 2, MOE_D, device=cuda_device).bfloat16()
    got = kmoe.combine(yp, slot, gate, idx)
    assert torch.equal(got, kmoe.combine_plain(yp, slot, gate, idx))


def moe_layer(device, d=MOE_D, f=MOE_F, dtype=torch.bfloat16):
    cfg = moe.MoEConfig(num_experts=MOE_E, top_k=2)
    mod = moe.moe_init(d, f, cfg, dtype, device=device,
                       generator=torch.Generator(device=device).manual_seed(3))
    return cfg, mod


def test_moe_layer_makes_no_host_sync(cuda_device):
    """``moe_apply(drop=False)`` in bf16 without gradients: the grouped
    path under the sync debugger set to raise, two GEMM launches; the
    result within bf16's rounding of the loop's."""
    cfg, mod = moe_layer(cuda_device)
    x = torch.randn(2, 300, MOE_D, device=cuda_device).bfloat16()
    before = dict(kmoe.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            y, _ = moe.moe_apply(mod, x, cfg, drop=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert {k: kmoe.LAUNCHES[k] - before[k] for k in before} == {
        "moe_dispatch": 1, "moe_gemm": 2, "moe_combine": 1}
    xt = x.reshape(-1, MOE_D)
    with torch.no_grad():
        _, gate, idx = moe.route(mod, xt, cfg)
        want = moe._experts(xt, gate, idx, cfg, False, 600, 0,
                            (mod.wi, mod.wg, mod.wo)).to(x.dtype)
    scale = float(want.float().abs().max())
    assert float((y.reshape(-1, MOE_D).float() - want.float()).abs().max()
                 ) <= 2e-2 * scale


@pytest.mark.parametrize("case", ["drop", "grad", "f32"])
def test_the_loop_never_launches_the_grouped_gemm(cuda_device, case):
    """Training routing, a recorded gradient and f32 keep the loop: no
    launch of the pipeline's kernels."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    cfg, mod = moe_layer(cuda_device, d=256, f=512, dtype=dtype)
    x = torch.randn(1, 64, 256, device=cuda_device).to(dtype)
    x.requires_grad_(case == "grad")
    before = dict(kmoe.LAUNCHES)
    with torch.set_grad_enabled(case == "grad"):
        moe.moe_apply(mod, x, cfg, drop=case == "drop")
    assert kmoe.LAUNCHES == before
