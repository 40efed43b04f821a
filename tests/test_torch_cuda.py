"""The port's CUDA kernels on the card: the SDCM kernel's two entry
points, the reuse-histogram kernel's two flags, flash attention (B4, each
of its three forms, with the launches counted by form) and the SSD scan
(B5, f32 and bf16 b/c, column blocks) against their plain PyTorch
versions, launch counting,
composition invariance of the SDCM grid form, bit-reproducibility of
the histogram (from two threads and streams at once too), streaming reuse distances, a binned Session and the
reduced serving path on the card, the fused config sweep in both inner
forms and the artifact store on the card.  Imports nothing of JAX, so
it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""
from __future__ import annotations

import dataclasses
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
from repro_torch.kernels import reuse_hist
from repro_torch.kernels import ssd_scan as scan
from repro_torch.configs.reduced import reduced_arch
from repro_torch.launch import serve
from repro_torch.models import hybrid
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


@pytest.mark.parametrize("d", [64, 128])
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


SWEEP_SPACE = dict(sets=(64, 512, 4096, 32768), ways=(1, 4, 8, 16),
                   line_sizes=(64, 128), latency_cy=(20.0, 36.0),
                   cores=(1, 2, 4))


@pytest.mark.parametrize("inner", ["vmap", "pallas"])
def test_sweep_on_the_card_matches_the_cpu_port(cuda_device, inner):
    """``sweep_grid`` on the card: one ragged launch per sweep (vmap) or
    one per-reference launch per set-associative geometry (pallas), the
    rates within 1e-12 (vmap) or 1e-6 (pallas) of the CPU port's and, for
    vmap, bit-identical to ``batched_hit_rates`` on the card."""
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
    name = "sdcm_rates_ragged" if inner == "vmap" else "sdcm_hit_probs"
    before = dict(kernel.LAUNCHES)
    got = gpu.evaluate(configs)
    launched = {k: kernel.LAUNCHES[k] - before[k] for k in before}
    assert launched[name] == gpu.stats.fused_dispatches > 0
    assert sum(launched.values()) == launched[name]
    if inner == "vmap":
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
