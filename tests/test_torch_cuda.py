"""The port's CUDA kernels on the card: the SDCM kernel's two entry
points and the reuse-histogram kernel's two flags against their plain
PyTorch versions, launch counting, composition invariance of the SDCM
grid form, bit-reproducibility of the histogram, streaming reuse
distances and a binned Session on the card.  Imports nothing of JAX, so
it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import PredictionRequest, Session, batched
from repro_torch.core.reuse.distance import (
    reuse_distances,
    reuse_distances_streaming,
)
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.kernels import reuse_hist
from repro_torch.kernels import sdcm as kernel
from repro_torch.workloads.polybench import make_atax

pytestmark = pytest.mark.cuda

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
