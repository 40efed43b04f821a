"""The SDCM CUDA kernel on the card: both entry points against their
plain PyTorch versions, launch counting, and composition invariance of
the grid form.  Imports nothing of JAX, so it runs where the port runs:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import batched
from repro_torch.core.reuse.distance import reuse_distances
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.kernels import sdcm as kernel

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
