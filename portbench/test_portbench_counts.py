"""The counts: visible pairs against a brute-force count, and a model
step's operations and the expert GEMMs' counts against a hand count for
tiny configurations."""
from __future__ import annotations

import pytest

from portbench import counts


def brute_pairs(s, window):
    return sum(1 for i in range(s) for j in range(s)
               if j <= i and (window is None or j > i - window))


@pytest.mark.parametrize("s,window", [(1, None), (7, None), (64, None),
                                      (40, 8), (40, 1), (16, 16), (9, 30)])
def test_visible_pairs_equal_a_brute_force_count(s, window):
    assert counts.visible_pairs(s, window) == brute_pairs(s, window)


def test_hybrid_step_flops_by_hand():
    sizes = {"layers": 3, "d_model": 8, "vocab": 10, "heads": 2,
             "kv_heads": 1, "d_ff": 16, "ssm_state": 4, "head_dim": 4,
             "expand": 2, "attn_every": 2, "dtype": "bfloat16"}
    cfg = {"family": "hybrid", "sizes": sizes}
    b, s = 2, 5
    d, di, n, p = 8, 16, 4, 4
    h = di // p                                   # 4 SSD heads
    mamba = d * di * 2 + d * n * 2 + d * h + di * d
    shared = 2 * d * d + d * (2 + 2 * 1) * 4 + 2 * 4 * d + 3 * d * 16
    body = 3 * mamba + 1 * shared                 # one attention site
    pairs = s * (s + 1) // 2
    att = 4 * 4 * pairs * 2 * b                   # 4 D a pair, 2 heads
    scan = 4 * n * p * h * b * s * 3              # 3 layers
    prefill = 2 * (body * b * s + d * 10 * b) + att + scan
    assert counts.step_flops(cfg, b, s, train=False) == prefill
    train = 3 * (2 * (body * b * s + d * 10 * b * s) + att + scan)
    assert counts.step_flops(cfg, b, s, train=True) == train


def test_transformer_step_flops_by_hand():
    sizes = {"layers": 2, "d_model": 8, "heads": 4, "kv_heads": 2,
             "d_ff": 6, "vocab": 10, "head_dim": 2, "window": 3,
             "dense_ff": False, "moe": {"num_experts": 4, "top_k": 2},
             "dtype": "bfloat16"}
    cfg = {"family": "transformer", "sizes": sizes}
    b, s = 1, 6
    layer = 8 * (4 + 2 * 2) * 2 + 4 * 2 * 8 + 8 * 4 + 2 * 3 * 8 * 6
    pairs = brute_pairs(s, 3)
    att = 2 * 4 * 2 * pairs * 4 * b
    want = 2 * (2 * layer * b * s + 8 * 10 * b) + att
    assert counts.step_flops(cfg, b, s, train=False) == want


def test_bytes_count_each_input_and_output_once():
    call = dict(b=2, h=4, hkv=2, s=8, d=16, window=None)
    q, kv = 2 * 4 * 8 * 16, 2 * 2 * 8 * 16
    assert counts.attention_bytes(call, 2) == 2 * (2 * q + 2 * kv)
    assert counts.attention_bytes(call, 2, True) == 2 * (4 * q + 4 * kv)
    scan = dict(b=1, s=8, h=2, n=4, p=3)
    want = 2 * (2 * 8 * 2 * 3 + 8 * 2 + 2 * 8 * 4 + 2 * 2 * 4 * 3)
    assert counts.scan_bytes(scan, 2) == want


def test_expert_counts_by_hand():
    sizes = {"layers": 2, "d_model": 8, "d_ff": 6, "dense_ff": False,
             "moe": {"num_experts": 4, "top_k": 2}}
    calls = counts.family({"family": "transformer"}).expert_calls(sizes, 2, 5)
    assert calls == [dict(tokens=10, pairs=20, d=8, f=6, experts=4)] * 2
    c = calls[0]
    assert counts.expert_flops(c) == 6 * 8 * 6 * 20     # gate, up, down
    # four experts' three matrices, 10 rows of x, 20 pairs' outputs
    assert counts.expert_bytes(c, 2) == 2 * (4 * 3 * 8 * 6 + 10 * 8 + 20 * 8)
    # one token (two pairs) can reach only two experts' weights
    one = counts.family({"family": "transformer"}).expert_calls(sizes, 1, 1)
    assert counts.expert_bytes(one[0], 2) == 2 * (2 * 3 * 8 * 6 + 8 + 2 * 8)
    assert counts.family({"family": "hybrid"}).expert_calls({}, 2, 5) == []
    with pytest.raises(ValueError):
        counts.expert_flops(c, backward=True)
