"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``moe_apply(..., drop=False)`` — the routing every serving
path of the reference takes — on carried weights and the same
numpy-seeded inputs, in f32 at rtol/atol 2e-4 (the model tests' bound),
on the CPU.  Token counts include ones that are not a multiple of
``tokens_per_group`` (the reference then shrinks its groups; with no
drop the groups do not change the result).

``torch.topk`` does not promise JAX's tie order, so each case first
checks that its inputs leave a clear gap between the k-th and the next
router probability.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.layers import unzip_params
from repro_torch.interop import copy_params
from repro_torch.models import moe

TOL = dict(rtol=2e-4, atol=2e-4)
GAP = 1e-4   # least margin between the k-th and (k+1)-th probability


def carried(d, d_ff, cfg_kw, seed, dtype=jnp.float32):
    rcfg = ref_moe.MoEConfig(**cfg_kw)
    vals = jax.tree.map(np.asarray, unzip_params(ref_moe.moe_init(
        jax.random.key(seed), d, d_ff, rcfg, dtype))[0])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mod = moe.moe_init(d, d_ff, moe.MoEConfig(**cfg_kw), tdt, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    return rcfg, vals, moe.MoEConfig(**cfg_kw), mod


def assert_no_ties(mod, x, cfg):
    probs, _, _ = moe.route(mod, x.reshape(-1, x.shape[-1]), cfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    k = cfg.top_k
    assert float((top[:, k - 1] - top[:, k]).min()) > GAP


@pytest.mark.parametrize("b,s,cfg_kw", [
    (2, 16, dict(num_experts=4, top_k=2, tokens_per_group=32)),
    (3, 7, dict(num_experts=4, top_k=2, tokens_per_group=8)),    # 21 tokens
    (1, 37, dict(num_experts=8, top_k=2, tokens_per_group=16)),  # prime
    (2, 9, dict(num_experts=6, top_k=1, tokens_per_group=5)),
    (2, 5, dict(num_experts=4, top_k=3, tokens_per_group=1024)),
], ids=["groups-of-32", "21-tokens", "prime-37", "top-1", "top-3"])
def test_moe_apply_matches_the_reference(b, s, cfg_kw):
    d, d_ff = 32, 48
    rcfg, vals, cfg, mod = carried(d, d_ff, cfg_kw, seed=b * s)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, d)).astype(np.float32)
    assert_no_ties(mod, torch.from_numpy(x), cfg)
    want, want_aux = jax.jit(lambda v, x: ref_moe.moe_apply(
        v, x, rcfg, drop=False))(vals, x)
    got, aux = moe.moe_apply(mod, torch.from_numpy(x), cfg, drop=False)
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_bf16_keeps_the_router_in_f32_and_rounds_the_gate():
    """In bf16 the router stays f32 (as in the reference); the result
    is in x's dtype.  Against the reference in bf16 the two frameworks
    round the expert products at other places, so the bound is bf16's:
    1e-2 of the output's largest value."""
    d, d_ff = 32, 48
    cfg_kw = dict(num_experts=4, top_k=2, tokens_per_group=16)
    rcfg, vals, cfg, mod = carried(d, d_ff, cfg_kw, seed=5,
                                   dtype=jnp.bfloat16)
    assert mod.router.dtype == torch.float32
    assert mod.wi.dtype == torch.bfloat16
    x32 = np.random.default_rng(5).standard_normal((2, 12, d))
    x = torch.from_numpy(x32.astype(np.float32)).bfloat16()
    assert_no_ties(mod, x, cfg)
    got, _ = moe.moe_apply(mod, x, cfg, drop=False)
    assert got.dtype == torch.bfloat16
    want, _ = ref_moe.moe_apply(vals, jnp.asarray(x.float().numpy(),
                                                  jnp.bfloat16),
                                rcfg, drop=False)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max()


def test_every_token_reaches_its_experts():
    """Weighted sum of each token's top-k experts' SwiGLU outputs,
    written out token by token."""
    d, d_ff = 16, 24
    cfg = moe.MoEConfig(num_experts=4, top_k=2)
    mod = moe.moe_init(d, d_ff, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 10, d, generator=torch.Generator().manual_seed(2))
    got, _ = moe.moe_apply(mod, x, cfg, drop=False)
    _, gate, idx = moe.route(mod, x[0], cfg)
    for t in range(10):
        want = torch.zeros(d)
        for g, e in zip(gate[t], idx[t]):
            h = (torch.nn.functional.silu(x[0, t] @ mod.wg[e])
                 * (x[0, t] @ mod.wi[e]))
            want += g * (h @ mod.wo[e])
        torch.testing.assert_close(got[0, t], want, atol=1e-5, rtol=1e-5)


def test_capacity_drop_routing_raises():
    """Capacity-drop routing (the default, ``drop=True``) is ported: with
    every token routed to experts 0 then 1 and 4 slots an expert (8
    tokens a group, capacity factor 1), the first four tokens keep both
    choices and the last four lose both, so their output is 0; with
    ``drop=False`` every token is served (``tests/test_torch_moe_drop.py``,
    against the reference's ``moe_apply``, holds the general case)."""
    d = 8
    cfg = moe.MoEConfig(num_experts=4, top_k=2, tokens_per_group=8,
                        capacity_factor=1.0)
    mod = moe.moe_init(d, 8, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod.router.zero_()
        mod.router[0] = torch.tensor([3.0, 2.0, 0.0, 0.0])
    x = torch.ones(1, 8, d) + 0.1 * torch.randn(
        1, 8, d, generator=torch.Generator().manual_seed(1))
    keep = moe.capacity_keep(moe.route(mod, x[0], cfg)[2], cfg)
    assert keep.tolist() == [[True, True]] * 4 + [[False, False]] * 4
    y, _ = moe.moe_apply(mod, x, cfg)
    full, _ = moe.moe_apply(mod, x, cfg, drop=False)
    assert torch.equal(y[0, 4:], torch.zeros(4, d))
    torch.testing.assert_close(y[0, :4], full[0, :4], rtol=0, atol=0)
    assert bool((full[0, 4:] != 0).any())
