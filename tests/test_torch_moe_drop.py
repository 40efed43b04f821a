"""The port's capacity-drop MoE routing (``moe_apply(drop=True)``, the
training path) against the reference's, on the reduced mixtral-8x7b and
arctic-480b MoE configs (4 experts, top 2, groups of 32, capacity
factor 1.25: 20 slots an expert a group) and on token counts that are
not a multiple of the group, in f32 on the CPU:

* the same kept (token, choice) set: the reference's ``keep`` mask
  computed by its own lines (a choice-major running count of each
  expert's pairs in a group, against ``_capacity``) equals
  ``capacity_keep``, and some pairs are dropped;
* y within rtol/atol 2e-4 (the models' bound) and the aux loss within
  1e-6, on carried weights;
* the gradients of a loss of y and aux, with respect to x and every
  MoE weight, within 2e-4 of the reference's relative to each one's
  largest |g|.

``torch.topk`` does not promise JAX's tie order, so each case checks
that its inputs leave a gap between the k-th and the next router
probability.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_arch as ref_reduced_arch
from repro.models import moe as ref_moe
from repro.models.layers import unzip_params
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import copy_params
from repro_torch.models import moe

TOL = dict(rtol=2e-4, atol=2e-4)
GAP = 1e-4
GRAD_TOL = 2e-4
#: (arch, batch, seq, pairs dropped): at 256 tokens (the smoke shape's,
#: groups of 32) some pairs overflow; 90 tokens make groups of 30 (20
#: slots for 15 pairs an expert on average: none overflows here) and a
#: prime 97 groups of one token (4 slots, never full).
CASES = [("mixtral-8x7b", 4, 64, True), ("arctic-480b", 4, 64, True),
         ("mixtral-8x7b", 3, 30, False), ("arctic-480b", 1, 97, False)]
IDS = ["mixtral_256", "arctic_256", "mixtral_90_groups_of_30",
       "arctic_97_prime"]


def reference_keep(idx: np.ndarray, cfg) -> np.ndarray:
    """The reference's ``keep`` ``[T, k]`` (its ``moe_apply`` lines)."""
    t, k = idx.shape
    g = min(cfg.tokens_per_group, t)
    while t % g:
        g -= 1
    n = t // g
    onehot = jax.nn.one_hot(jnp.asarray(idx).reshape(n, g, k),
                            cfg.num_experts, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(n, k * g, cfg.num_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(
        n, k, g, cfg.num_experts).transpose(0, 2, 1, 3)
    keep = (pos < ref_moe._capacity(g, cfg)) * onehot
    return np.asarray(keep.sum(-1)).reshape(t, k).astype(bool)


def setup(arch, b, s, seed=0):
    rcfg = ref_reduced_arch(arch).config
    pcfg = reduced_arch(arch).config
    assert pcfg.moe == moe.MoEConfig(**vars(rcfg.moe))
    d = rcfg.d_model
    vals = jax.tree.map(np.asarray, unzip_params(ref_moe.moe_init(
        jax.random.key(seed), d, rcfg.d_ff, rcfg.moe, jnp.float32))[0])
    mod = moe.moe_init(d, pcfg.d_ff, pcfg.moe, torch.float32, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    x = np.random.default_rng(seed + b * s).standard_normal(
        (b, s, d)).astype(np.float32)
    probs, _, _ = moe.route(mod, torch.from_numpy(x).reshape(-1, d),
                            pcfg.moe)
    top = torch.sort(probs, dim=-1, descending=True).values
    assert float((top[:, 1] - top[:, 2]).min()) > GAP
    return rcfg.moe, pcfg.moe, vals, mod, x


@pytest.mark.parametrize("arch,b,s,drops", CASES, ids=IDS)
def test_kept_pairs_equal_the_reference(arch, b, s, drops):
    rcfg, pcfg, vals, mod, x = setup(arch, b, s)
    _, _, idx = moe.route(mod, torch.from_numpy(x).reshape(b * s, -1), pcfg)
    got = moe.capacity_keep(idx, pcfg).numpy()
    want = reference_keep(idx.numpy(), rcfg)
    assert np.array_equal(got, want)
    assert bool((~got).any()) == drops
    # first choices win slots: a second choice is dropped at least as
    # often as a first
    assert (~got[:, 1]).sum() >= (~got[:, 0]).sum()


@pytest.mark.parametrize("arch,b,s,drops", CASES, ids=IDS)
def test_drop_routing_matches_the_reference(arch, b, s, drops):
    rcfg, pcfg, vals, mod, x = setup(arch, b, s)
    want, want_aux = jax.jit(lambda v, x: ref_moe.moe_apply(
        v, x, rcfg, drop=True))(vals, x)
    got, aux = moe.moe_apply(mod, torch.from_numpy(x), pcfg, drop=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert abs(float(aux) - float(want_aux)) <= 1e-6
    full, _ = moe.moe_apply(mod, torch.from_numpy(x), pcfg, drop=False)
    assert torch.equal(full, got) != drops


@pytest.mark.parametrize("arch,b,s,drops", CASES[:2], ids=IDS[:2])
def test_drop_routing_gradients_match_the_reference(arch, b, s, drops):
    rcfg, pcfg, vals, mod, x = setup(arch, b, s)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def ref_loss(v, x):
        y, aux = ref_moe.moe_apply(v, x, rcfg, drop=True)
        return jnp.sum(y * w) + 100.0 * aux

    gv, gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(vals, x)
    mod.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(mod, xt, pcfg, drop=True)
    loss = torch.sum(y * torch.from_numpy(w)) + 100.0 * aux
    names = ["router", "wi", "wg", "wo"]
    got = torch.autograd.grad(loss, [getattr(mod, n) for n in names] + [xt])
    for g, want in zip(got, [gv[n] for n in names] + [gx]):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        assert float(np.abs(g.numpy() - want).max()) <= GRAD_TOL * scale
