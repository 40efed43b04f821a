"""The port's model zoo slice against the reference, in f32 (as
``tests/archs/test_decode_consistency.py`` runs it): ``gqa_attention``
(self, cached, windowed and cross-attention) and ``block_apply`` on
carried weights, and the reduced ``zamba2-1.2b``
and ``mamba2-780m`` with every parameter carried across by
``repro_torch.interop.model_from_reference`` — prefill logits and every
decode step's logits at rtol/atol 2e-4, on the CPU (the kernels' plain
versions); the windowed attention the transformer family uses (its
reduced architectures: ``tests/test_torch_transformer.py``).  Then the port's own prefill-then-decode against a full
prefill, at the same bound; the ``encdec`` and ``vlm`` families take the
reference's batch keys (their models: ``tests/test_torch_encdec.py``,
``test_torch_vlm.py``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import SMOKE_DECODE, SMOKE_PREFILL
from repro.configs.reduced import reduced_arch as ref_reduced_arch
from repro.models import attention as ref_attn
from repro.models import ssm as ref_ssm
from repro.models.layers import unzip_params
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import copy_params, model_from_reference
from repro_torch.launch import serve
from repro_torch.models import attention, ssm
from repro_torch.models.api import get_family

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["zamba2-1.2b", "mamba2-780m"]


def f32_pair(arch_id):
    rspec, pspec = ref_reduced_arch(arch_id), reduced_arch(arch_id)
    return (rspec, dataclasses.replace(rspec.config, dtype=jnp.float32),
            pspec, dataclasses.replace(pspec.config, dtype=torch.float32))


def carried(arch_id, seed=2):
    rspec, rcfg, pspec, pcfg = f32_pair(arch_id)
    values, _ = unzip_params(rspec.family.init(jax.random.key(seed), rcfg))
    values = jax.tree.map(np.asarray, values)
    model = model_from_reference(pspec.family_name, pcfg, values,
                                 device="cpu")
    return rspec, rcfg, values, pspec, pcfg, model


def close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


# --- modules -----------------------------------------------------------------


def test_gqa_attention_self_prefill_and_decode():
    d, h, hkv, hd, theta = 32, 4, 2, 16, 10000.0
    vals = jax.tree.map(np.asarray, unzip_params(ref_attn.attn_init(
        jax.random.key(0), d, h, hkv, hd))[0])
    mod = attention.attn_init(d, h, hkv, hd, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    ref = jax.jit(lambda v, x, p, c: ref_attn.gqa_attention(
        v, x, positions=p, rope_theta=theta, cache=c),
                  donate_argnums=(3,))
    want, _ = ref(vals, x, pos, None)
    got, _ = attention.gqa_attention(mod, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos.copy()),
                                     rope_theta=theta)
    close(got, want)

    # prefill 7 tokens into a 16-long cache, then decode 4 one by one
    rc = ref_attn.init_kv_cache(2, 16, hkv, hd, jnp.float32)
    pc = attention.KVCache(torch.zeros(2, 16, hkv, hd),
                           torch.zeros(2, 16, hkv, hd), 0)
    for lo, hi in [(0, 7), (7, 8), (8, 9), (9, 10), (10, 11)]:
        p = pos[:, lo:hi]
        want, rc = ref(vals, x[:, lo:hi], p, rc)
        got, pc = attention.gqa_attention(
            mod, torch.from_numpy(x[:, lo:hi]),
            positions=torch.from_numpy(p.copy()), rope_theta=theta,
            cache=pc)
        close(got, want)
        assert pc.length == int(rc.length) == hi


def test_gqa_attention_with_a_window_matches_the_reference():
    """The sliding window on both paths (kernel B4's window, here its
    plain version): self-attention over 11 tokens with a window of 4,
    then a cache filled 7 tokens at once and decoded one by one."""
    d, h, hkv, hd, theta, window = 32, 4, 2, 16, 10000.0, 4
    vals = jax.tree.map(np.asarray, unzip_params(ref_attn.attn_init(
        jax.random.key(3), d, h, hkv, hd))[0])
    mod = attention.attn_init(d, h, hkv, hd, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    ref = jax.jit(lambda v, x, p, c: ref_attn.gqa_attention(
        v, x, positions=p, rope_theta=theta, cache=c, window=window),
                  donate_argnums=(3,))
    want, _ = ref(vals, x, pos, None)
    got, _ = attention.gqa_attention(mod, torch.from_numpy(x),
                                     positions=torch.from_numpy(pos.copy()),
                                     rope_theta=theta, window=window)
    close(got, want)
    rc = ref_attn.init_kv_cache(2, 16, hkv, hd, jnp.float32)
    pc = attention.KVCache(torch.zeros(2, 16, hkv, hd),
                           torch.zeros(2, 16, hkv, hd), 0)
    for lo, hi in [(0, 7), (7, 8), (8, 9), (9, 10), (10, 11)]:
        p = pos[:, lo:hi]
        want, rc = ref(vals, x[:, lo:hi], p, rc)
        got, pc = attention.gqa_attention(
            mod, torch.from_numpy(x[:, lo:hi]),
            positions=torch.from_numpy(p.copy()), rope_theta=theta,
            cache=pc, window=window)
        close(got, want)


def test_gqa_attention_cross_attention_matches_the_reference():
    """``kv_override`` on both paths: a 5-token query (RoPE at its
    positions) over the projected memory of 9 source positions, GQA, not
    causal, no cache update."""
    d, h, hkv, hd, theta = 32, 4, 2, 16, 10000.0
    vals = jax.tree.map(np.asarray, unzip_params(ref_attn.attn_init(
        jax.random.key(5), d, h, hkv, hd))[0])
    mod = attention.attn_init(d, h, hkv, hd, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    memory = rng.standard_normal((2, 9, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 8, dtype=np.int32), (2, 5))
    want_kv = ref_attn.project_kv(vals, memory)
    want, want_cache = ref_attn.gqa_attention(
        vals, x, positions=pos, rope_theta=theta, causal=False,
        kv_override=want_kv)
    kv = attention.project_kv(mod, torch.from_numpy(memory))
    assert kv[0].shape == (2, 9, hkv, hd)
    close(kv[0], want_kv[0])
    close(kv[1], want_kv[1])
    got, cache = attention.gqa_attention(
        mod, torch.from_numpy(x), positions=torch.from_numpy(pos.copy()),
        rope_theta=theta, causal=False, kv_override=kv)
    assert cache is None and want_cache is None
    close(got, want)


def test_block_apply_without_and_with_cache():
    _, rcfg, _, pcfg = f32_pair("mamba2-780m")
    vals = jax.tree.map(np.asarray, unzip_params(
        ref_ssm.block_init(jax.random.key(1), rcfg))[0])
    blk = ssm.block_init(pcfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    copy_params(blk, vals)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 10, pcfg.d_model)).astype(np.float32)
    ref_block = jax.jit(
        lambda v, x, c: ref_ssm.block_apply(rcfg, v, x, cache=c),
        donate_argnums=(2,))
    want, _ = ref_block(vals, x, None)
    got, _ = ssm.block_apply(pcfg, blk, torch.from_numpy(x), cache=None)
    close(got, want)

    rc = jax.tree.map(lambda a: a[0], ref_ssm.init_caches(rcfg, 2))
    pc = ssm.layer_cache(ssm.init_caches(pcfg, 2, device="cpu"), 0)
    for lo, hi in [(0, 6), (6, 7), (7, 8), (8, 10)]:
        want, rc = ref_block(vals, x[:, lo:hi], rc)
        got, pc = ssm.block_apply(pcfg, blk, torch.from_numpy(x[:, lo:hi]),
                                  cache=pc)
        close(got, want)
        close(pc.state, rc.state)
        close(pc.conv_x, rc.conv_x)


# --- reduced models ----------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHS)
def test_reduced_model_prefill_and_decode_match_reference(arch_id):
    rspec, rcfg, values, pspec, pcfg, model = carried(arch_id)
    rfam, pfam = rspec.family, pspec.family
    rng = np.random.default_rng(0)
    b, total, split = 2, 13, 7
    toks = rng.integers(0, rspec.vocab, (b, total), dtype=np.int32)
    rc = rfam.init_caches(rcfg, batch=b, max_len=total)
    pc = pfam.init_caches(pcfg, b, total, device="cpu")
    want, rc = jax.jit(lambda p, bt, c: rfam.prefill(p, bt, rcfg, c))(
        values, {"tokens": jnp.asarray(toks[:, :split])}, rc)
    got, pc = pfam.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :split]).long()}, pcfg, pc)
    close(got, want, rspec.vocab)
    decode = jax.jit(lambda p, bt, c, n: rfam.decode_step(p, bt, rcfg, c, n),
                     donate_argnums=(2,))
    for t in range(split, total):
        tok = toks[:, t:t + 1]
        want, rc = decode(values, {"token": jnp.asarray(tok)}, rc,
                          jnp.asarray(t, jnp.int32))
        got, pc = pfam.decode_step(
            model, {"token": torch.from_numpy(tok).long()}, pcfg, pc, t)
        close(got, want, rspec.vocab)
    assert got.shape == (b, pcfg.padded_vocab)
    assert bool((got[:, rspec.vocab:] == -1e30).all())


@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_then_decode_matches_full_prefill(arch_id):
    """The port's own cache consistency (conv tails, SSM state handoff
    through kernel B5's h0/final, KV append at the cache length)."""
    pspec = reduced_arch(arch_id)
    cfg = dataclasses.replace(pspec.config, dtype=torch.float32)
    fam = pspec.family
    model = fam.init(cfg, device="cpu", seed=2)
    rng = np.random.default_rng(0)
    b, total, split = 2, 12, 7
    toks = torch.from_numpy(rng.integers(0, pspec.vocab, (b, total)))
    full, _ = fam.prefill(model, {"tokens": toks}, cfg,
                          fam.init_caches(cfg, b, total, device="cpu"))
    logits, caches = fam.prefill(model, {"tokens": toks[:, :split]}, cfg,
                                 fam.init_caches(cfg, b, total, device="cpu"))
    for t in range(split, total):
        logits, caches = fam.decode_step(model, {"token": toks[:, t:t + 1]},
                                         cfg, caches, t)
    assert caches.length == total
    v = pspec.vocab
    np.testing.assert_allclose(logits[:, :v].numpy(), full[:, :v].numpy(),
                               **TOL)


@pytest.mark.parametrize("arch_id", ["seamless-m4t-medium",
                                     "phi-3-vision-4.2b"])
def test_encdec_and_vlm_families_take_the_reference_batch_keys(arch_id):
    """``get_family`` gives the reference's family name, and its prefill
    and decode take a batch with the keys of the reference's
    ``input_specs`` at its smoke prefill and decode shapes."""
    rspec, pspec = ref_reduced_arch(arch_id), reduced_arch(arch_id)
    fam = get_family(pspec.family_name)
    assert fam.name == pspec.family_name == rspec.family.name
    cfg = serve.with_config(pspec.config, dtype=torch.float32)
    rng = np.random.default_rng(0)

    def batch(shape):
        out = {}
        for name, sds in rspec.input_specs(shape).items():
            if np.issubdtype(sds.dtype, np.integer):
                out[name] = torch.from_numpy(rng.integers(
                    0, pspec.vocab, sds.shape)).long()
            else:
                out[name] = torch.from_numpy(rng.standard_normal(
                    sds.shape).astype(np.float32))
        return out

    prefill = batch(SMOKE_PREFILL)
    assert set(prefill) == ({"frames", "tokens"} if fam.name == "encdec"
                            else {"patches", "tokens"})
    kw = rspec.cache_kwargs(SMOKE_PREFILL)
    if fam.name == "vlm":
        kw["max_len"] += 1   # the decode step's position
    else:
        kw["max_len"] = prefill["tokens"].shape[1] + 1
    caches = fam.init_caches(cfg, **kw, device="cpu")
    model = fam.init(cfg, device="cpu", seed=0)
    logits, caches = fam.prefill(model, prefill, cfg, caches)
    assert logits.shape == (2, cfg.padded_vocab)
    step = batch(SMOKE_DECODE)
    assert set(step) == {"token"}
    logits, caches = fam.decode_step(model, step, cfg, caches,
                                     caches.length)
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits[:, :pspec.vocab]).all())


def test_the_transformer_family_is_ported():
    fam = get_family("transformer")
    assert fam.name == "transformer"
    cfg = dataclasses.replace(reduced_arch("llama3-8b").config,
                              dtype=torch.float32)
    model = fam.init(cfg, device="cpu", seed=0)
    caches = fam.init_caches(cfg, 1, 5, device="cpu")
    logits, caches = fam.prefill(
        model, {"tokens": torch.arange(4).reshape(1, 4)}, cfg, caches)
    assert logits.shape == (1, cfg.padded_vocab) and caches.length == 4
