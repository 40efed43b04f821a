"""The port's transformer family (``repro_torch.models.transformer``)
against the reference, in f32 on the CPU (the kernels' plain versions):

* the six configs equal the reference's, field for field, with the same
  parameter counts;
* ``block_apply`` — dense, MoE, dense + MoE (arctic), windowed — on
  carried weights, without and with a cache;
* each of the six reduced architectures with every parameter carried by
  ``repro_torch.interop.model_from_reference``: prefill logits and every
  decode step's logits at rtol/atol 2e-4 (the model tests' bound), the
  windowed mixtral over more tokens than its reduced window of 16;
* greedy serve tokens equal to the reference's serve loop;
* the port's own prefill-then-decode against a full prefill, at 2e-4.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs.reduced import reduced_arch as ref_reduced_arch
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tfm
from repro.models.layers import unzip_params
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import copy_params, model_from_reference
from repro_torch.launch import serve
from repro_torch.models import attention, transformer

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["llama3-8b", "codeqwen1.5-7b", "yi-34b", "deepseek-67b",
         "mixtral-8x7b", "arctic-480b"]


def close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


def f32_pair(arch_id):
    rspec, pspec = ref_reduced_arch(arch_id), reduced_arch(arch_id)
    return (rspec, dataclasses.replace(rspec.config, dtype=jnp.float32),
            pspec, dataclasses.replace(pspec.config, dtype=torch.float32))


# --- configs -------------------------------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_equal_the_reference(arch_id):
    for full in (True, False):
        rcfg = (ref_get_arch if full else ref_reduced_arch)(arch_id).config
        pcfg = (get_arch if full else reduced_arch)(arch_id).config
        r = {k: v for k, v in dataclasses.asdict(rcfg).items()
             if k != "dtype"}
        p = {k: v for k, v in dataclasses.asdict(pcfg).items()
             if k != "dtype"}
        assert p == r
        assert pcfg.dtype == torch.bfloat16 and rcfg.dtype == jnp.bfloat16
        assert pcfg.param_count == rcfg.param_count
        assert pcfg.active_param_count == rcfg.active_param_count
    assert get_arch("llama3-8b").config.param_count == 8_030_261_248


# --- one block -----------------------------------------------------------------


BLOCKS = {
    "dense": "llama3-8b",
    "moe": "mixtral-8x7b",          # MoE only, windowed
    "dense+moe": "arctic-480b",
    "windowed-dense": None,         # llama3's reduced block with a window
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_apply_matches_the_reference(kind):
    _, rcfg, _, pcfg = f32_pair(BLOCKS[kind] or "llama3-8b")
    if BLOCKS[kind] is None:
        rcfg = dataclasses.replace(rcfg, window=5)
        pcfg = dataclasses.replace(pcfg, window=5)
    vals = jax.tree.map(np.asarray, unzip_params(
        ref_tfm.block_init(jax.random.key(4), rcfg))[0])
    blk = transformer.block_init(pcfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    copy_params(blk, vals)
    assert hasattr(blk, "mlp") == (kind != "moe")
    assert hasattr(blk, "moe") == (kind in ("moe", "dense+moe"))
    b, total = 2, 24
    x = np.random.default_rng(4).standard_normal(
        (b, total, pcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (b, total))
    ref = jax.jit(lambda v, x, p, c: ref_tfm.block_apply(
        rcfg, v, x, positions=p, cache=c),
                  donate_argnums=(3,))
    if pcfg.moe is None:  # without a cache the reference's MoE drops
        want, _, _ = ref(vals, x, pos, None)
        got, _, _ = transformer.block_apply(
            pcfg, blk, torch.from_numpy(x),
            positions=torch.from_numpy(pos.copy()), cache=None)
        close(got, want)
    rc = ref_attn.init_kv_cache(b, total, pcfg.kv_heads, pcfg.head_dim,
                                jnp.float32)
    pc = attention.KVCache(
        torch.zeros(b, total, pcfg.kv_heads, pcfg.head_dim),
        torch.zeros(b, total, pcfg.kv_heads, pcfg.head_dim), 0)
    for lo, hi in [(0, 19), (19, 20), (20, 21), (21, 24)]:
        p = pos[:, lo:hi]
        want, rc, want_aux = ref(vals, x[:, lo:hi], p, rc)
        got, pc, aux = transformer.block_apply(
            pcfg, blk, torch.from_numpy(x[:, lo:hi]),
            positions=torch.from_numpy(p.copy()), cache=pc)
        close(got, want)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
        assert pc.length == int(rc.length) == hi


# --- reduced models ----------------------------------------------------------


def carried(arch_id, seed=2):
    rspec, rcfg, pspec, pcfg = f32_pair(arch_id)
    values, _ = unzip_params(rspec.family.init(jax.random.key(seed), rcfg))
    values = jax.tree.map(np.asarray, values)
    model = model_from_reference(pspec.family_name, pcfg, values,
                                 device="cpu")
    return rspec, rcfg, values, pspec, pcfg, model


@pytest.mark.parametrize("arch_id", ARCHS)
def test_reduced_model_prefill_and_decode_match_reference(arch_id):
    """Prefill 25 tokens and decode 5 (30 in all): mixtral's reduced
    window of 16 cuts every row of both."""
    rspec, rcfg, values, pspec, pcfg, model = carried(arch_id)
    assert pspec.family_name == "transformer"
    rfam, pfam = rspec.family, pspec.family
    b, total, split = 2, 30, 25
    toks = np.random.default_rng(0).integers(0, rspec.vocab, (b, total),
                                             dtype=np.int32)
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
    assert pc.length == total
    assert got.shape == (b, pcfg.padded_vocab)
    assert bool((got[:, rspec.vocab:] == -1e30).all())


def reference_greedy(spec, cfg, values, prompt, gen):
    """The reference's serve loop, greedy, on the given prompt."""
    fam = spec.family
    caches = fam.init_caches(cfg, batch=prompt.shape[0],
                             max_len=prompt.shape[1] + gen)
    prefill = jax.jit(lambda p, b, c: fam.prefill(p, b, cfg, c),
                      donate_argnums=(2,))
    decode = jax.jit(lambda p, b, c, n: fam.decode_step(p, b, cfg, c, n),
                     donate_argnums=(2,))
    logits, caches = prefill(values, {"tokens": jnp.asarray(prompt)}, caches)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out, length = [tok], jnp.asarray(prompt.shape[1], jnp.int32)
    for _ in range(gen - 1):
        logits, caches = decode(values, {"token": tok}, caches, length)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
        length = length + 1
    return np.concatenate([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("arch_id", ["llama3-8b", "mixtral-8x7b"])
def test_greedy_tokens_equal_the_reference_on_carried_weights(arch_id):
    rspec, rcfg, values, _, pcfg, model = carried(arch_id, seed=3)
    gen = 6
    res = serve.serve(arch_id, reduced=True, batch=2, prompt_len=14,
                      gen=gen, seed=0, device="cpu", dtype=torch.float32,
                      model=model)
    want = reference_greedy(rspec, rcfg, values, res["prompt"], gen)
    assert res["tokens"].shape == (2, gen)
    np.testing.assert_array_equal(res["tokens"], want)


@pytest.mark.parametrize("arch_id", ["llama3-8b", "mixtral-8x7b",
                                     "arctic-480b"])
def test_prefill_then_decode_matches_full_prefill(arch_id):
    """The port's own cache consistency: KV append at the cache length,
    the window's band over the cache, exact MoE routing per token."""
    pspec = reduced_arch(arch_id)
    cfg = dataclasses.replace(pspec.config, dtype=torch.float32)
    fam = pspec.family
    model = fam.init(cfg, device="cpu", seed=2)
    b, total, split = 2, 27, 19
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, pspec.vocab, (b, total)))
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


def test_moe_forward_without_a_cache_raises():
    """A MoE forward without caches routes by capacity (the reference's
    training path) and no longer raises: for mixtral and arctic its
    logits and aux loss equal the reference's forward at the smoke shape
    (256 tokens, groups of 32, where pairs overflow), at 2e-4."""
    for arch_id in ("mixtral-8x7b", "arctic-480b"):
        rspec, rcfg, values, pspec, pcfg, model = carried(arch_id)
        toks = np.random.default_rng(4).integers(0, pspec.vocab, (4, 64))
        # repro-lint: disable=JP120 -- one reference forward per arch's config
        want, _, want_aux = jax.jit(
            lambda v, t: ref_tfm.forward(v, t, rcfg))(
                values, toks.astype(np.int32))
        logits, caches, aux = transformer.forward(
            model, torch.from_numpy(toks), pcfg)
        assert caches is None and logits.grad_fn is None
        close(logits, want, pspec.vocab)
        np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_main_serves_the_reduced_family_on_cpu(capsys):
    for arch in ("llama3-8b", "mixtral-8x7b"):
        rc = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--batch", "2", "--prompt-len", "20", "--gen", "4"])
        assert rc == 0
        assert "prefill: 2x20" in capsys.readouterr().out
    assert serve.DEFAULT_ARCH == "llama3-8b"
