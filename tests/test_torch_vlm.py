"""The port's VLM family (``repro_torch.models.multimodal``,
phi-3-vision-4.2b) against the reference, in f32 on the CPU (kernel B4's
plain version):

* the full and reduced configs equal the reference's, field for field,
  with the same parameter counts;
* the backbone's ``forward`` with ``prefix_embeds`` against the
  reference's, every position;
* prefill and every decode step, on weights carried by
  ``repro_torch.interop.model_from_reference``, at rtol/atol 2e-4, at the
  reduced head dim (16) and at phi-3's own 96 (set in both packages by
  ``dataclasses.replace``), with decode lengths ``num_patches + t``;
  greedy serve tokens equal to the reference's prefill and decode steps
  at those lengths;
* a prefix plus decode steps against the whole prefill;
* ROADMAP C7: the reference's serve loop decodes at ``length =
  prompt_len``, which moves its logits away from its own full forward;
  the port's serve length does not.
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
from repro.models import multimodal as ref_mm
from repro.models import transformer as ref_tfm
from repro.models.layers import unzip_params
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import model_from_reference
from repro_torch.launch import serve
from repro_torch.models import multimodal, transformer
from repro_torch.models.api import get_family

ARCH = "phi-3-vision-4.2b"
TOL = dict(rtol=2e-4, atol=2e-4)


def close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


def f32(cfg, dtype, **backbone):
    return dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, dtype=dtype, **backbone))


_CARRIED = {}


def carried(head_dim=None):
    """Reduced f32 configs of both packages (``head_dim`` set in both)
    and one set of reference weights carried into the port."""
    if head_dim not in _CARRIED:
        kw = {} if head_dim is None else {"head_dim": head_dim}
        rspec, pspec = ref_reduced_arch(ARCH), reduced_arch(ARCH)
        rcfg = f32(rspec.config, jnp.float32, **kw)
        pcfg = f32(pspec.config, torch.float32, **kw)
        values = jax.tree.map(np.asarray, unzip_params(
            rspec.family.init(jax.random.key(2), rcfg))[0])
        model = model_from_reference("vlm", pcfg, values, device="cpu")
        _CARRIED[head_dim] = rspec, rcfg, values, pspec, pcfg, model
    return _CARRIED[head_dim]


def inputs(cfg, vocab, b, total, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, total), dtype=np.int32)
    patches = rng.standard_normal(
        (b, cfg.num_patches, cfg.clip_dim)).astype(np.float32)
    return toks, patches


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_configs_equal_the_reference(full):
    rcfg = (ref_get_arch if full else ref_reduced_arch)(ARCH).config
    pcfg = (get_arch if full else reduced_arch)(ARCH).config

    def fields(cfg):
        d = dataclasses.asdict(cfg)
        del d["backbone"]["dtype"]
        return d

    assert fields(pcfg) == fields(rcfg)
    assert pcfg.backbone.dtype == torch.bfloat16
    assert rcfg.backbone.dtype == jnp.bfloat16
    assert pcfg.param_count == rcfg.param_count
    assert pcfg.padded_vocab == rcfg.padded_vocab
    if full:
        assert pcfg.param_count == 3_824_618_496
        assert pcfg.backbone.head_dim == 96 and pcfg.padded_vocab == 32_128
        spec = get_arch(ARCH)
        assert spec.family_name == "vlm" and spec.vocab == 32_064


def test_model_parameters_match_the_reference_count():
    *_, pcfg, model = carried()
    assert sum(t.numel() for t in model.parameters()) == pcfg.param_count


def test_forward_with_prefix_embeds_matches_the_reference():
    rspec, rcfg, values, _, pcfg, model = carried()
    toks, patches = inputs(pcfg, rspec.vocab, 2, 5, seed=4)
    prefix = np.asarray(ref_mm._project(values, patches))
    got_prefix = multimodal._project(model, torch.from_numpy(patches))
    close(got_prefix, prefix)
    want, _, _ = jax.jit(lambda p, t, e: ref_tfm.forward(
        p, t, rcfg.backbone, prefix_embeds=e))(values["backbone"], toks,
                                               prefix)
    got, _, _ = transformer.forward(model.backbone,
                                    torch.from_numpy(toks).long(),
                                    pcfg.backbone, prefix_embeds=got_prefix)
    assert got.shape == (2, pcfg.num_patches + 5, pcfg.padded_vocab)
    close(got, want, rspec.vocab)


@pytest.mark.parametrize("head_dim", [None, 96], ids=["reduced-hd", "hd96"])
def test_prefill_and_every_decode_step_match_the_reference(head_dim):
    """8 patches and a 6-token prompt, then 5 decode steps at lengths
    ``num_patches + t`` (the cache's own positions)."""
    rspec, rcfg, values, pspec, pcfg, model = carried(head_dim)
    if head_dim is not None:
        assert pcfg.backbone.head_dim == rcfg.backbone.head_dim == head_dim
    b, total, split = 2, 11, 6
    toks, patches = inputs(pcfg, rspec.vocab, b, total, seed=5)
    p = pcfg.num_patches
    rfam, pfam = rspec.family, pspec.family
    rc = rfam.init_caches(rcfg, batch=b, max_len=p + total)
    pc = pfam.init_caches(pcfg, b, p + total, device="cpu")
    want, rc = jax.jit(lambda v, bt, c: rfam.prefill(v, bt, rcfg, c))(
        values, {"patches": jnp.asarray(patches),
                 "tokens": jnp.asarray(toks[:, :split])}, rc)
    got, pc = pfam.prefill(
        model, {"patches": torch.from_numpy(patches),
                "tokens": torch.from_numpy(toks[:, :split]).long()}, pcfg, pc)
    close(got, want, rspec.vocab)
    assert pc.length == p + split
    decode = jax.jit(lambda v, bt, c, n: rfam.decode_step(v, bt, rcfg, c, n),
                     donate_argnums=(2,))
    for t in range(split, total):
        tok = toks[:, t:t + 1]
        want, rc = decode(values, {"token": jnp.asarray(tok)}, rc,
                          jnp.asarray(p + t, jnp.int32))
        got, pc = pfam.decode_step(
            model, {"token": torch.from_numpy(tok).long()}, pcfg, pc, p + t)
        close(got, want, rspec.vocab)
    assert pc.length == p + total
    assert bool((got[:, rspec.vocab:] == -1e30).all())


def reference_greedy(spec, cfg, values, prompt, patches, gen):
    """The reference's prefill and decode steps, greedy, with its
    serve loop's cache size and the model's decode lengths
    (``num_patches + prompt_len + t``)."""
    fam = spec.family
    b, plen = prompt.shape
    p = cfg.num_patches
    caches = fam.init_caches(cfg, batch=b, max_len=plen + gen + p)
    prefill = jax.jit(lambda v, bt, c: fam.prefill(v, bt, cfg, c),
                      donate_argnums=(2,))
    decode = jax.jit(lambda v, bt, c, n: fam.decode_step(v, bt, cfg, c, n),
                     donate_argnums=(2,))
    logits, caches = prefill(values, {"tokens": jnp.asarray(prompt),
                                      "patches": jnp.asarray(patches)},
                             caches)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out, length = [tok], jnp.asarray(p + plen, jnp.int32)
    for _ in range(gen - 1):
        logits, caches = decode(values, {"token": tok}, caches, length)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
        length = length + 1
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def test_greedy_tokens_equal_the_reference_on_carried_weights():
    rspec, rcfg, values, _, pcfg, model = carried()
    gen = 6
    res = serve.serve(ARCH, reduced=True, batch=2, prompt_len=7, gen=gen,
                      seed=0, device="cpu", dtype=torch.float32, model=model)
    patches = res["sources"]["patches"]
    assert patches.shape == (2, pcfg.num_patches, pcfg.clip_dim)
    want = reference_greedy(rspec, rcfg, values, res["prompt"], patches, gen)
    np.testing.assert_array_equal(res["tokens"], want)


def test_prefill_then_decode_matches_full_prefill():
    rspec, _, _, pspec, pcfg, model = carried(96)
    b, total, split = 2, 12, 7
    toks, patches = inputs(pcfg, rspec.vocab, b, total, seed=0)
    p = pcfg.num_patches
    fam = pspec.family

    def batch(t):
        return {"patches": torch.from_numpy(patches),
                "tokens": torch.from_numpy(t).long()}

    full, _ = fam.prefill(model, batch(toks), pcfg,
                          fam.init_caches(pcfg, b, p + total, device="cpu"))
    logits, caches = fam.prefill(model, batch(toks[:, :split]), pcfg,
                                 fam.init_caches(pcfg, b, p + total,
                                                 device="cpu"))
    for t in range(split, total):
        logits, caches = fam.decode_step(
            model, {"token": torch.from_numpy(toks[:, t:t + 1]).long()},
            pcfg, caches, p + t)
    v = pspec.vocab
    np.testing.assert_allclose(logits[:, :v].numpy(), full[:, :v].numpy(),
                               **TOL)


def test_c7_reference_serve_length_moves_away_from_the_full_forward():
    """ROADMAP C7.  After a prompt of S text tokens behind P patches the
    next token sits at position P + S.  The reference's serve loop
    decodes it at ``length = S`` (``repro/launch/serve.py``): RoPE at S
    and a causal mask that hides the prompt's tail and the token itself,
    so its logits leave its own full forward over ``patches + tokens +
    next``.  At ``P + S``, the length the port's serve loop passes, both
    packages agree with that forward."""
    rspec, rcfg, values, pspec, pcfg, model = carried()
    b, s = 2, 6
    toks, patches = inputs(pcfg, rspec.vocab, b, s + 1, seed=7)
    p = pcfg.num_patches
    rfam = rspec.family
    prefill = jax.jit(lambda v, bt, c: rfam.prefill(v, bt, rcfg, c),
                      donate_argnums=(2,))
    decode = jax.jit(lambda v, bt, c, n: rfam.decode_step(v, bt, rcfg, c, n),
                     donate_argnums=(2,))
    full, _ = prefill(values, {"patches": jnp.asarray(patches),
                               "tokens": jnp.asarray(toks)},
                      rfam.init_caches(rcfg, batch=b, max_len=p + s + 1))
    full = np.asarray(full)[:, :rspec.vocab]
    scale = np.abs(full).max()

    def ref_decode(length):
        _, rc = prefill(values, {"patches": jnp.asarray(patches),
                                 "tokens": jnp.asarray(toks[:, :s])},
                        rfam.init_caches(rcfg, batch=b, max_len=p + s + 1))
        logits, _ = decode(values, {"token": jnp.asarray(toks[:, s:])}, rc,
                           jnp.asarray(length, jnp.int32))
        return np.asarray(logits)[:, :rspec.vocab]

    assert np.abs(ref_decode(s) - full).max() > 0.1 * scale
    np.testing.assert_allclose(ref_decode(p + s), full, **TOL)
    res = serve.serve(ARCH, reduced=True, batch=b, prompt_len=s, gen=2,
                      device="cpu", dtype=torch.float32, model=model)
    fam = pspec.family
    sources = res["sources"]
    caches = serve.new_caches(pspec, pcfg, b, s + 1, sources, device="cpu")
    whole = np.concatenate([res["prompt"], res["tokens"][:, :1]], axis=1)
    want, _ = fam.prefill(model, serve.prefill_batch(pcfg, whole, sources,
                                                     "cpu"), pcfg, caches)
    caches = serve.new_caches(pspec, pcfg, b, s + 1, sources, device="cpu")
    _, caches = fam.prefill(model, serve.prefill_batch(
        pcfg, res["prompt"], sources, "cpu"), pcfg, caches)
    assert serve.prefix_len(pspec, pcfg) + s == caches.length == p + s
    got, _ = fam.decode_step(
        model, {"token": torch.from_numpy(res["tokens"][:, :1]).long()},
        pcfg, caches, caches.length)
    close(got, want.numpy(), rspec.vocab)


def test_family_api_and_main_on_cpu(capsys):
    fam = get_family("vlm")
    assert fam.name == "vlm"
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill: 2x9" in out and "3 steps" in out
    res = serve.serve(ARCH, reduced=True, batch=1, prompt_len=4, gen=2,
                      device="cpu", layers=1)
    assert res["layers"] == 1 and "enc_layers" not in res
