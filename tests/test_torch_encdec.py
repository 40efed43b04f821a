"""The port's encoder-decoder family (``repro_torch.models.encdec``,
seamless-m4t-medium) against the reference, in f32 on the CPU (kernel
B4's plain version):

* the full and reduced configs equal the reference's, field for field,
  with the same parameter counts;
* the encoder's memory against ``encode``, the cross K/V against
  ``project_cross_kv``, and the decoder without caches (cross K/V
  projected per layer) against ``decode_stack``;
* prefill and every decode step, on weights carried by
  ``repro_torch.interop.model_from_reference``, at rtol/atol 2e-4 (the
  model tests' bound), and greedy serve tokens equal to the reference's
  serve loop on the same prompt and frames;
* a prefix plus decode steps against the whole prefill, in both
  packages, as ``tests/archs/test_decode_consistency.py`` runs it.
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
from repro.models import encdec as ref_encdec
from repro.models.layers import unzip_params
from repro_torch.configs import get_arch
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import model_from_reference
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models.api import get_family

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=2e-4, atol=2e-4)


def close(got: torch.Tensor, want, vocab=None):
    got, want = got.numpy(), np.asarray(want)
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def carried():
    """Reduced f32 configs of both packages and one set of reference
    weights, carried into the port."""
    rspec, pspec = ref_reduced_arch(ARCH), reduced_arch(ARCH)
    rcfg = dataclasses.replace(rspec.config, dtype=jnp.float32)
    pcfg = dataclasses.replace(pspec.config, dtype=torch.float32)
    values = jax.tree.map(np.asarray, unzip_params(
        rspec.family.init(jax.random.key(2), rcfg))[0])
    model = model_from_reference("encdec", pcfg, values, device="cpu")
    return rspec, rcfg, values, pspec, pcfg, model


def frames(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_configs_equal_the_reference(full):
    rcfg = (ref_get_arch if full else ref_reduced_arch)(ARCH).config
    pcfg = (get_arch if full else reduced_arch)(ARCH).config
    r = {k: v for k, v in dataclasses.asdict(rcfg).items() if k != "dtype"}
    p = {k: v for k, v in dataclasses.asdict(pcfg).items() if k != "dtype"}
    assert p == r
    assert pcfg.dtype == torch.bfloat16 and rcfg.dtype == jnp.bfloat16
    assert pcfg.param_count == rcfg.param_count
    assert pcfg.padded_vocab == rcfg.padded_vocab
    if full:
        assert pcfg.param_count == 977_860_608
        assert pcfg.padded_vocab == 256_256
        spec = get_arch(ARCH)
        assert spec.family_name == "encdec" and spec.vocab == 256_206


def test_model_parameters_match_the_reference_count(carried):
    *_, pcfg, model = carried
    assert sum(t.numel() for t in model.parameters()) == pcfg.param_count


def test_encode_cross_kv_and_uncached_decoder_match_the_reference(carried):
    rspec, rcfg, values, _, pcfg, model = carried
    b, s_src, s_tgt = 2, 11, 7
    fr = frames(b, s_src, pcfg.d_model)
    toks = np.random.default_rng(3).integers(0, rspec.vocab, (b, s_tgt),
                                             dtype=np.int32)
    want_mem = jax.jit(lambda p, f: ref_encdec.encode(p, f, rcfg))(values, fr)
    mem = encdec.encode(model, torch.from_numpy(fr), pcfg)
    close(mem, want_mem)
    want_k, want_v = jax.jit(lambda p, m: ref_encdec.project_cross_kv(
        p, m, rcfg))(values, want_mem)
    ks, vs = encdec.project_cross_kv(model, mem, pcfg)
    assert ks.shape == (pcfg.dec_layers, b, s_src, pcfg.kv_heads,
                        pcfg.head_dim)
    close(ks, want_k)
    close(vs, want_v)
    want, _ = jax.jit(lambda p, t, m: ref_encdec.decode_stack(
        p, t, m, rcfg))(values, toks, want_mem)
    got, caches = encdec.decode_stack(model, torch.from_numpy(toks).long(),
                                      mem, pcfg)
    assert caches is None
    close(got, want, rspec.vocab)


@pytest.mark.parametrize("s_src", [9, 20], ids=["src-shorter",
                                                "src-longer"])
def test_prefill_and_every_decode_step_match_the_reference(carried, s_src):
    """A 6-token prompt, 5 decode steps, sources shorter and longer than
    the target (cross-attention at Sq != Sk)."""
    rspec, rcfg, values, pspec, pcfg, model = carried
    b, total, split = 2, 11, 6
    fr = frames(b, s_src, pcfg.d_model, seed=s_src)
    toks = np.random.default_rng(s_src).integers(0, rspec.vocab, (b, total),
                                                 dtype=np.int32)
    rfam, pfam = rspec.family, pspec.family
    rc = rfam.init_caches(rcfg, batch=b, max_len=total, src_len=s_src)
    pc = pfam.init_caches(pcfg, b, total, s_src, device="cpu")
    want, rc = jax.jit(lambda p, bt, c: rfam.prefill(p, bt, rcfg, c))(
        values, {"frames": jnp.asarray(fr),
                 "tokens": jnp.asarray(toks[:, :split])}, rc)
    got, pc = pfam.prefill(
        model, {"frames": torch.from_numpy(fr),
                "tokens": torch.from_numpy(toks[:, :split]).long()}, pcfg, pc)
    close(got, want, rspec.vocab)
    close(pc.cross_k, rc.cross_k)
    decode = jax.jit(lambda p, bt, c, n: rfam.decode_step(p, bt, rcfg, c, n),
                     donate_argnums=(2,))
    for t in range(split, total):
        tok = toks[:, t:t + 1]
        want, rc = decode(values, {"token": jnp.asarray(tok)}, rc,
                          jnp.asarray(t, jnp.int32))
        got, pc = pfam.decode_step(
            model, {"token": torch.from_numpy(tok).long()}, pcfg, pc, t)
        close(got, want, rspec.vocab)
    assert pc.length == pc.self_kv.length == int(rc.length) == total
    assert got.shape == (b, pcfg.padded_vocab)
    assert bool((got[:, rspec.vocab:] == -1e30).all())


def reference_greedy(spec, cfg, values, prompt, sources, gen):
    """The reference's serve loop, greedy, on the given prompt and
    frames (the cache sizes and decode lengths of its serve loop)."""
    fam = spec.family
    b, plen = prompt.shape
    caches = fam.init_caches(cfg, batch=b, max_len=plen + gen,
                             src_len=sources["frames"].shape[1])
    prefill = jax.jit(lambda p, bt, c: fam.prefill(p, bt, cfg, c),
                      donate_argnums=(2,))
    decode = jax.jit(lambda p, bt, c, n: fam.decode_step(p, bt, cfg, c, n),
                     donate_argnums=(2,))
    logits, caches = prefill(values, {"tokens": jnp.asarray(prompt),
                                      "frames": jnp.asarray(
                                          sources["frames"])}, caches)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out, length = [tok], jnp.asarray(plen, jnp.int32)
    for _ in range(gen - 1):
        logits, caches = decode(values, {"token": tok}, caches, length)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
        length = length + 1
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def test_greedy_tokens_equal_the_reference_on_carried_weights(carried):
    rspec, rcfg, values, _, pcfg, model = carried
    gen = 6
    res = serve.serve(ARCH, reduced=True, batch=2, prompt_len=10, gen=gen,
                      seed=0, device="cpu", dtype=torch.float32, model=model)
    assert res["sources"]["frames"].shape == (2, 10, pcfg.d_model)
    want = reference_greedy(rspec, rcfg, values, res["prompt"],
                            res["sources"], gen)
    assert res["tokens"].shape == (2, gen)
    np.testing.assert_array_equal(res["tokens"], want)


def test_prefill_then_decode_matches_full_prefill_in_both_packages(carried):
    """Cache consistency: the decoder's self-cache appended at its
    length, the cross K/V reused from the cache at every step; the
    reference's at the same inputs for comparison."""
    rspec, rcfg, values, pspec, pcfg, model = carried
    b, total, split, s_src = 2, 12, 7, 8
    fr = frames(b, s_src, pcfg.d_model, seed=0)
    toks = np.random.default_rng(0).integers(0, rspec.vocab, (b, total),
                                             dtype=np.int32)
    fam = pspec.family

    def batch(t):
        return {"frames": torch.from_numpy(fr),
                "tokens": torch.from_numpy(t).long()}

    full, _ = fam.prefill(model, batch(toks), pcfg,
                          fam.init_caches(pcfg, b, total, s_src,
                                          device="cpu"))
    logits, caches = fam.prefill(model, batch(toks[:, :split]), pcfg,
                                 fam.init_caches(pcfg, b, total, s_src,
                                                 device="cpu"))
    for t in range(split, total):
        logits, caches = fam.decode_step(
            model, {"token": torch.from_numpy(toks[:, t:t + 1]).long()},
            pcfg, caches, t)
    v = pspec.vocab
    np.testing.assert_allclose(logits[:, :v].numpy(), full[:, :v].numpy(),
                               **TOL)
    rfam = rspec.family
    want_full, _ = jax.jit(lambda p, bt, c: rfam.prefill(p, bt, rcfg, c))(
        values, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)},
        rfam.init_caches(rcfg, batch=b, max_len=total, src_len=s_src))
    close(full, want_full, v)


def test_layers_cut_both_stacks_and_are_reported():
    res = serve.serve(ARCH, reduced=True, batch=1, prompt_len=5, gen=2,
                      device="cpu", layers=1)
    assert (res["layers"], res["enc_layers"], res["dec_layers"]) == (2, 1, 1)
    full = serve.serve(ARCH, reduced=True, batch=1, prompt_len=5, gen=2,
                       device="cpu")
    assert (full["layers"], full["enc_layers"], full["dec_layers"]) == (
        4, 2, 2)


def test_family_api_and_main_on_cpu(capsys):
    fam = get_family("encdec")
    assert fam.name == "encdec"
    rc = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill: 2x9" in out and "3 steps" in out
