"""The port's serving entry point (``repro_torch.launch.serve``) on the
CPU: ``main`` runs the reduced ported architectures, and on weights
carried from the reference its greedy tokens equal those of the
reference's prefill-and-decode loop (``repro/launch/serve.py``) on the
same seeded prompts, in f32."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduced import reduced_arch as ref_reduced_arch
from repro.models.layers import unzip_params
from repro_torch.configs.reduced import reduced_arch
from repro_torch.interop import model_from_reference
from repro_torch.launch import serve


@pytest.mark.parametrize("arch_id", ["zamba2-1.2b", "mamba2-780m"])
def test_main_serves_reduced_on_cpu(arch_id, capsys):
    rc = serve.main(["--arch", arch_id, "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "9", "--gen", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill: 2x9" in out and "3 steps" in out


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


def test_greedy_tokens_equal_the_reference_on_carried_weights():
    arch, gen = "zamba2-1.2b", 6
    rspec = ref_reduced_arch(arch)
    rcfg = dataclasses.replace(rspec.config, dtype=jnp.float32)
    values = jax.tree.map(np.asarray, unzip_params(
        rspec.family.init(jax.random.key(3), rcfg))[0])
    pcfg = dataclasses.replace(reduced_arch(arch).config, dtype=torch.float32)
    model = model_from_reference("hybrid", pcfg, values, device="cpu")
    res = serve.serve(arch, reduced=True, batch=2, prompt_len=11, gen=gen,
                      seed=0, device="cpu", dtype=torch.float32, model=model)
    want = reference_greedy(rspec, rcfg, values, res["prompt"], gen)
    assert res["tokens"].shape == (2, gen)
    np.testing.assert_array_equal(res["tokens"], want)


def test_temperature_sampling_is_seeded():
    kw = dict(reduced=True, batch=2, prompt_len=5, gen=5, temperature=1.0,
              device="cpu")
    a = serve.serve("mamba2-780m", seed=4, **kw)
    b = serve.serve("mamba2-780m", seed=4, **kw)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].max() < 256


def test_serve_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(reduced=True)
