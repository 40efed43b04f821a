"""Batched serving: prefill + greedy decode loop with cache reuse.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-medium --reduced --device cpu

Mirrors ``repro/launch/serve.py`` on one device: one prefill over the
batch of seeded prompts, then token-by-token decode against the caches
(the transformer's per-layer KV caches, the hybrid's shared attention
sites' caches and the O(1) Mamba2 states, the encoder-decoder's self and
cross caches, the VLM's backbone caches behind its patch prefix).  The
prefill batch is the one ``repro/launch/serve.py`` builds: the prompt's
token ids, then, from the same seeded generator, an encoder-decoder's
source frames ``[B, prompt_len, d_model]`` (a source as long as the
prompt) or a VLM's patch embeddings ``[B, num_patches, clip_dim]``.
Weights are random, from ``--seed``.  Greedy decoding is the parity
mode; ``--temperature`` samples from a ``torch.Generator`` seeded with
``--seed``, which does not give JAX's draws.  Runs on the card unless
``--device cpu`` is asked for (the kernels' plain versions).  Serving
builds no autograd graph: ``serve`` and the families' ``prefill`` and
``decode_step`` run under ``torch.no_grad``.

A VLM's decode steps run at ``length = num_patches + prompt_len + t``,
the positions its cache holds; ``repro/launch/serve.py`` passes
``prompt_len + t``, which hides the prompt's tail from the causal mask
and gives the new token the wrong RoPE position (ROADMAP C7).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.reduced import reduced as reduce_spec
from repro_torch.device import resolve_device
from repro_torch.runtime import tracing

DEFAULT_ARCH = "llama3-8b"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def config_dtype(cfg) -> torch.dtype:
    """The model's dtype (a VLM's is its backbone's)."""
    return cfg.backbone.dtype if hasattr(cfg, "backbone") else cfg.dtype


def with_config(cfg, *, dtype: torch.dtype | None = None,
                layers: int | None = None):
    """``cfg`` with another dtype and/or depth.  ``layers`` cuts a VLM's
    backbone, and both of an encoder-decoder's stacks (``enc_layers`` and
    ``dec_layers`` each set to it); the widths stay."""
    if hasattr(cfg, "backbone"):
        return dataclasses.replace(cfg, backbone=with_config(
            cfg.backbone, dtype=dtype, layers=layers))
    kw = {} if dtype is None else {"dtype": dtype}
    if layers is not None:
        if hasattr(cfg, "enc_layers"):
            kw.update(enc_layers=layers, dec_layers=layers)
        else:
            kw["layers"] = layers
    return dataclasses.replace(cfg, **kw)


def depth(cfg) -> dict:
    """The config's stacks: ``layers`` (blocks in all), and an
    encoder-decoder's ``enc_layers`` and ``dec_layers``."""
    if hasattr(cfg, "enc_layers"):
        return {"layers": cfg.enc_layers + cfg.dec_layers,
                "enc_layers": cfg.enc_layers, "dec_layers": cfg.dec_layers}
    return {"layers": (cfg.backbone if hasattr(cfg, "backbone")
                       else cfg).layers}


def prefix_len(spec, cfg) -> int:
    """Cache positions ahead of the text: a VLM's patches, else 0."""
    return cfg.num_patches if spec.family_name == "vlm" else 0


def source_inputs(spec, cfg, rng: np.random.Generator, batch: int,
                  prompt_len: int) -> dict:
    """The prefill inputs beside the tokens, drawn from ``rng`` after the
    prompt as ``repro/launch/serve.py`` draws them, as float32 numpy: an
    encoder-decoder's ``frames`` ``[batch, prompt_len, d_model]``, a
    VLM's ``patches`` ``[batch, num_patches, clip_dim]``, else none."""
    if spec.family_name == "encdec":
        return {"frames": rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)}
    if spec.family_name == "vlm":
        return {"patches": rng.standard_normal(
            (batch, cfg.num_patches, cfg.clip_dim)).astype(np.float32)}
    return {}


def prefill_batch(cfg, tokens, sources: dict, device) -> dict:
    """The family's prefill batch on ``device``: ``tokens`` (numpy or a
    tensor of ids) and the ``sources`` in the model's dtype.  Each one
    copied from the host to the card is a pageable copy, one sync there
    (counted as ``host_sync.prefill_batch``)."""
    batch = {"tokens": torch.as_tensor(tokens).long().to(device)}
    for name, arr in sources.items():
        batch[name] = torch.as_tensor(arr).to(device=device,
                                              dtype=config_dtype(cfg))
    if tracing.enabled() and batch["tokens"].is_cuda:
        tracing.count("host_sync.prefill_batch", sum(
            not (torch.is_tensor(a) and a.is_cuda)
            for a in (tokens, *sources.values())))
    return batch


def new_caches(spec, cfg, batch: int, text_len: int, sources: dict, *,
               device):
    """Empty caches for ``text_len`` tokens after the prefix: an
    encoder-decoder's cross caches as long as its ``frames``, a VLM's
    cache ``num_patches`` longer."""
    fam = spec.family
    if spec.family_name == "encdec":
        return fam.init_caches(cfg, batch, text_len,
                               sources["frames"].shape[1], device=device)
    return fam.init_caches(cfg, batch, prefix_len(spec, cfg) + text_len,
                           device=device)


@torch.no_grad()
def serve(arch: str = DEFAULT_ARCH, *, reduced: bool = False,
          batch: int = 4, prompt_len: int = 32, gen: int = 16,
          seed: int = 0, temperature: float = 0.0, device=None,
          dtype: torch.dtype | None = None, layers: int | None = None,
          model=None) -> dict:
    """Serve one batch of seeded prompts; returns the prompt and
    generated token ids (numpy ``[batch, prompt_len]`` and ``[batch,
    gen]``), the other prefill inputs (``sources``: :func:`source_inputs`)
    and the host wall-clock timings (ending in a device synchronise).
    ``dtype`` overrides the config's, ``layers`` its depth (for a model
    too large for the card; :func:`with_config`: an encoder-decoder's two
    stacks are each cut to ``layers``); ``model`` replaces the seeded
    init (weights carried from elsewhere)."""
    if gen < 1 or prompt_len < 1 or batch < 1:
        raise ValueError("batch, prompt_len and gen must be >= 1")
    device = resolve_device(device)
    spec = get_arch(arch)
    if reduced:
        spec = reduce_spec(spec)
    cfg = with_config(spec.config, dtype=dtype, layers=layers)
    fam = spec.family
    if model is None:
        model = fam.init(cfg, device=device, seed=seed)

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, spec.vocab, (batch, prompt_len), dtype=np.int32)
    sources = source_inputs(spec, cfg, rng, batch, prompt_len)
    caches = new_caches(spec, cfg, batch, prompt_len + gen, sources,
                        device=device)
    sampler = torch.Generator(device=device).manual_seed(seed)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return logits.argmax(dim=-1, keepdim=True)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = fam.prefill(
        model, prefill_batch(cfg, prompt, sources, device), cfg, caches)
    tok = pick(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    length = prefix_len(spec, cfg) + prompt_len
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = fam.decode_step(model, {"token": tok}, cfg, caches,
                                         length)
        tok = pick(logits)
        out.append(tok)
        length += 1
    _sync(device)
    decode_s = time.perf_counter() - t0

    tokens = torch.cat(out, dim=1).cpu().numpy()
    if tokens.max() >= spec.vocab:
        raise RuntimeError("a padded-vocabulary id was generated")
    steps = gen - 1
    return {
        "arch": spec.arch_id, **depth(cfg), "device": str(device),
        "dtype": str(config_dtype(cfg)),
        "batch": batch, "prompt_len": prompt_len, "gen": gen,
        "prompt": prompt, "sources": sources, "tokens": tokens,
        "prefill_s": prefill_s, "decode_s": decode_s,
        "decode_ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
        "decode_tok_s": batch * steps / decode_s if steps else 0.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default=DEFAULT_ARCH,
                    help=f"ported architecture (default {DEFAULT_ARCH}, "
                         "as the reference's)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (the published widths stay; an "
                         "encoder-decoder's two stacks each)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
                temperature=args.temperature, device=args.device,
                layers=args.layers)
    print(f"prefill: {args.batch}x{args.prompt_len} in "
          f"{res['prefill_s']:.2f}s on {res['device']}")
    print(f"decode : {args.gen - 1} steps, {res['decode_tok_s']:.1f} tok/s "
          f"({res['decode_ms_per_step']:.1f} ms/step)")
    print("sample token ids:", res["tokens"][0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
