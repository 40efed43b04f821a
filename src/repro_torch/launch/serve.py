"""Batched serving: prefill + greedy decode loop with cache reuse.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mixtral-8x7b --reduced --device cpu

Mirrors ``repro/launch/serve.py`` on one device: one prefill over the
batch of seeded prompts, then token-by-token decode against the caches
(the transformer's per-layer KV caches, the hybrid's shared attention
sites' caches and the O(1) Mamba2 states).
Weights are random, from ``--seed``.  Greedy decoding is the parity
mode; ``--temperature`` samples from a ``torch.Generator`` seeded with
``--seed``, which does not give JAX's draws.  Runs on the card unless
``--device cpu`` is asked for (the kernels' plain versions).
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

DEFAULT_ARCH = "llama3-8b"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str = DEFAULT_ARCH, *, reduced: bool = False,
          batch: int = 4, prompt_len: int = 32, gen: int = 16,
          seed: int = 0, temperature: float = 0.0, device=None,
          dtype: torch.dtype | None = None, layers: int | None = None,
          model=None) -> dict:
    """Serve one batch of seeded prompts; returns the prompt and
    generated token ids (numpy ``[batch, prompt_len]`` and ``[batch,
    gen]``) and the host wall-clock timings (ending in a device
    synchronise).  ``dtype`` overrides the config's, ``layers`` its depth
    (for a model too large for the card); ``model`` replaces the seeded
    init (weights carried from elsewhere)."""
    if gen < 1 or prompt_len < 1 or batch < 1:
        raise ValueError("batch, prompt_len and gen must be >= 1")
    device = resolve_device(device)
    spec = get_arch(arch)
    if reduced:
        spec = reduce_spec(spec)
    cfg = spec.config
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, layers=layers)
    fam = spec.family
    if model is None:
        model = fam.init(cfg, device=device, seed=seed)

    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, spec.vocab, (batch, prompt_len), dtype=np.int32)
    caches = fam.init_caches(cfg, batch, prompt_len + gen, device=device)
    sampler = torch.Generator(device=device).manual_seed(seed)

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)
        return logits.argmax(dim=-1, keepdim=True)

    _sync(device)
    t0 = time.perf_counter()
    logits, caches = fam.prefill(
        model, {"tokens": torch.from_numpy(prompt).long().to(device)}, cfg,
        caches)
    tok = pick(logits)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    out = [tok]
    length = prompt_len
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
        "arch": spec.arch_id, "layers": cfg.layers, "device": str(device),
        "dtype": str(cfg.dtype),
        "batch": batch, "prompt_len": prompt_len, "gen": gen,
        "prompt": prompt, "tokens": tokens,
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
                    help="cut the depth (the published widths stay)")
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
