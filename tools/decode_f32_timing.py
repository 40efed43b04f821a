"""Time one checkout's f32 decode steps (kernel B4), its per-reference SDCM
form (kernel B1) and its f32 decode-consistency checks on the card, so
that two checkouts can be compared in one call:

    python3 tools/decode_f32_timing.py DIR [--hit-probs] [--consistency]

DIR is the root of a checkout (this one: ``.``).  Run each checkout in a
process of its own, in turns (parent, change, change, parent).  Prints one
JSON line per reading, each with the card's name and power limit:

* ``decode_f32``: B4 at f32 decode steps (zamba2-1.2b's cache of 2,048,
  B 4, 32 heads, D 64; llama3-8b's GQA 32 over 8 at D 128): the form the
  checkout picks, 20 calls one by one (``ms``) and replayed from a CUDA
  graph (``graph_ms``), SDPA in f32 the same ways, and the bytes bound;
* ``hit_probs`` (``--hit-probs``): the checkout's ``chip_smoke.py``
  ``phase_hit_probs`` (2^22 seeded distances at every geometry);
* ``consistency`` (``--consistency``): the seconds of the checkout's
  ``chip_smoke.py`` ``decode_consistency`` for each architecture with
  attention, at the depths and lengths its serve phases use (the kernel
  path and the plain path, each prefill plus decode steps), and its B4
  launches by form.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

DECODE_CASES = (  # tag, B, H, Hkv, cache, kv_len, D
    ("zamba2_decode_f32", 4, 32, 32, 2080, 2048, 64),
    ("llama3_decode_f32", 4, 32, 8, 2080, 2048, 128),
)
CONSISTENCY = (  # arch, layers, total, split: the serve phases' checks
    ("zamba2-1.2b", 14, 300, 290),
    ("llama3-8b", 8, 300, 290),
    ("mixtral-8x7b", 2, 4200, 4190),
    ("seamless-m4t-medium", 4, 300, 290),
    ("phi-3-vision-4.2b", 8, 300, 290),
)


def load_chip_smoke(root: Path):
    """The checkout's ``chip_smoke.py`` as a module (it puts the
    checkout's ``src`` first on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_rows(cs, smi: str, root: Path) -> None:
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        kernel_form,
    )

    for i, (tag, b, h, hkv, sk, kvl, d) in enumerate(DECODE_CASES):
        rand = cs.cuda_rand(40 + i)
        q = rand(b, 1, h, d).transpose(1, 2)
        k = rand(b, sk, hkv, d).transpose(1, 2)
        v = rand(b, sk, hkv, d).transpose(1, 2)
        kw = dict(causal=True, q_offset=kvl - 1, kv_len=kvl)
        nbytes, ops = cs.flash_work(q, k, True, kvl - 1, kvl)
        bound, by = cs.bound_ms(nbytes, ops, cs.PEAK_FP32_S)
        print(json.dumps(dict(
            reading="decode_f32", checkout=str(root), card=smi, case=tag,
            shape=[b, h, hkv, 1, sk, d], kv_len=kvl,
            form=kernel_form(q, k, v),
            ms=cs.cuda_ms(lambda: flash_attention(q, k, v, **kw)),
            graph_ms=cs.graph_ms(lambda: flash_attention(q, k, v, **kw)),
            library_ms=cs.cuda_ms(lambda: cs.sdpa_library(
                q, k, v, True, kvl - 1, kvl)),
            library_graph_ms=cs.graph_ms(lambda: cs.sdpa_library(
                q, k, v, True, kvl - 1, kvl)),
            bound_ms=bound, bound_by=by)), flush=True)


def consistency_rows(cs, smi: str, root: Path) -> None:
    from repro_torch.configs import get_arch

    for arch, layers, total, split in CONSISTENCY:
        spec = get_arch(arch)
        rec, secs = cs.timed(lambda: cs.decode_consistency(
            spec, layers, total, split))
        torch.cuda.empty_cache()
        print(json.dumps(dict(
            reading="consistency", checkout=str(root), card=smi, arch=arch,
            layers=layers, total=total, split=split, seconds=secs,
            kernel_s=rec.get("kernel_s"), plain_s=rec.get("plain_s"),
            rel=rec["kernels"]["rel"], launches=rec["launches"])),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", type=Path)
    ap.add_argument("--hit-probs", action="store_true")
    ap.add_argument("--consistency", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_f32_timing: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    cs = load_chip_smoke(root)
    smi = cs.nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions
    t0 = time.perf_counter()
    decode_rows(cs, smi, root)
    if args.hit_probs:
        for rec in cs.phase_hit_probs():
            print(json.dumps(dict(reading="hit_probs", checkout=str(root),
                                  card=smi, **rec)), flush=True)
    if args.consistency:
        consistency_rows(cs, smi, root)
    print(json.dumps(dict(reading="done", checkout=str(root),
                          seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
