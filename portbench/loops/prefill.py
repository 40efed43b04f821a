"""Closed-loop prefill: one client sends a request, waits for its first
token, sends the next.

A request is ``serve.py``'s prefill sequence on the program: empty
caches for the prompt and one generated token (``new_caches``), the
family's ``prefill`` on ``prefill_batch``, and the greedy pick of the
first token, ending in a synchronise.  Its time to first token is the
host clock around that.  Set-up draws the weights and serves each
length of the mix's set once.

The requests that the check compares are drawn from the seed before
the window, among the mix's first ``check_span`` requests (fewer than a
window finishes; the window runs on until they are served), with the
longest among them; only they keep their logits and read their caches
in the window.  After it, the reference serves them again from the same
tokens, and their last-position logits and cache digests are compared
with what the window produced (``compare.prefill_numbers``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench import compare, core, traffic
from portbench.reference.common import Precision, strict_f32
from portbench.trace import traced


def picks(mix: dict, seed: int, index: int, length: int,
          heads: int) -> dict:
    """Where request ``index``'s cache is read: its first and last
    positions and ``digest_positions - 2`` drawn ones, and
    ``digest_heads`` drawn state heads (of ``heads``)."""
    r = traffic.rng(seed, "digest", index)
    extra = r.choice(length, min(length, mix["digest_positions"] - 2),
                     replace=False)
    pos = sorted({0, length - 1, *map(int, extra)})
    hs = (sorted(map(int, r.choice(heads, min(heads, mix["digest_heads"]),
                                   replace=False))) if heads else [])
    return {"positions": pos, "heads": hs}


def sample(mix: dict, seed: int) -> list[int]:
    """The indices of the ``check_requests`` requests that the check
    compares, among the first ``check_span``: the first of the longest,
    and the rest drawn from the seed."""
    span = range(mix["check_span"])
    lengths = [traffic.request_length(mix, seed, i) for i in span]
    longest = max(span, key=lambda i: (lengths[i], -i))
    rest = [i for i in span if i != longest]
    k = min(len(rest), mix["check_requests"] - 1)
    drawn = traffic.rng(seed, "sample").choice(len(rest), k, replace=False)
    return [longest] + [rest[int(i)] for i in sorted(drawn)]


def p95(values: list) -> float:
    """The 95th percentile, nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        *, spec=None, fault: str | None = None) -> dict:
    core.import_program()
    from repro_torch.launch import serve

    spec, pcfg = core.program_config(cell.config, spec)
    fam, sizes, mix = spec.family, cell.config["sizes"], cell.mix
    ref, prog = cell.module("reference"), cell.module("program")
    vocab, gen, rows = sizes["vocab"], mix["gen"], mix["batch"]
    model = core.build_model(fam, pcfg, ref.schema(sizes), seed, device)

    # the configuration the timed path runs: the window left out with
    # the fault "window"
    run_cfg = (dataclasses.replace(pcfg, window=None) if fault == "window"
               else pcfg)

    def serve_one(tokens: np.ndarray):
        if fault == "half_batch":
            tokens = tokens[: len(tokens) // 2]
        if fault == "slot":         # the last slot serves another prompt
            tokens = tokens.copy()
            tokens[-1] = np.roll(tokens[-1], 1)
        caches = serve.new_caches(spec, run_cfg, tokens.shape[0],
                                  tokens.shape[1] + gen, {}, device=device)
        logits, caches = fam.prefill(
            model, serve.prefill_batch(run_cfg, tokens, {}, device), run_cfg,
            caches)
        tok = logits.argmax(dim=-1, keepdim=True)
        if fault == "token":        # the pick's sign flipped
            tok = logits.argmin(dim=-1, keepdim=True)
        return logits, tok, caches

    # seeded prompts of every length, so that the experts' products meet
    # the shapes a window gives them (one token id would route every
    # token alike)
    warm = traffic.rng(seed, "warm")
    for length in traffic.length_set(mix["lengths"]):
        serve_one(warm.integers(0, vocab, (rows, length), dtype=np.int32))
    core.sync(device)
    setup_s = core.process_age()

    heads = ref.state_heads(sizes)
    asked = {i: picks(mix, seed, i, traffic.request_length(mix, seed, i),
                      heads) for i in sample(mix, seed)}
    done, kept = [], {}
    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with traced(trace) as tr:
        t0 = time.perf_counter()
        while True:
            i = len(done)
            tokens = traffic.prompt(mix, seed, i, vocab)
            ts = time.perf_counter()
            with record_function("portbench.request"):
                logits, tok, caches = serve_one(tokens)
                core.sync(device)
            te = time.perf_counter()
            done.append({"length": tokens.shape[1], "rows": rows,
                         "latency": te - ts})
            if i in asked:
                # a copy: the last position's logits are a view that
                # would hold the whole prompt's logits alive
                kept[i] = {"logits": logits.clone(), "token": tok,
                           "digest": prog.digest(caches, asked[i])}
            del caches, logits
            if te - t0 >= seconds and len(kept) == len(asked):
                break
        t_read = time.perf_counter()
    core.sync(device)
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    out = {
        "end_to_end": {
            "prefill_tokens_per_s": sum(d["rows"] * d["length"]
                                        for d in done) / window_s,
            "ttft_p95_s": p95([d["latency"] for d in done]),
            "setup_s": setup_s,
        },
        "attempted": len(done), "failed": 0,
        "trace": tr[0],
        "work": [(d["rows"], d["length"]) for d in done],
        "window_peak_bytes": peak,
        "memory_peak_bytes": max(setup_peak, peak),
    }
    prog_out = [{"logits": k["logits"].float()[:, :vocab],
                 "token": k["token"], "digest": k["digest"]}
                for _, k in sorted(kept.items())]
    asked = sorted(asked.items())
    del model, done, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    strict_f32()
    t1 = time.perf_counter()
    ref_out = ref.prefill(
        sizes, seed, [traffic.prompt(mix, seed, i, vocab) for i, _ in asked],
        [pk for _, pk in asked], device, Precision("f32"))
    out["numbers"] = compare.prefill_numbers(
        prog_out, ref_out, [pk["positions"] for _, pk in asked],
        sizes.get("window"))
    out["seconds"] = {"setup": setup_s, "window": window_s,
                      "trace_read": t1 - t_read, "reference":
                      time.perf_counter() - t1}
    return out
