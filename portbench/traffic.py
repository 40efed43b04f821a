"""The one generator of requests and training batches, driven by a mix's
parameters (``traffic/<mix>.json``) and the run's seed.

Prefill mixes (``"kind": "prefill"``) send requests in a closed loop.
Request ``i`` is a batch of ``batch`` prompts of one length.  The
lengths are a fixed set (``lengths``: ``count`` values spaced evenly in
log from ``min`` to ``max``, each rounded to a multiple of
``multiple``); the requests come in blocks of ``len(set)``, each block a
seeded shuffle of the whole set.  So every seed sends the same lengths,
in another order, and a window's tail is that of the set's longest
prompts.  Token ids are uniform in the vocabulary.

Training mixes (``"kind": "train"``) feed step ``t`` a batch of
``batch`` rows of ``seq`` tokens, labels the next token of each row.

Every draw is a pure function of ``(seed, what, index)``, so a run can
regenerate any request or batch after the window, for the reference.
"""
from __future__ import annotations

import math

import numpy as np

_TAGS = {"order": 1, "prompt": 2, "train": 3, "sample": 4, "digest": 5,
         "warm": 6}


def rng(seed: int, what: str, index: int = 0) -> np.random.Generator:
    """The generator of one draw: ``(seed, what, index)``."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, _TAGS[what], int(index)]))


def length_set(lengths: dict) -> list[int]:
    """``count`` lengths evenly spaced in log from ``min`` to ``max``,
    each rounded to the nearest multiple of ``multiple`` (at least one
    multiple)."""
    lo, hi, n, m = (lengths["min"], lengths["max"], lengths["count"],
                    lengths["multiple"])
    out = []
    for i in range(n):
        x = math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * i
                     / max(n - 1, 1))
        out.append(max(m, int(round(x / m)) * m))
    return out


def request_length(mix: dict, seed: int, index: int) -> int:
    """The prompt length of request ``index``."""
    lengths = length_set(mix["lengths"])
    block, pos = divmod(index, len(lengths))
    order = rng(seed, "order", block).permutation(len(lengths))
    return lengths[int(order[pos])]


def prompt(mix: dict, seed: int, index: int, vocab: int) -> np.ndarray:
    """Request ``index``'s token ids, int32 ``[batch, length]``."""
    length = request_length(mix, seed, index)
    return rng(seed, "prompt", index).integers(
        0, vocab, (mix["batch"], length), dtype=np.int32)


def train_batch(mix: dict, seed: int, step: int,
                vocab: int) -> tuple[np.ndarray, np.ndarray]:
    """Step ``step``'s ``(tokens, labels)``, int32 ``[batch, seq]``."""
    ids = rng(seed, "train", step).integers(
        0, vocab, (mix["batch"], mix["seq"] + 1), dtype=np.int32)
    return ids[:, :-1], ids[:, 1:]
