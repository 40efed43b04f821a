"""The least work the mathematics needs, from a cell's shapes and its
configuration alone: never from the program, so that a faster kernel can
never read above its roofline.  ``counts/<family>.py`` lists a family's
matrix parameters and its kernel calls (``attention_calls``,
``scan_calls``, ``expert_calls``); this module turns them into
operations and bytes.

* Attention (B4), forward: ``4 D`` operations a visible (query, key)
  pair and head (``q k`` and ``p v``); backward: ``8 D`` (dV, dP, dQ,
  dK), no recomputation of P.  The visible pairs follow causality and
  the window.
* SSD scan (B5), forward: ``4 N P`` a token and head (the state update
  ``b x^T`` and the readout ``c^T h``); backward: ``8 N P`` (dX, dB, dC
  and the state's gradient).
* The MoE layer's grouped expert GEMMs, forward: ``6 d f`` a (token,
  expert) pair (gate, up and down).
* Bytes: every input read once and every output written once, at the
  configuration's element size (2 for bfloat16) whatever the program
  holds them in.
* A model step: 2 operations a matrix parameter and token (each token
  through the parameters it touches: its top-k experts), the logits
  head only where logits are needed (every position in training, the
  last one in prefill), plus the attention and scan counts; training
  is the forward and the backward (3x the matrix work, ``4 D + 8 D``
  and ``4 N P + 8 N P``), with nothing recomputed.
"""
from __future__ import annotations

import importlib

ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def family(cfg: dict):
    return importlib.import_module(f"portbench.counts.{cfg['family']}")


def visible_pairs(s: int, window: int | None = None) -> int:
    """Causal (query, key) pairs of a sequence of ``s`` from position 0;
    with a window, a query sees at most ``window`` keys (itself too)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def attention_flops(call: dict, backward: bool = False) -> float:
    """``call``: ``b``, ``h``, ``s``, ``d``, ``window``."""
    per = (8 if backward else 4) * call["d"]
    return float(per * visible_pairs(call["s"], call["window"])
                 * call["h"] * call["b"])


def attention_bytes(call: dict, elem: int, backward: bool = False) -> float:
    """Forward: q, k, v read, out written; backward: q, k, v, out, dout
    read, dq, dk, dv written."""
    q = call["b"] * call["h"] * call["s"] * call["d"]
    kv = call["b"] * call["hkv"] * call["s"] * call["d"]
    return float(elem * ((4 * q + 4 * kv) if backward else (2 * q + 2 * kv)))


def scan_flops(call: dict, backward: bool = False) -> float:
    """``call``: ``b``, ``s``, ``h``, ``n``, ``p``."""
    return float((8 if backward else 4) * call["n"] * call["p"] * call["h"]
                 * call["b"] * call["s"])


def scan_bytes(call: dict, elem: int, backward: bool = False) -> float:
    """Forward: x, la, b, c, the initial state read, y and the final
    state written; backward: x, la, b, c, dy read, dx, dla, db, dc
    written."""
    b, s, h, n, p = (call[k] for k in ("b", "s", "h", "n", "p"))
    tok = b * s
    if backward:
        return float(elem * (4 * tok * h * p + 2 * tok * h + 4 * tok * n))
    return float(elem * (2 * tok * h * p + tok * h + 2 * tok * n
                         + 2 * b * h * n * p))


def expert_flops(call: dict, backward: bool = False) -> float:
    """``call``: ``tokens``, ``pairs`` (tokens x top-k), ``d``, ``f``,
    ``experts``.  No cell trains the grouped GEMMs: forward only."""
    if backward:
        raise ValueError("the expert GEMMs are counted forward only")
    return float(6 * call["d"] * call["f"] * call["pairs"])


def expert_bytes(call: dict, elem: int, backward: bool = False) -> float:
    """The three matrices of every expert that a pair can reach (at most
    ``pairs`` of them), x's rows read and each pair's output written."""
    if backward:
        raise ValueError("the expert GEMMs are counted forward only")
    touched = min(call["experts"], call["pairs"])
    return float(elem * call["d"] * (3 * touched * call["f"]
                                     + call["tokens"] + call["pairs"]))


def step_flops(cfg: dict, batch: int, seq: int, train: bool) -> float:
    """A whole step's operations: a training step over ``batch`` rows of
    ``seq`` tokens, or a prefill of them (logits at the last position)."""
    fam, sizes = family(cfg), cfg["sizes"]
    body, head = fam.matrix_params(sizes)
    tokens = batch * seq
    logit_rows = tokens if train else batch
    mm = 2.0 * (body * tokens + head * logit_rows)
    att = sum(attention_flops(c) for c in fam.attention_calls(sizes, batch,
                                                              seq))
    scan = sum(scan_flops(c) for c in fam.scan_calls(sizes, batch, seq))
    return 3 * (mm + att + scan) if train else mm + att + scan
