"""The numbers that decide ``correct``, each against its limit, and the
other readings a run prints beside them.

Prefill, over the sampled requests' rows:

* ``token_gap``: how far a served token's logit lies below the
  reference's best, ``(max r - r[token]) / std(r)``, the widest over the
  rows;
* ``token_excess``: that gap, ``max r - r[token]``, over ``2 max |l -
  r|``, the widest over the rows.  A token picked greedily from the
  served logits ``l`` reads at most 1 whatever their rounding: ``l[token]
  >= l[j]`` for the reference's best ``j`` gives ``r[j] - r[token] <=
  (l[token] - r[token]) - (l[j] - r[j])``;
* ``logit_err_max``, ``logit_err`` and ``logit_err_min``: ``|l - r| /
  |r|`` of a row's logits at its last position, the program's ``l``
  against the reference's ``r``: the largest over the rows, their median
  and the least;
* ``cache_err_max`` and ``cache_err``: ``|c - r| / |r|`` of the cache
  digest: the largest over the requests and parts (keys, values, SSD
  states, conv tails), and the median over the digest's units (a row's
  keys and values at one picked position, across the layers; a row's
  states; a row's conv tails);
* ``cache_err_row``: the median of each row's own units, the largest
  over the rows: a fault in one row, or in one slot of a batch, moves
  every unit of that row, where a routing flip moves a few units of
  many rows;
* ``cache_err_slot``: for each slot of the batch, the median over the
  requests of that slot's row medians; the largest over the slots;
* ``cache_err_far``: with a sliding window, the median over the units
  that the window shapes: a row's keys and values at one picked
  position at or past the window, in one layer after the first (the
  first layer's keys and values come before any attention).  Absent
  where no picked position reaches the window.

Training, over the checked first steps:

* ``loss_gap``: ``|loss - ref| / |ref|``, the largest over the steps;
* ``grad_gap``: the first gradient as the optimizer got it, by leaf:
  ``|norm - ref norm| / max(ref norm, median leaf's ref norm)``, the
  worst leaf;
* ``change_gap``: the same of each leaf's change over the checked
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by rounding alone);
* ``grad_norm_gap``: the first step's gradient norm before clipping,
  relative.

A shape that differs, or a value that is not finite, reads ``1e30``.
"""
from __future__ import annotations

import math
import statistics

import torch

INF = 1e30
PREFILL = ("token_excess", "token_gap", "logit_err_max", "logit_err",
           "logit_err_min", "cache_err_max", "cache_err", "cache_err_row",
           "cache_err_slot", "cache_err_far")


def _ratio(num: float, den: float) -> float:
    return num / den if den else (0.0 if num == 0 else INF)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        return INF
    a, b = a.double(), b.double()
    num, den = float((a - b).norm()), float(b.norm())
    return _ratio(num, den) if math.isfinite(num) else INF


def _errs(have: torch.Tensor, want: torch.Tensor, keep) -> list:
    """``|c - r| / |r|`` over every dim not in ``keep``: a list over the
    first kept dim of lists over the other kept dims, flattened."""
    have, want = have.double(), want.double()
    red = [d for d in range(want.dim()) if d not in keep]
    num = (have - want).pow(2).sum(dim=red).sqrt()
    den = want.pow(2).sum(dim=red).sqrt()
    num = torch.where(torch.isfinite(num), num, torch.full_like(num, INF))
    return [[_ratio(float(n), float(d)) for n, d in zip(nr, dr)]
            for nr, dr in zip(num.reshape(num.shape[0], -1),
                              den.reshape(den.shape[0], -1))]


def _digest_units(have: torch.Tensor, want: torch.Tensor, part: str,
                  positions: list, window) -> tuple[list, list]:
    """A digest part's units by row (keys and values ``[layers, B, npos,
    ...]`` by (row, position) across the layers, the other parts
    ``[layers, B, ...]`` by row), and its units past the window (keys
    and values by (layer after the first, row, position))."""
    if part not in ("k", "v"):
        return _errs(have, want, (1,)), []
    rows = _errs(have, want, (1, 2))
    far = []
    if window is not None:
        cols = [j for j, p in enumerate(positions) if p >= window]
        if cols:
            idx = torch.as_tensor(cols, device=want.device)
            by_layer = _errs(have[1:].index_select(2, idx),
                             want[1:].index_select(2, idx), (0, 1, 2))
            far = [u for layer in by_layer for u in layer]
    return rows, far


def prefill_numbers(prog: list, ref: list, positions: list | None = None,
                    window=None) -> dict:
    """``prog``: per request ``logits`` ``[B, V]``, ``token`` ``[B, 1]``
    and ``digest``; ``ref``: per request ``logits`` and ``digest``;
    ``positions``: per request its picked positions (for the units past
    ``window``, the configuration's sliding window)."""
    rows, gaps, excess, parts, row_units, far = [], [], [], [], [], []
    positions = positions or [[] for _ in prog]
    for p, r, pos in zip(prog, ref, positions):
        if p["logits"].shape != r["logits"].shape:
            return dict.fromkeys(PREFILL, INF)
        rl = r["logits"].double()
        pl = p["logits"].to(rl.device).double()
        tok = p["token"].reshape(-1, 1).long().to(rl.device)
        rows += [rel(pl[i], rl[i]) for i in range(rl.shape[0])]
        below = rl.max(dim=-1).values - rl.gather(-1, tok)[:, 0]
        gaps += (below / rl.std(-1)).tolist()
        bound = 2 * (pl - rl).abs().amax(dim=-1)
        excess += [_ratio(float(b), float(d)) for b, d in zip(below, bound)]
        mine = [[] for _ in range(rl.shape[0])]
        for part, want in r["digest"].items():
            have = p["digest"].get(part)
            if have is None or have.shape != want.shape:
                return dict.fromkeys(PREFILL, INF)
            have = have.to(want.device)
            parts.append(rel(have, want))
            by_row, past = _digest_units(have, want, part, pos, window)
            for b, units in enumerate(by_row):
                mine[b] += units
            far += past
        row_units += mine
        batch = len(mine)
    units = [u for row in row_units for u in row]
    out = {"token_excess": max(excess), "token_gap": max(gaps),
           "logit_err_max": max(rows), "logit_err": statistics.median(rows),
           "logit_err_min": min(rows), "cache_err_max": max(parts),
           "cache_err": statistics.median(units),
           "cache_err_row": max(statistics.median(u) for u in row_units),
           "cache_err_slot": max(
               statistics.median(statistics.median(u)
                                 for u in row_units[b::batch])
               for b in range(batch))}
    if far:
        out["cache_err_far"] = statistics.median(far)
    return {k: (v if math.isfinite(v) else INF) for k, v in out.items()}


def _leaf_gap(have: dict, want: dict, skip=()) -> float:
    if set(have) != set(want):
        return INF
    floor = statistics.median(want.values())
    return max((abs(have[k] - want[k]) / max(want[k], floor)
                for k in want if k not in skip), default=0.0)


def train_numbers(prog: dict, ref: dict) -> dict:
    """Both: ``losses``, ``grad_norm`` (before clipping), ``grad_leaves``
    and ``change_leaves`` (``{leaf: norm}``)."""
    if len(prog["losses"]) != len(ref["losses"]):
        return dict.fromkeys(("loss_gap", "grad_gap", "change_gap",
                              "grad_norm_gap"), INF)
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                    ref["losses"]))
    g = ref["grad_leaves"]
    floor = statistics.median(g.values())
    still = [k for k, v in g.items() if v < 1e-3 * floor]
    out = {"loss_gap": loss,
           "grad_gap": _leaf_gap(prog["grad_leaves"], g),
           "change_gap": _leaf_gap(prog["change_leaves"],
                                   ref["change_leaves"], still),
           "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"])
           / ref["grad_norm"],
           "leaves_left_out": float(len(still))}
    return {k: (v if math.isfinite(v) else INF) for k, v in out.items()}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Every number the cell's limits name, beside its limit; correct
    when each is at most its limit (a number the run could not read
    counts as ``1e30``)."""
    checks = {n: {"value": numbers.get(n, INF), "limit": lim}
              for n, lim in limits.items()}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
