"""Top-k mixture of experts (mixtral / arctic), with the reference's
capacity-drop routing for training.

Mirrors ``repro/models/moe.py``.  The reference routes with one-hot
dispatch/combine einsums over ``[group, tokens, experts, capacity]``
masks.  Each (token, choice) pair either takes a slot in its expert's
buffer or is dropped, and a kept pair's row goes through the expert and
comes back weighted by its gate, so those einsums are a gather and a
weighted scatter over the kept pairs.  The port computes that function
directly: route in f32, mark the kept pairs (:func:`capacity_keep`),
group them by expert (a stable argsort), run each expert's SwiGLU on
its rows with ``torch.matmul`` (a plain large product, which the JAX
package leaves to XLA outside any Pallas kernel), and add each row back
weighted by its gate.  At mixtral's prefill (12,288 tokens) the masks
would be 0.8 GB each and the dispatch einsum alone ~3e15 operations a
layer.

``drop=True`` (every path without a cache: training) is the reference's
Switch/GShard routing: tokens in groups of ``tokens_per_group`` (the
largest divisor of the token count up to it), each expert taking
``_capacity`` pairs a group, first choices before second ones
(a choice-major running count), pairs past the capacity dropped.
``drop=False`` (every path that holds a cache) sizes the buffers so
that no pair is dropped.

Two details carry the reference's rounding: the gate is rounded to x's
dtype before the combine, as the reference's ``combine`` mask is, and
the combine sums in f32 before the cast to x's dtype.  ``torch.topk``
does not promise JAX's tie order (the lower index first); ties between
the k-th and the next probability are measure-zero for real inputs.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import fan_in_normal, param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """``capacity_factor`` and ``tokens_per_group`` size the expert
    buffers of the capacity-drop routing (``drop=True``); inference
    routing drops no pair, so they do not change its result."""

    num_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    tokens_per_group: int = 1024


class MoE(nn.Module):
    """Router ``[d, E]`` in f32 (whatever the model's dtype, as in the
    reference), expert weights ``wi``/``wg [E, d, f]`` and ``wo [E, f,
    d]``."""

    def __init__(self, d: int, d_ff: int, cfg: MoEConfig, dtype, *, device,
                 generator):
        super().__init__()
        e = cfg.num_experts
        kw = dict(device=device, generator=generator)
        self.router = param(fan_in_normal((d, e), d, torch.float32, **kw),
                            ("embed", "experts"))
        self.wi = param(fan_in_normal((e, d, d_ff), d, dtype, **kw),
                        ("experts", "embed", "mlp"))
        self.wg = param(fan_in_normal((e, d, d_ff), d, dtype, **kw),
                        ("experts", "embed", "mlp"))
        self.wo = param(fan_in_normal((e, d_ff, d), d_ff, dtype, **kw),
                        ("experts", "mlp", "embed"))


def moe_init(d: int, d_ff: int, cfg: MoEConfig, dtype=torch.float32, *,
             device, generator) -> MoE:
    return MoE(d, d_ff, cfg, dtype, device=device, generator=generator)


def route(params: MoE, xt: torch.Tensor, cfg: MoEConfig):
    """Router probabilities ``[T, E]`` (f32 softmax of ``x · router``),
    and each token's top-k experts ``[T, k]`` with their renormalised
    gates."""
    probs = torch.softmax(xt.float() @ params.router, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def _capacity(group_tokens: int, cfg: MoEConfig) -> int:
    c = int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4, floor 4


def group_size(tokens: int, cfg: MoEConfig) -> int:
    """Tokens a group: the largest divisor of ``tokens`` up to
    ``tokens_per_group``."""
    g = min(cfg.tokens_per_group, tokens)
    while tokens % g:
        g -= 1
    return g


def capacity_keep(idx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """``[T, k]`` boolean: the (token, choice) pairs of the top-k experts
    ``idx`` ``[T, k]`` that take a slot.  Per group, a pair's slot is the
    number of pairs before it, choice-major (every token's first choice,
    then every token's second), that chose the same expert; it is kept
    while the slot is below the capacity."""
    t, k = idx.shape
    g = group_size(t, cfg)
    major = idx.reshape(t // g, g, k).transpose(1, 2).flatten(1, 2)
    onehot = F.one_hot(major, cfg.num_experts)          # [G, k * g, E]
    slot = (onehot.cumsum(dim=1) - onehot).gather(-1, major[..., None])
    slot = slot.reshape(t // g, k, g).transpose(1, 2).reshape(t, k)
    return slot < _capacity(g, cfg)


def uniform_counts(tokens: int, cfg: MoEConfig, drop: bool) -> list[int]:
    """Pairs each expert takes at the uniform load, ``tokens * top_k /
    E`` (the remainder to the lowest experts), at most its capacity in
    every group when ``drop``: the counts of an abstract (meta-device)
    step, whose router has no values."""
    k, e = cfg.top_k, cfg.num_experts
    total = tokens * k
    counts = [total // e + (ex < total % e) for ex in range(e)]
    if drop:
        g = group_size(tokens, cfg)
        cap = _capacity(g, cfg) * (tokens // g)
        counts = [min(n, cap) for n in counts]
    return counts


def moe_apply(params: MoE, x: torch.Tensor, cfg: MoEConfig, *,
              drop: bool = True):
    """x ``[B, S, D]`` -> (y in x's dtype, Switch aux loss).  ``drop``
    routes by capacity (:func:`capacity_keep`), else every pair.  On the
    meta device every expert takes :func:`uniform_counts`' pairs."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate, idx = route(params, xt, cfg)
    k, e = cfg.top_k, cfg.num_experts
    pairs = torch.arange(b * s * k, device=x.device)    # (token, choice)
    meta = x.device.type == "meta"
    if drop:
        keep = capacity_keep(idx, cfg).flatten()
        pairs = pairs[:sum(uniform_counts(b * s, cfg, drop))] if meta \
            else pairs[keep]
    experts = idx.flatten()[pairs]
    order = torch.argsort(experts, stable=True)         # grouped by expert
    pairs = pairs[order]
    token = pairs // k
    weight = gate.to(x.dtype).float().flatten()[pairs]
    if meta:    # no values to count: the uniform load
        counts = uniform_counts(b * s, cfg, drop)
    else:
        counts = torch.bincount(experts, minlength=e).tolist()  # repro-lint: disable=TS102 -- ROADMAP "MoE decode reads the expert counts on the host once per layer"
    y = torch.zeros(b * s, d, dtype=torch.float32, device=x.device)
    start = 0
    for ex, n in enumerate(counts):
        if n == 0:
            continue
        rows = token[start:start + n]
        xe = xt[rows]
        h = F.silu(xe @ params.wg[ex]) * (xe @ params.wi[ex])
        y.index_add_(0, rows, (h @ params.wo[ex]).float()
                     * weight[start:start + n, None])
        start += n
    # Switch aux loss: E * sum_e fraction_routed_e * mean_router_prob_e
    frac = F.one_hot(idx[:, 0], e).float().mean(dim=0)   # top-1 routing
    aux = cfg.aux_loss_weight * e * torch.sum(frac * probs.mean(dim=0))
    return y.to(x.dtype).reshape(b, s, d), aux
