"""Top-k mixture of experts (mixtral / arctic): the inference routing.

Mirrors ``repro/models/moe.py``.  The reference routes with one-hot
dispatch/combine einsums over ``[group, tokens, experts, capacity]``
masks; with ``drop=False`` (every path that holds a cache) the capacity
fits every token, so each token reaches each of its top-k experts and
those einsums are a gather and a weighted scatter.  The port computes
that function directly: route in f32, group the (token, choice) pairs
by expert (a stable argsort), run each expert's SwiGLU on its rows with
``torch.matmul`` (a plain large product, which the JAX package leaves
to XLA outside any Pallas kernel), and add each row back weighted by its
gate.  At mixtral's prefill (12,288 tokens) the masks would be 0.8 GB
each and the dispatch einsum alone ~3e15 operations a layer.

Two details carry the reference's rounding: the gate is rounded to x's
dtype before the combine, as the reference's ``combine`` mask is, and
the combine sums in f32 before the cast to x's dtype.  ``torch.topk``
does not promise JAX's tie order (the lower index first); ties between
the k-th and the next probability are measure-zero for real inputs.

``drop=True`` (capacity-drop routing, the reference's training path)
is not ported.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers import fan_in_normal, param


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """``capacity_factor`` and ``tokens_per_group`` size the reference's
    dispatch buffers; inference routing drops no token, so they do not
    change the port's result."""

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
        self.router = param(fan_in_normal((d, e), d, torch.float32, **kw))
        self.wi = param(fan_in_normal((e, d, d_ff), d, dtype, **kw))
        self.wg = param(fan_in_normal((e, d, d_ff), d, dtype, **kw))
        self.wo = param(fan_in_normal((e, d_ff, d), d_ff, dtype, **kw))


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


def moe_apply(params: MoE, x: torch.Tensor, cfg: MoEConfig, *,
              drop: bool = True):
    """x ``[B, S, D]`` -> (y in x's dtype, Switch aux loss).  Only the
    inference routing (``drop=False``) is ported."""
    if drop:
        raise NotImplementedError(
            "capacity-drop MoE routing (training) waits for the training "
            "slice (ROADMAP A-11b)")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate, idx = route(params, xt, cfg)
    k, e = cfg.top_k, cfg.num_experts
    flat = idx.flatten()                          # (token, choice) pairs
    order = torch.argsort(flat, stable=True)      # grouped by expert
    token = order // k
    weight = gate.to(x.dtype).float().flatten()[order]
    counts = torch.bincount(flat, minlength=e).tolist()
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
