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

On the card, serving in bf16 takes another path with the same routing
(:func:`grouped_path`): the expert pipeline of
:mod:`repro_torch.kernels.moe`, in which no count reaches the host
(dispatch, one grouped GEMM for the gate and up products with the
SwiGLU in its epilogue, one for the down product, a combine pass).  The
loop needs autograd and capacity drops, the grouped kernels neither, so
the two share :func:`route` and nothing else.

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

from repro_torch.dist.sharding import (
    current_rules, from_local, is_dtensor, local_shard, place_for, placements,
    pspec_for, shard, shard_index,
)
from repro_torch.kernels import moe as kmoe
from repro_torch.models.layers import fan_in_normal, param
from repro_torch.runtime import tracing


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


def capacity_keep(idx: torch.Tensor, cfg: MoEConfig,
                  group: int | None = None) -> torch.Tensor:
    """``[T, k]`` boolean: the (token, choice) pairs of the top-k experts
    ``idx`` ``[T, k]`` that take a slot.  Per group (``group`` tokens,
    by default :func:`group_size`'s), a pair's slot is the number of
    pairs before it, choice-major (every token's first choice, then
    every token's second), that chose the same expert; it is kept while
    the slot is below the capacity."""
    t, k = idx.shape
    g = group or group_size(t, cfg)
    major = idx.reshape(t // g, g, k).transpose(1, 2).flatten(1, 2)
    onehot = F.one_hot(major, cfg.num_experts)          # [G, k * g, E]
    slot = (onehot.cumsum(dim=1) - onehot).gather(-1, major[..., None])
    slot = slot.reshape(t // g, k, g).transpose(1, 2).reshape(t, k)
    return slot < _capacity(g, cfg)


def uniform_counts(tokens: int, cfg: MoEConfig, drop: bool,
                   group: int | None = None) -> list[int]:
    """Pairs each expert takes at the uniform load, ``tokens * top_k /
    E`` (the remainder to the lowest experts), at most its capacity in
    every group of ``group`` tokens (:func:`group_size`'s by default)
    when ``drop``: the counts of an abstract (meta-device) step, whose
    router has no values.  A partition's tokens take the counts of its
    own experts from this list."""
    k, e = cfg.top_k, cfg.num_experts
    total = tokens * k
    counts = [total // e + (ex < total % e) for ex in range(e)]
    if drop:
        g = group or group_size(tokens, cfg)
        cap = _capacity(g, cfg) * (tokens // g)
        counts = [min(n, cap) for n in counts]
    return counts


@tracing.spanned("layer.moe")
def moe_apply(params: MoE, x: torch.Tensor, cfg: MoEConfig, *,
              drop: bool = True):
    """x ``[B, S, D]`` -> (y in x's dtype, Switch aux loss).  ``drop``
    routes by capacity (:func:`capacity_keep`), else every pair.  On the
    meta device every expert takes :func:`uniform_counts`' pairs.  A
    DTensor x is routed on each partition (:func:`_partitioned`).  Where
    :func:`grouped_path` holds, the experts run on the device-side
    pipeline (:func:`_grouped`), else in the loop (:func:`_experts`)."""
    if is_dtensor(x):
        return _partitioned(params, x, cfg, drop)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    probs, gate, idx = route(params, xt, cfg)
    e = cfg.num_experts
    weights = (params.wi, params.wg, params.wo)
    if grouped_path(params, x, cfg, drop):
        y = _grouped(xt, gate, idx, weights)
    else:
        y = _experts(xt, gate, idx, cfg, drop, group_size(b * s, cfg), 0,
                     weights)
    # Switch aux loss: E * sum_e fraction_routed_e * mean_router_prob_e
    frac = F.one_hot(idx[:, 0], e).float().mean(dim=0)   # top-1 routing
    aux = cfg.aux_loss_weight * e * torch.sum(frac * probs.mean(dim=0))
    return y.to(x.dtype).reshape(b, s, d), aux


def _experts(xt, gate, idx, cfg: MoEConfig, drop: bool, group: int,
             first: int, weights) -> torch.Tensor:
    """``[T, d]`` f32: every kept (token, choice) pair of tokens ``xt``
    whose expert is one of the ``len(wi)`` experts from ``first`` (all of
    them on one device), through that expert's SwiGLU (``weights`` =
    ``(wi, wg, wo)``, a partition's shards of them under DTensor) and
    weighted by its gate.  On the meta device every expert takes
    :func:`uniform_counts`' pairs."""
    wi, wg, wo = weights
    t, d = xt.shape
    k, e = cfg.top_k, cfg.num_experts
    last = first + wi.shape[0]
    pairs = torch.arange(t * k, device=xt.device)       # (token, choice)
    meta = xt.device.type == "meta"
    if meta:    # no values to count: the uniform load
        counts = uniform_counts(t, cfg, drop, group)[first:last]
    if drop:
        keep = capacity_keep(idx, cfg, group).flatten()
        pairs = pairs[:sum(counts)] if meta else pairs[keep]
    elif meta and (first, last) != (0, e):
        pairs = pairs[:sum(counts)]
    experts = idx.flatten()[pairs]
    if not meta and (first, last) != (0, e):    # another partition's
        pairs = pairs[(experts >= first) & (experts < last)]  # repro-lint: disable=TS102 -- a partition's pairs on the card: a mask like the drop path's keep; ROADMAP "MoE decode reads the expert counts on the host once per layer"
        experts = idx.flatten()[pairs] - first
    order = torch.argsort(experts, stable=True)         # grouped by expert
    pairs = pairs[order]
    token = pairs // k
    weight = gate.to(xt.dtype).float().flatten()[pairs]
    if not meta:
        counts = torch.bincount(experts, minlength=last - first).tolist()  # repro-lint: disable=TS102 -- ROADMAP "MoE decode reads the expert counts on the host once per layer"
        if tracing.enabled():
            # on the card bincount reads its input's least and greatest
            # value on the host, and tolist the counts: three syncs
            tracing.count("host_sync.moe_counts", 3 if xt.is_cuda else 0)
            if sum(counts):
                tracing.count("moe.expert_load",
                              max(counts) * len(counts) / sum(counts))
    y = torch.zeros(t, d, dtype=torch.float32, device=xt.device)
    start = 0
    for ex, n in enumerate(counts):
        if n == 0:
            continue
        rows = token[start:start + n]
        xe = xt[rows]
        h = F.silu(xe @ wg[ex]) * (xe @ wi[ex])
        y.index_add_(0, rows, (h @ wo[ex]).float()
                     * weight[start:start + n, None])
        start += n
    return y


def grouped_path(params: MoE, x, cfg: MoEConfig, drop: bool) -> bool:
    """Whether a call takes the device-side grouped pipeline: serving
    routing (``drop=False``) of a plain (not DTensor) CUDA tensor in
    bf16, no gradient recorded, and shapes the kernels take
    (:func:`repro_torch.kernels.moe.supports`).  Training, partitions,
    the meta device, the CPU and f32 keep the loop."""
    e, d, f = params.wi.shape
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, params.router, params.wi, params.wg,
                                  params.wo))
    return (not drop and not is_dtensor(x) and x.is_cuda
            and x.dtype == torch.bfloat16 and not recorded
            and kmoe.supports(d, f, e, cfg.top_k))


def _grouped(xt, gate, idx, weights) -> torch.Tensor:
    """``[T, d]`` in xt's dtype: every (token, choice) pair through the
    grouped pipeline (``weights`` = ``(wi, wg, wo)``).  Nothing is read on
    the host: the expert load is kept as a 0-dim device tensor, which
    :func:`repro_torch.runtime.tracing.take` reads after the window."""
    y, offs = kmoe.experts(xt, gate, idx, *weights)
    if tracing.enabled():
        tracing.count("moe.device_dispatch")
        counts = offs[1:] - offs[:-1]
        tracing.count("moe.expert_load",
                      counts.max().double() * counts.numel() / idx.numel())
    return y


def _partitioned(params: MoE, x, cfg: MoEConfig, drop: bool):
    """The MoE layer on one partition: the reference's groups of tokens
    sharded by ``act_batch`` (its ``xt`` constraint), its experts by
    ``act_experts`` and their hidden dim by ``act_mlp`` (its ``xe`` and
    ``h`` constraints), each partition routing its groups' tokens (the
    router gathered whole: the softmax and top-k read every expert) to
    its own experts' columns.  Their sum over the partitions that split
    experts or columns is reduced in f32 before the cast to x's dtype,
    as the reference's combine sums in f32.  The aux loss reads the
    token sums over every partition."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rules = current_rules()
    b, s, d = x.shape
    t = b * s
    g = group_size(t, cfg)
    e, f = cfg.num_experts, params.wi.shape[-1]
    xg = shard(x.reshape(t // g, g, d), "act_batch", None, None)
    mesh = xg.device_mesh
    # the expert buffers' layout: [groups, experts, capacity, d] and f
    xe_pl = placements(pspec_for((t // g, e, 1, d), (
        "act_batch", "act_experts", None, None), rules), mesh)
    h_pl = placements(pspec_for((t // g, e, 1, f), (
        "act_batch", "act_experts", None, "act_mlp"), rules), mesh)
    w_pl = tuple(Shard(0) if p.is_shard(1) else
                 Shard(2) if q.is_shard(3) else Replicate()
                 for p, q in zip(xe_pl, h_pl))
    wo_pl = tuple(Shard(1) if p == Shard(2) else p for p in w_pl)
    if any(w != Replicate() and p.is_shard(0)
           for w, p in zip(w_pl, xe_pl)):
        raise NotImplementedError(
            "experts split over a mesh axis that splits the tokens (an "
            "all-to-all): no such rules")
    xg = place_for(xg, tuple(p if p.is_shard(0) else Replicate()  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
                             for p in xg.placements), "moe.xt")
    tok = tuple(p.is_shard(0) for p in xg.placements)
    # the mesh dims over which the partitions compute different parts:
    # an operand replicated over one gets a partial sum as its gradient
    split = tuple(t_ or w != Replicate() for t_, w in zip(tok, w_pl))
    wi = place_for(params.wi, w_pl, "moe.wi")
    first = shard_index(mesh, wi.placements, 0)[0] * wi.to_local().shape[0]
    wi = local_shard(wi, split)
    wg = local_shard(place_for(params.wg, w_pl, "moe.wg"), split)
    wo = local_shard(place_for(params.wo, wo_pl, "moe.wo"), split)
    router = local_shard(place_for(params.router, (Replicate(),) * mesh.ndim,
                                   "moe.router"), split)
    xl = local_shard(xg, split).reshape(-1, d)
    probs = torch.softmax(xl.float() @ router, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    y = _experts(xl, gate, idx, cfg, drop, g, first, (wi, wg, wo))
    y = from_local(y.reshape(-1, g, d), mesh, tuple(
        Shard(0) if t_ else Partial() if w != Replicate() else Replicate()  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
        for t_, w in zip(tok, w_pl)))
    y = y.redistribute(mesh, tuple(p if p.is_shard() else Replicate()  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
                                   for p in y.placements))
    # Switch aux loss over every token: sums per partition, then reduced.
    # The router's probabilities are the same on every partition of a
    # dim that splits the experts; each takes 1/n of their sum there (n
    # a power of two: exact), so that the router's partial gradients
    # add up to one aux gradient.
    n_w = 1
    for m, (t_, w) in enumerate(zip(tok, split)):
        n_w *= mesh.size(m) if w and not t_ else 1  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
    frac = from_local(F.one_hot(idx[:, 0], e).float().sum(dim=0), mesh, tuple(
        Partial() if t_ else Replicate() for t_ in tok)) / t  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
    mean_prob = from_local(probs.sum(dim=0) / n_w, mesh, tuple(
        Partial() if w else Replicate() for w in split)) / t  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
    aux = cfg.aux_loss_weight * e * torch.sum(
        frac.redistribute(mesh, (Replicate(),) * mesh.ndim)
        * mean_prob.redistribute(mesh, (Replicate(),) * mesh.ndim))
    return y.to(x.dtype).reshape(b, s, d), aux

