"""GQA attention: self-attention (causal, or bidirectional for an
encoder), prefill into a KV cache and decode, cross-attention over
projected encoder memory (``kv_override``), with an optional sliding
window (mixtral), every call on kernel B4
(:mod:`repro_torch.kernels.flash_attention`).

Mirrors ``repro/models/attention.py`` for the cases the serving path
takes.  The reference's ``sdpa`` chooses between a dense and a
q-blocked jnp form; the port has one form, the flash kernel, so
``attn_impl`` and ``block_q`` are accepted and have no effect.

The KV cache is updated in place (the reference's
``dynamic_update_slice`` returns a new array): the new keys and values
are written at ``cache.length`` and the call returns the same tensors
with the new length.  The cache path attends with ``q_offset =
cache.length`` and ``kv_len = cache.length + S``, which is the
reference's position mask (``_mask``: ``kv_pos < new_len``,
``kv_pos <= q_pos`` and, with a window, ``kv_pos > q_pos - window``) for
positions ``length + arange(S)``; the window goes to B4 as it is.
Cross-attention attends to every memory position (the reference's
``kv_valid`` is all true there): ``causal=False``, no window, ``kv_len``
the memory's length, and no cache update.

Given DTensors (a partitioned step), B4 runs on each partition's local
shards (:func:`_attend`): sharded over batch and heads, the sequence and
head dims whole, as XLA leaves a Pallas call.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import (
    is_dtensor, kept, on_shards, shard, shard_index,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import apply_rope, fan_in_normal, param
from repro_torch.runtime.tracing import spanned


class KVCache(NamedTuple):
    """Append cache: k, v ``[batch, max_len, kv_heads, head_dim]``."""

    k: torch.Tensor
    v: torch.Tensor
    length: int  # tokens currently valid


class Attention(nn.Module):
    """Projections ``wq [d, H, hd]``, ``wk``/``wv [d, Hkv, hd]``, ``wo
    [H, hd, d]`` (the reference's layouts)."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, dtype, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.wq = param(fan_in_normal((d_model, num_heads, head_dim),
                                      d_model, dtype, **kw),
                        ("embed", "heads", "head_dim"))
        self.wk = param(fan_in_normal((d_model, num_kv_heads, head_dim),
                                      d_model, dtype, **kw),
                        ("embed", "kv_heads", "head_dim"))
        self.wv = param(fan_in_normal((d_model, num_kv_heads, head_dim),
                                      d_model, dtype, **kw),
                        ("embed", "kv_heads", "head_dim"))
        self.wo = param(fan_in_normal((num_heads, head_dim, d_model),
                                      num_heads * head_dim, dtype, **kw),
                        ("heads", "head_dim", "embed"))


def attn_init(d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, dtype=torch.float32, *, device,
              generator) -> Attention:
    return Attention(d_model, num_heads, num_kv_heads, head_dim, dtype,
                     device=device, generator=generator)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, d] @ [d, H, hd] -> [B, S, H, hd]."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


@spanned("layer.attention")
def gqa_attention(
    params: Attention,
    x: torch.Tensor,                 # [B, S, D]
    *,
    positions: torch.Tensor,         # [B, S]
    rope_theta: float,
    causal: bool = True,
    window: int | None = None,
    cache: KVCache | None = None,
    kv_override=None,
    sp: bool = False,
    attn_impl: str = "blocked",
    block_q: int = 1024,
) -> tuple[torch.Tensor, KVCache | None]:
    """Full GQA attention.

    * self-attention: ``cache=None`` — keys/values from ``x`` itself;
    * prefill into a cache and decode: ``cache`` holds past KV; ``x``
      is the new token(s), written at ``cache.length``;
    * cross-attention: ``kv_override=(k_src, v_src)``, each ``[B, S_src,
      Hkv, hd]``, already projected (:func:`project_kv`, no RoPE) — not
      causal, no window, no cache update; q keeps RoPE at ``positions``.

    ``window`` (None = none) is the sliding window.  ``sp`` shards q's
    sequence by ``act_sp_seq`` (self-attention without a cache, as the
    reference's ``sp``).  ``attn_impl`` and ``block_q`` have no effect
    (one kernel form).
    """
    del attn_impl, block_q
    sp = sp and cache is None and kv_override is None
    q = apply_rope(_project(x, params.wq), positions, rope_theta)
    q = shard(q, "act_batch", "act_sp_seq" if sp else "act_seq",
              "act_heads", None)
    if kv_override is not None:
        k, v = kv_override
        out = _attend(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=False)
        return _out_proj(params, out), None
    k = apply_rope(_project(x, params.wk), positions, rope_theta)
    v = _project(x, params.wv)
    k = shard(k, "act_batch", None, "act_kv_heads", None)
    v = shard(v, "act_batch", None, "act_kv_heads", None)
    s_new = x.shape[1]
    if cache is None:
        out = _attend(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=causal, window=window)
        new_cache = None
    else:
        end = cache.length + s_new
        if end > cache.k.shape[1]:
            raise ValueError(f"KV cache of {cache.k.shape[1]} positions "
                             f"cannot take {end}")
        cache.k[:, cache.length:end] = k
        cache.v[:, cache.length:end] = v
        k_cache = shard(cache.k, "act_batch", "act_kv_seq", "act_kv_heads",
                        None)
        v_cache = shard(cache.v, "act_batch", "act_kv_seq", "act_kv_heads",
                        None)
        out = _attend(
            q.transpose(1, 2), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), causal=causal, q_offset=cache.length,
            kv_len=end, window=window)
        new_cache = KVCache(k_cache, v_cache, end)
    return _out_proj(params, out), new_cache


def _attend(q, k, v, **kw):
    """B4 on ``[B, H, S, hd]`` views.  DTensors run on one partition's
    shards: q sharded over batch and heads (any other placement gathered
    or reduced), k and v over q's batch shards, and over q's head shards
    where the kv heads divide as evenly; else replicated over heads, and
    each partition slices the kv heads its q heads read (GQA).  Sequence
    and head dims are whole, so ``q_offset``, ``kv_len`` and the window
    hold as they are.  The output is placed as q."""
    if not is_dtensor(q):
        return fa.flash_attention(q, k, v, **kw)
    from torch.distributed.tensor import Replicate, Shard

    mesh, (h, hkv) = q.device_mesh, (q.shape[1], k.shape[1])
    q_pl, kv_pl, split = kept(q, (0, 1)), [], 1
    for mesh_dim, p in enumerate(q_pl):
        if p.is_shard(1) and hkv % (split * mesh.size(mesh_dim)) == 0:  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
            split *= mesh.size(mesh_dim)
            kv_pl.append(Shard(1))
        else:
            kv_pl.append(Shard(0) if p.is_shard(0) else Replicate())
    first = shard_index(mesh, q_pl, 1)[0]

    def local(ql, kl, vl):
        hl = ql.shape[1]
        if hl * hkv != kl.shape[1] * h:     # kv heads whole: q's share
            rep = h // hkv
            lo, hi = first * hl // rep, (first * hl + hl - 1) // rep + 1
            if hl % (hi - lo):
                raise NotImplementedError(
                    f"{hl} local q heads over {hi - lo} kv heads")
            kl, vl = kl[:, lo:hi], vl[:, lo:hi]
        return fa.flash_attention(ql, kl, vl, **kw)

    return on_shards(local, "flash_attention",
                     (("q", q, q_pl), ("k", k, kv_pl), ("v", v, kv_pl)),
                     q_pl)


def _out_proj(params: Attention, out: torch.Tensor) -> torch.Tensor:
    """The heads' outputs ``[B, H, S, hd]`` through ``wo``, reduced where
    the heads are split: XLA's partitioner reduces a dot's partial sums
    at the dot, where DTensor would carry them into the next layer's
    norm and MLP."""
    y = out.transpose(1, 2).flatten(2) @ params.wo.flatten(0, 1)
    return shard(y, "act_batch", "act_seq", "act_embed")


def project_kv(params: Attention,
               memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder-memory K/V ``[B, S_src, Hkv, hd]`` for cross-attention
    (computed once per sequence; no RoPE, as in the reference)."""
    return _project(memory, params.wk), _project(memory, params.wv)
