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
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import apply_rope, fan_in_normal, param


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

    ``window`` (None = none) is the sliding window.  ``attn_impl`` and
    ``block_q`` have no effect (one kernel form).
    """
    del attn_impl, block_q
    q = apply_rope(_project(x, params.wq), positions, rope_theta)
    if kv_override is not None:
        k, v = kv_override
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=False)
        y = out.transpose(1, 2).flatten(2) @ params.wo.flatten(0, 1)
        return y, None
    k = apply_rope(_project(x, params.wk), positions, rope_theta)
    v = _project(x, params.wv)
    s_new = x.shape[1]
    if cache is None:
        out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window)
        new_cache = None
    else:
        end = cache.length + s_new
        if end > cache.k.shape[1]:
            raise ValueError(f"KV cache of {cache.k.shape[1]} positions "
                             f"cannot take {end}")
        cache.k[:, cache.length:end] = k
        cache.v[:, cache.length:end] = v
        out = fa.flash_attention(
            q.transpose(1, 2), cache.k.transpose(1, 2),
            cache.v.transpose(1, 2), causal=causal, q_offset=cache.length,
            kv_len=end, window=window)
        new_cache = KVCache(cache.k, cache.v, end)
    y = out.transpose(1, 2).flatten(2) @ params.wo.flatten(0, 1)
    return y, new_cache


def project_kv(params: Attention,
               memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Encoder-memory K/V ``[B, S_src, Hkv, hd]`` for cross-attention
    (computed once per sequence; no RoPE, as in the reference)."""
    return _project(memory, params.wk), _project(memory, params.wv)
