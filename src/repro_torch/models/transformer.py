"""Decoder-only transformer family (llama / qwen / yi / deepseek /
mixtral / arctic): dense GQA, MoE (mixtral), MoE beside a dense MLP
(arctic) and sliding-window attention.

Mirrors ``repro/models/transformer.py``.  The reference scans over
stacked layer parameters; the port loops over one module per layer in
Python.  Every attention call runs kernel B4, windowed where the config
has a window.  KV caches are stacked ``[L, B, max_len, Hkv, hd]``
tensors updated in place, layer by layer; ``length`` is a Python int.

Training: :func:`loss_fn` is the mean cross-entropy plus z-loss
(:func:`softmax_xent`) and the MoE layers' aux loss of a forward
without caches, where a MoE layer routes by capacity.  Under grad with
``cfg.remat``, each block runs in ``torch.utils.checkpoint`` (nothing
saved but its input, the reference's ``jax.checkpoint`` with
``nothing_saveable``), so the backward recomputes the block, attention
included.  ``prefill`` and ``decode_step`` run without grad.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.sharding import logsumexp_last, shard, take_last
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's fields.  ``attn_sp`` and ``sp_residuals`` shard
    attention and the residual stream over a device mesh,
    ``scan_layers`` shapes the traced step, and ``attn_impl`` and
    ``block_q`` pick the reference's jnp attention form; the port runs
    on one device, eagerly, with one attention form (kernel B4), so they
    have no effect.  ``remat`` recomputes each block in the backward;
    ``zloss`` weighs the training loss's z-loss."""

    layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    window: int | None = None
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 128
    moe: MoEConfig | None = None
    dense_ff: bool = True            # arctic keeps a dense MLP beside the MoE
    attn_sp: bool = False
    sp_residuals: bool = False
    attn_impl: str = "blocked"
    block_q: int = 1024
    remat: bool = True
    scan_layers: bool = True
    norm_eps: float = 1e-6
    zloss: float = 1e-4

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        h, kv, hd = self.heads, self.kv_heads, self.head_dim
        attn_p = d * (h + 2 * kv) * hd + h * hd * d
        mlp_p = 3 * d * f if (self.moe is None or self.dense_ff) else 0
        moe_p = 3 * d * f * self.moe.num_experts + d * self.moe.num_experts \
            if self.moe else 0
        return self.layers * (attn_p + mlp_p + moe_p + 2 * d) + 2 * v * d + d

    @property
    def active_param_count(self) -> int:
        """Params touched per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.param_count
        d, f = self.d_model, self.d_ff
        dense = self.param_count - self.layers * 3 * d * f * self.moe.num_experts
        return dense + self.layers * 3 * d * f * self.moe.top_k


# --- single block -------------------------------------------------------------


class Block(nn.Module):
    """One pre-norm block's parameters (the reference's names and
    layouts): ``mlp`` unless the config is MoE-only, ``moe`` if it has
    experts."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        kw = dict(device=device, generator=generator)
        self.ln_attn = L.RMSNorm(d, dt, device=device)
        self.attn = attn.attn_init(d, cfg.heads, cfg.kv_heads, cfg.head_dim,
                                   dt, **kw)
        self.ln_mlp = L.RMSNorm(d, dt, device=device)
        if cfg.moe is None or cfg.dense_ff:
            self.mlp = L.MLP(d, cfg.d_ff, dt, **kw)
        if cfg.moe is not None:
            self.moe = moe_init(d, cfg.d_ff, cfg.moe, dt, **kw)


def block_init(cfg: TransformerConfig, *, device, generator) -> Block:
    return Block(cfg, device=device, generator=generator)


def block_apply(cfg: TransformerConfig, params: Block, x, *, positions,
                cache: attn.KVCache | None):
    """Pre-norm residual block; returns (x, new_cache, aux_loss).  The
    reference's order, in x's dtype: ``x + attn``, then ``y = 0 + mlp``,
    ``y + moe``, and ``x + y``."""
    res_seq = "act_sp_seq" if (cfg.sp_residuals and cache is None) \
        else "act_seq"
    x = shard(x, "act_batch", res_seq, "act_embed")
    h = params.ln_attn(x, cfg.norm_eps)
    a, new_cache = attn.gqa_attention(
        params.attn, h, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, window=cfg.window, cache=cache, sp=cfg.attn_sp,
        attn_impl=cfg.attn_impl, block_q=cfg.block_q,
    )
    x = x + a
    h = params.ln_mlp(x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y = torch.zeros_like(x)
    if cfg.moe is None or cfg.dense_ff:
        y = y + shard(params.mlp(h), "act_batch", res_seq, "act_embed")
    if cfg.moe is not None:
        # inference (a cache present) routes every token, as the
        # reference does; without a cache (training) it drops by capacity
        ym, aux = moe_apply(params.moe, h, cfg.moe, drop=cache is None)
        y = y + ym
    return shard(x + y, "act_batch", res_seq, "act_embed"), new_cache, aux


# --- stacked model ------------------------------------------------------------


class TransformerLM(nn.Module):
    """Embedding, blocks, final norm and an untied logits head."""

    def __init__(self, cfg: TransformerConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, cfg.dtype,
                                 **kw)
        self.blocks = nn.ModuleList(block_init(cfg, **kw)
                                    for _ in range(cfg.layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.unembed = L.Linear(cfg.d_model, cfg.padded_vocab, cfg.dtype,
                                axes=("embed", "vocab"), **kw)


def init(cfg: TransformerConfig, *, device, seed: int = 0) -> TransformerLM:
    """Random weights from ``seed`` on ``device``."""
    gen = L.generator(device, seed)
    return TransformerLM(cfg, device=device, generator=gen)


def _block_remat(cfg: TransformerConfig, blk: Block, x, positions):
    x, _, aux = block_apply(cfg, blk, x, positions=positions, cache=None)
    return x, aux


def forward(params: TransformerLM, tokens, cfg: TransformerConfig, *,
            positions=None, caches: attn.KVCache | None = None,
            prefix_embeds=None):
    """Returns (logits [B, P + S, Vp], new_caches, aux_loss).
    ``prefix_embeds`` ``[B, P, D]`` (a VLM's projected patches) go before
    the token embeddings; positions start at the caches' length (0
    without caches), counting the prefix.  Without caches, under grad
    and with ``cfg.remat``, each block is checkpointed."""
    x = params.embed(tokens).to(cfg.dtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cfg.dtype), x], dim=1)
    b, s, _ = x.shape
    if positions is None:
        base = caches.length if caches is not None else 0
        positions = (base + torch.arange(s, device=x.device)).expand(b, s)
    positions = shard(positions, "act_batch", "act_seq")
    x = shard(x, "act_batch", "act_seq", "act_embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(params.blocks):
        if caches is None:
            x, a = L.remat(cfg.remat, _block_remat, cfg, blk, x, positions)
        else:
            x, _, a = block_apply(
                cfg, blk, x, positions=positions,
                cache=attn.KVCache(caches.k[i], caches.v[i], caches.length))
        aux = aux + a
    x = params.final_norm(x, cfg.norm_eps)
    logits = shard(params.unembed(x), "act_batch", "act_seq", "act_vocab")
    logits = L.mask_padded_vocab(logits, cfg.vocab)
    new_caches = None
    if caches is not None:
        new_caches = caches._replace(length=caches.length + s)
    return logits, new_caches, aux


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 zloss: float) -> torch.Tensor:
    """Mean cross-entropy (+ z-loss) in f32."""
    lf = logits.float()
    lse = logsumexp_last(lf)
    ll = take_last(lf, labels.long())
    loss = torch.mean(lse - ll)
    if zloss:
        loss = loss + zloss * torch.mean(lse ** 2)
    return loss


def loss_fn(params: TransformerLM, batch: dict, cfg: TransformerConfig):
    """batch: ``{"tokens": [B, S], "labels": [B, S], ["patch_embeds":
    [B, P, D]]}``; with a prefix, the loss is on the text positions
    only.  The MoE layers' aux loss is added."""
    prefix = batch.get("patch_embeds")
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:, :]
    return softmax_xent(logits, batch["labels"], cfg.zloss) + aux


# --- serving ------------------------------------------------------------------


def init_caches(cfg: TransformerConfig, batch: int, max_len: int, *,
                device) -> attn.KVCache:
    """k, v ``[L, B, max_len, Hkv, hd]`` in the model's dtype, length 0;
    layer ``i`` attends through the views ``k[i]``, ``v[i]``."""
    shape = (cfg.layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return attn.KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=0,
    )


@torch.no_grad()
def prefill(params, tokens, cfg: TransformerConfig, caches,
            prefix_embeds=None):
    """Run the full prompt (after ``prefix_embeds``, if given) through
    the stack, filling the caches.  Returns (last-token logits [B, Vp],
    caches)."""
    logits, caches, _ = forward(params, tokens, cfg, caches=caches,
                                prefix_embeds=prefix_embeds)
    return logits[:, -1, :], caches


@torch.no_grad()
def decode_step(params, token, cfg: TransformerConfig, caches, length: int):
    """One decode step.  token: [B, 1]; length: tokens so far.
    Returns (logits [B, Vp], caches)."""
    b = token.shape[0]
    positions = torch.full((b, 1), int(length), device=token.device)
    logits, caches, _ = forward(params, token, cfg, positions=positions,
                                caches=caches)
    return logits[:, -1, :], caches
