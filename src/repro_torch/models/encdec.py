"""Encoder–decoder backbone (seamless-m4t): a bidirectional encoder over
precomputed frame embeddings ``[B, S_src, D]`` (the modality frontend is a
stub, as in the reference) and a causal decoder with cross-attention.

Mirrors ``repro/models/encdec.py`` for serving.  The reference scans
over stacked layer parameters; the port loops over one module per layer
in Python.  Every attention call runs kernel B4: the encoder's
self-attention not causal, the decoder's causal through its KV cache,
and cross-attention not causal over the source.  ``prefill`` projects
each decoder layer's cross K/V from the encoder memory once, into the
cache; decode steps read them from there.  The decoder's self-attention
caches are stacked ``[Ld, B, max_len, Hkv, hd]`` tensors updated in
place; lengths are Python ints.

Training: :func:`loss_fn` encodes the frames and decodes the tokens
without caches (each decoder layer projects its cross K/V from the
memory), cross-entropy plus z-loss.  Under grad with ``cfg.remat`` each
encoder and each decoder layer runs in ``torch.utils.checkpoint``, as
the reference remats both scans' bodies.  ``prefill`` and
``decode_step`` run without grad.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """The reference's fields.  ``attn_impl`` and ``block_q`` pick the
    reference's jnp attention form, ``scan_layers`` shapes its traced
    step; the port runs one attention form (kernel B4) eagerly, so they
    have no effect.  ``remat`` recomputes each layer in the backward;
    ``zloss`` weighs the training loss's z-loss."""

    enc_layers: int
    dec_layers: int
    d_model: int
    heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 64
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 128
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
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        qkvo = d * (self.heads + 2 * self.kv_heads) * hd + self.heads * hd * d
        enc = self.enc_layers * (qkvo + 3 * d * f + 2 * d)
        dec = self.dec_layers * (2 * qkvo + 3 * d * f + 3 * d)
        return enc + dec + 2 * self.padded_vocab * d + 2 * d

    active_param_count = param_count


class EncDecCache(NamedTuple):
    self_kv: attn.KVCache    # k, v [Ld, B, max_len, kv, hd]; target tokens
    cross_k: torch.Tensor    # [Ld, B, S_src, kv, hd]
    cross_v: torch.Tensor
    length: int              # target tokens so far


class EncoderBlock(nn.Module):
    """``ln_attn``, ``attn``, ``ln_mlp``, ``mlp`` (the reference's names
    and layouts)."""

    def __init__(self, cfg: EncDecConfig, *, device, generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        kw = dict(device=device, generator=generator)
        self.ln_attn = L.RMSNorm(d, dt, device=device)
        self.attn = attn.attn_init(d, cfg.heads, cfg.kv_heads, cfg.head_dim,
                                   dt, **kw)
        self.ln_mlp = L.RMSNorm(d, dt, device=device)
        self.mlp = L.MLP(d, cfg.d_ff, dt, **kw)


class DecoderBlock(EncoderBlock):
    """An encoder block plus ``ln_cross`` and the ``cross`` attention."""

    def __init__(self, cfg: EncDecConfig, *, device, generator):
        super().__init__(cfg, device=device, generator=generator)
        self.ln_cross = L.RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.cross = attn.attn_init(cfg.d_model, cfg.heads, cfg.kv_heads,
                                    cfg.head_dim, cfg.dtype, device=device,
                                    generator=generator)


class EncDecModel(nn.Module):
    """Embedding, encoder, decoder, their final norms and an untied
    logits head."""

    def __init__(self, cfg: EncDecConfig, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        d, dt = cfg.d_model, cfg.dtype
        self.embed = L.Embedding(cfg.padded_vocab, d, dt, **kw)
        self.encoder = nn.ModuleList(EncoderBlock(cfg, **kw)
                                     for _ in range(cfg.enc_layers))
        self.enc_norm = L.RMSNorm(d, dt, device=device)
        self.decoder = nn.ModuleList(DecoderBlock(cfg, **kw)
                                     for _ in range(cfg.dec_layers))
        self.dec_norm = L.RMSNorm(d, dt, device=device)
        self.unembed = L.Linear(d, cfg.padded_vocab, dt,
                                axes=("embed", "vocab"), **kw)


def init(cfg: EncDecConfig, *, device, seed: int = 0) -> EncDecModel:
    """Random weights from ``seed`` on ``device``."""
    gen = L.generator(device, seed)
    return EncDecModel(cfg, device=device, generator=gen)


def _enc_block(cfg: EncDecConfig, blk: EncoderBlock, x, positions):
    h = blk.ln_attn(x, cfg.norm_eps)
    a, _ = attn.gqa_attention(blk.attn, h, positions=positions,
                              rope_theta=cfg.rope_theta, causal=False)
    x = x + a
    m = blk.mlp(blk.ln_mlp(x, cfg.norm_eps))
    return x + shard(m, "act_batch", "act_seq", "act_embed")


def encode(params: EncDecModel, frames: torch.Tensor,
           cfg: EncDecConfig) -> torch.Tensor:
    """frames: [B, S_src, D] precomputed modality embeddings -> memory."""
    b, s, _ = frames.shape
    positions = shard(torch.arange(s, device=frames.device).expand(b, s),
                      "act_batch", "act_seq")
    x = shard(frames.to(cfg.dtype), "act_batch", "act_seq", "act_embed")
    for blk in params.encoder:
        x = L.remat(cfg.remat, _enc_block, cfg, blk, x, positions)
    return params.enc_norm(x, cfg.norm_eps)


def _dec_block(cfg: EncDecConfig, blk: DecoderBlock, x, *, positions,
               cross_kv, self_cache):
    h = blk.ln_attn(x, cfg.norm_eps)
    a, new_cache = attn.gqa_attention(
        blk.attn, h, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, cache=self_cache)
    x = x + a
    h = blk.ln_cross(x, cfg.norm_eps)
    c, _ = attn.gqa_attention(blk.cross, h, positions=positions,
                              rope_theta=cfg.rope_theta, causal=False,
                              kv_override=cross_kv)
    x = x + c
    m = blk.mlp(blk.ln_mlp(x, cfg.norm_eps))
    return x + shard(m, "act_batch", "act_seq", "act_embed"), new_cache


def _dec_block_uncached(cfg: EncDecConfig, blk: DecoderBlock, x, positions,
                        memory):
    """A decoder layer without caches: its cross K/V projected from the
    memory inside the layer (and so inside its checkpoint)."""
    x, _ = _dec_block(cfg, blk, x, positions=positions,
                      cross_kv=attn.project_kv(blk.cross, memory),
                      self_cache=None)
    return x


def decode_stack(params: EncDecModel, tokens, memory, cfg: EncDecConfig, *,
                 caches: EncDecCache | None = None, positions=None):
    """memory: [B, S_src, D] (ignored when cross K/V come from caches).
    Returns (logits [B, S, Vp], new_caches)."""
    b, s = tokens.shape
    if positions is None:
        base = caches.length if caches is not None else 0
        positions = (base + torch.arange(s, device=tokens.device)).expand(b, s)
    positions = shard(positions, "act_batch", "act_seq")
    x = shard(params.embed(tokens).to(cfg.dtype), "act_batch", "act_seq",
              "act_embed")
    for i, blk in enumerate(params.decoder):
        if caches is None:
            x = L.remat(cfg.remat, _dec_block_uncached, cfg, blk, x,
                        positions, memory)
            continue
        kv = caches.self_kv
        x, _ = _dec_block(cfg, blk, x, positions=positions,
                          cross_kv=(caches.cross_k[i], caches.cross_v[i]),
                          self_cache=attn.KVCache(kv.k[i], kv.v[i],
                                                  kv.length))
    x = params.dec_norm(x, cfg.norm_eps)
    logits = shard(params.unembed(x), "act_batch", "act_seq", "act_vocab")
    logits = L.mask_padded_vocab(logits, cfg.vocab)
    new_caches = None
    if caches is not None:
        kv = caches.self_kv
        new_caches = caches._replace(self_kv=kv._replace(length=kv.length + s),
                                     length=caches.length + s)
    return logits, new_caches


def loss_fn(params: EncDecModel, batch: dict, cfg: EncDecConfig):
    """batch: ``{"frames": [B, Ss, D], "tokens": [B, St], "labels": [B,
    St]}``."""
    from repro_torch.models.transformer import softmax_xent

    memory = encode(params, batch["frames"], cfg)
    logits, _ = decode_stack(params, batch["tokens"], memory, cfg)
    return softmax_xent(logits, batch["labels"], cfg.zloss)


def project_cross_kv(params: EncDecModel, memory: torch.Tensor,
                     cfg: EncDecConfig):
    """Per-layer cross K/V from encoder memory (computed once), stacked
    ``[Ld, B, S_src, Hkv, hd]``."""
    ks, vs = zip(*(attn.project_kv(blk.cross, memory)
                   for blk in params.decoder))
    return torch.stack(ks), torch.stack(vs)


def init_caches(cfg: EncDecConfig, batch: int, max_len: int, src_len: int,
                *, device) -> EncDecCache:
    """Self-attention caches for ``max_len`` target tokens and cross K/V
    for ``src_len`` source positions, in the model's dtype, length 0."""
    shape = (cfg.dec_layers, batch, max_len, cfg.kv_heads, cfg.head_dim)
    cross = (cfg.dec_layers, batch, src_len, cfg.kv_heads, cfg.head_dim)
    return EncDecCache(
        self_kv=attn.KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            length=0,
        ),
        cross_k=torch.zeros(cross, dtype=cfg.dtype, device=device),
        cross_v=torch.zeros(cross, dtype=cfg.dtype, device=device),
        length=0,
    )


@torch.no_grad()
def prefill(params, frames, tokens, cfg: EncDecConfig, caches: EncDecCache):
    """Encode the source, put its cross K/V in the caches and prefill the
    decoder's self-attention caches.  Returns (last-token logits [B, Vp],
    caches)."""
    memory = encode(params, frames, cfg)
    ck, cv = project_cross_kv(params, memory, cfg)
    caches = caches._replace(cross_k=ck.to(cfg.dtype),
                             cross_v=cv.to(cfg.dtype))
    logits, caches = decode_stack(params, tokens, None, cfg, caches=caches)
    return logits[:, -1, :], caches


@torch.no_grad()
def decode_step(params, token, cfg: EncDecConfig, caches: EncDecCache,
                length: int):
    """One decode step.  token: [B, 1]; length: target tokens so far.
    Returns (logits [B, Vp], caches)."""
    b = token.shape[0]
    positions = torch.full((b, 1), int(length), device=token.device)
    logits, caches = decode_stack(params, token, None, cfg, caches=caches,
                                  positions=positions)
    return logits[:, -1, :], caches
