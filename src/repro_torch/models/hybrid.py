"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention block.

Mirrors ``repro/models/hybrid.py``.  The single shared transformer
block (one set of weights) is applied before every group of
``attn_every`` Mamba2 layers; its input is a learned projection of
concat(hidden, original embedding).  Weights are shared across
applications; KV caches are not (one cache per application site).
The reference scans over groups and layers; the port loops in Python.
Every attention call runs kernel B4 and every Mamba2 layer without a
decode cache kernel B5.

Training: :func:`loss_fn` is the cross-entropy plus z-loss of a forward
without caches.  Under grad with ``cfg.remat`` each Mamba2 layer runs in
``torch.utils.checkpoint`` and the shared attention block does not, as
the reference's ``mamba_fn`` is remat'ed and its shared block is not:
a training step launches B4 once per application site and B5 twice per
Mamba2 layer (the forward and the backward's recomputation).
``prefill`` and ``decode_step`` run without grad.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import shard
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.layers import fan_in_normal, param


@dataclasses.dataclass(frozen=True)
class Zamba2Config:
    """The reference's fields but ``tie_embeddings`` and ``scan_layers``
    (see :class:`repro_torch.models.ssm.Mamba2Config`).  ``attn_impl``
    and ``block_q`` select the reference's jnp attention form; the port
    has one form (kernel B4), so they have no effect, nor has ``chunk``.
    ``remat`` recomputes each Mamba2 layer in the backward; ``zloss``
    weighs the training loss's z-loss."""

    layers: int
    d_model: int
    vocab: int
    heads: int = 32
    kv_heads: int = 32
    d_ff: int = 8192
    ssm_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    attn_every: int = 6
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 128
    attn_impl: str = "blocked"
    block_q: int = 1024
    remat: bool = True
    norm_eps: float = 1e-6
    zloss: float = 1e-4

    @property
    def num_groups(self) -> int:
        return self.layers // self.attn_every

    @property
    def trailing(self) -> int:
        return self.layers - self.num_groups * self.attn_every

    @property
    def param_count(self) -> int:
        """The reference's count (tied embedding)."""
        d, hd = self.d_model, self.head_dim
        mcfg = self.mamba_cfg()
        per_mamba = (mcfg.param_count - self.padded_vocab * d - d) // self.layers
        shared = (
            2 * d * d                                   # w_cat
            + d * (self.heads + 2 * self.kv_heads) * hd
            + self.heads * hd * d
            + 3 * d * self.d_ff + 3 * d
        )
        return self.layers * per_mamba + shared + self.padded_vocab * d + d

    active_param_count = param_count

    def mamba_cfg(self) -> ssm.Mamba2Config:
        return ssm.Mamba2Config(
            layers=self.layers, d_model=self.d_model, vocab=self.vocab,
            ssm_state=self.ssm_state, head_dim=self.head_dim,
            expand=self.expand, conv_width=self.conv_width, chunk=self.chunk,
            dtype=self.dtype, vocab_pad_multiple=self.vocab_pad_multiple,
            remat=self.remat, norm_eps=self.norm_eps, zloss=self.zloss,
        )

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m


class HybridCache(NamedTuple):
    groups: ssm.SSMCache            # [G, P, ...] per-group mamba states
    trailing: ssm.SSMCache | None   # [T, ...]
    attn: attn.KVCache              # k, v [G, B, max_len, kv, hd]
    length: int


class SharedBlock(nn.Module):
    def __init__(self, cfg: Zamba2Config, *, device, generator):
        super().__init__()
        d, dt = cfg.d_model, cfg.dtype
        kw = dict(device=device, generator=generator)
        self.w_cat = param(fan_in_normal((2 * d, d), 2 * d, dt, **kw),
                           ("embed", None))
        self.ln_attn = L.RMSNorm(d, dt, device=device)
        self.attn = attn.attn_init(d, cfg.heads, cfg.kv_heads, cfg.head_dim,
                                   dt, **kw)
        self.ln_mlp = L.RMSNorm(d, dt, device=device)
        self.mlp = L.MLP(d, cfg.d_ff, dt, **kw)


class Zamba2LM(nn.Module):
    """Embedding (tied with the logits head), ``groups`` of Mamba2
    blocks, the shared block, ``trailing`` blocks, final norm."""

    def __init__(self, cfg: Zamba2Config, *, device, generator):
        super().__init__()
        mcfg = cfg.mamba_cfg()
        kw = dict(device=device, generator=generator)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, cfg.dtype,
                                 **kw)
        self.groups = nn.ModuleList(
            nn.ModuleList(ssm.block_init(mcfg, **kw)
                          for _ in range(cfg.attn_every))
            for _ in range(cfg.num_groups))
        self.shared = SharedBlock(cfg, **kw)
        self.trailing = nn.ModuleList(
            ssm.block_init(mcfg, **kw) for _ in range(cfg.trailing))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.dtype, device=device)


def init(cfg: Zamba2Config, *, device, seed: int = 0) -> Zamba2LM:
    """Random weights from ``seed`` on ``device``."""
    gen = L.generator(device, seed)
    return Zamba2LM(cfg, device=device, generator=gen)


def _shared_attn(cfg, sp: SharedBlock, x, x0, positions, kv_cache):
    """One application of the shared global block."""
    h = torch.cat([x, x0], dim=-1) @ sp.w_cat
    h = sp.ln_attn(h, cfg.norm_eps)
    a, new_cache = attn.gqa_attention(
        sp.attn, h, positions=positions, rope_theta=cfg.rope_theta,
        causal=True, cache=kv_cache, attn_impl=cfg.attn_impl,
        block_q=cfg.block_q,
    )
    x = x + a
    m = sp.mlp(sp.ln_mlp(x, cfg.norm_eps))
    return x + shard(m, "act_batch", "act_seq", "act_embed"), new_cache


def forward(params: Zamba2LM, tokens, cfg: Zamba2Config, *,
            caches: HybridCache | None = None, positions=None):
    mcfg = cfg.mamba_cfg()
    x = params.embed(tokens).to(cfg.dtype)
    x0 = x
    b, s, _ = x.shape
    if positions is None:
        base = caches.length if caches is not None else 0
        positions = (base + torch.arange(s, device=x.device)).expand(b, s)
    positions = shard(positions, "act_batch", "act_seq")
    x = shard(x, "act_batch", "act_seq", "act_embed")

    def mamba(blk, x, stack, *index):
        if caches is None:
            return ssm.apply_block(mcfg, blk, x)
        x, new = ssm.block_apply(mcfg, blk, x,
                                 cache=ssm.layer_cache(stack, *index))
        ssm.store_layer_cache(stack, new, *index)
        return x

    for g, group in enumerate(params.groups):
        kv = None
        if caches is not None:
            kv = attn.KVCache(caches.attn.k[g], caches.attn.v[g],
                              caches.attn.length)
        x, _ = _shared_attn(cfg, params.shared, x, x0, positions, kv)
        for i, blk in enumerate(group):
            x = mamba(blk, x, caches and caches.groups, g, i)
    for i, blk in enumerate(params.trailing):
        x = mamba(blk, x, caches and caches.trailing, i)

    x = params.final_norm(x, cfg.norm_eps)
    logits = ssm.logits_of(params.embed, x, cfg.vocab)
    new_caches = None
    if caches is not None:
        length = caches.length + s
        new_caches = caches._replace(
            attn=caches.attn._replace(length=length),
            groups=caches.groups._replace(length=length),
            trailing=(caches.trailing._replace(length=length)
                      if caches.trailing is not None else None),
            length=length)
    return logits, new_caches


def loss_fn(params: Zamba2LM, batch: dict, cfg: Zamba2Config):
    """batch: ``{"tokens": [B, S], "labels": [B, S]}``."""
    from repro_torch.models.transformer import softmax_xent

    logits, _ = forward(params, batch["tokens"], cfg)
    return softmax_xent(logits, batch["labels"], cfg.zloss)


def init_caches(cfg: Zamba2Config, batch: int, max_len: int, *,
                device) -> HybridCache:
    mcfg = cfg.mamba_cfg()
    g, p, t = cfg.num_groups, cfg.attn_every, cfg.trailing
    kv_shape = (g, batch, max_len, cfg.kv_heads, cfg.head_dim)
    return HybridCache(
        groups=ssm.ssm_caches((g, p), batch, mcfg, device=device),
        trailing=(ssm.ssm_caches((t,), batch, mcfg, device=device)
                  if t else None),
        attn=attn.KVCache(
            k=torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(kv_shape, dtype=cfg.dtype, device=device),
            length=0,
        ),
        length=0,
    )


@torch.no_grad()
def prefill(params, tokens, cfg: Zamba2Config, caches):
    logits, caches = forward(params, tokens, cfg, caches=caches)
    return logits[:, -1, :], caches


@torch.no_grad()
def decode_step(params, token, cfg: Zamba2Config, caches, length: int):
    b = token.shape[0]
    positions = torch.full((b, 1), int(length), device=token.device)
    logits, caches = forward(params, token, cfg, caches=caches,
                             positions=positions)
    return logits[:, -1, :], caches
