"""Mamba2 (SSD — state-space duality) blocks and the mamba2 LM stack.

Mirrors ``repro/models/ssm.py``.  The full-sequence path (prefill) runs
the chunked SSD scan on kernel B5 (:mod:`repro_torch.kernels.ssd_scan`),
starting from the cache's state and returning the final one; a decode
step (one token against a cache) is the single-step recurrence in torch
ops, as it is jnp in the reference.

The depthwise causal conv is ``F.conv1d`` with ``groups=C`` (the
reference's ``lax.conv``, outside Pallas as there).  On the card an f32
convolution goes through cuDNN, which defaults to TF32; the port turns
TF32 off around it (:func:`causal_conv`) so the f32 path keeps f32.

Caches are stacked ``[L, ...]`` tensors updated in place, layer by
layer; ``length`` is a Python int.

Training: :func:`loss_fn` is the cross-entropy plus z-loss of a forward
without caches.  Under grad with ``cfg.remat`` each block runs in
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so the
backward recomputes it, kernel B5 included.  ``prefill`` and
``decode_step`` run without grad.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.dist.sharding import (
    is_dtensor, kept, on_shards, shard, unflatten_last,
)
from repro_torch.kernels import ssd_scan as scan
from repro_torch.models import layers as L
from repro_torch.models.layers import fan_in_normal, param
from repro_torch.runtime.tracing import spanned


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """The reference's fields but ``tie_embeddings`` and ``scan_layers``:
    the embedding is always the logits head (every configuration ties
    them) and the port loops over layers in Python.  ``chunk`` is the
    reference's SSD chunk length; the port's kernel tiles at its own 64
    steps (the result differs only in rounding), so the field has no
    effect here.  ``remat`` recomputes each block in the backward;
    ``zloss`` weighs the training loss's z-loss."""

    layers: int
    d_model: int
    vocab: int
    ssm_state: int = 128            # N
    head_dim: int = 64              # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128
    dtype: torch.dtype = torch.bfloat16
    vocab_pad_multiple: int = 128
    remat: bool = True
    norm_eps: float = 1e-6
    zloss: float = 1e-4

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab // m) * m

    @property
    def param_count(self) -> int:
        """The reference's count (tied embedding)."""
        d, di, n, h = self.d_model, self.d_inner, self.ssm_state, self.heads
        per_layer = (
            d * (2 * di + 2 * n + h)        # wz, wx, wB, wC, wdt
            + self.conv_width * (di + 2 * n)
            + 3 * h + di + di * d + d       # A_log/D/dt_bias, ln_gate, wo, ln
        )
        return self.layers * per_layer + self.padded_vocab * d + d

    active_param_count = param_count


class SSMCache(NamedTuple):
    """Constant-size decode state, stacked over a leading layer axis."""

    conv_x: torch.Tensor   # [..., B, W-1, di]
    conv_b: torch.Tensor   # [..., B, W-1, N]
    conv_c: torch.Tensor   # [..., B, W-1, N]
    state: torch.Tensor    # [..., B, H, N, P] fp32
    length: int


# --- block params -------------------------------------------------------------


class Mamba2Block(nn.Module):
    """One pre-norm Mamba2 block's parameters (the reference's names and
    layouts)."""

    def __init__(self, cfg: Mamba2Config, *, device, generator):
        super().__init__()
        d, di, n, h, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.heads,
                          cfg.conv_width)
        dt, f32 = cfg.dtype, torch.float32
        kw = dict(device=device, generator=generator)
        self.ln = L.RMSNorm(d, dt, device=device)
        self.wz = param(fan_in_normal((d, di), d, dt, **kw),
                        ("embed", "inner"))
        self.wx = param(fan_in_normal((d, di), d, dt, **kw),
                        ("embed", "inner"))
        self.wB = param(fan_in_normal((d, n), d, dt, **kw),
                        ("embed", "ssm_state"))
        self.wC = param(fan_in_normal((d, n), d, dt, **kw),
                        ("embed", "ssm_state"))
        self.wdt = param(fan_in_normal((d, h), d, f32, **kw),
                         ("embed", "ssm_heads"))
        self.conv_x = param(torch.full((w, di), 1.0 / w, dtype=dt,
                                       device=device), (None, "inner"))
        self.conv_b = param(torch.full((w, n), 1.0 / w, dtype=dt,
                                       device=device), (None, "ssm_state"))
        self.conv_c = param(torch.full((w, n), 1.0 / w, dtype=dt,
                                       device=device), (None, "ssm_state"))
        self.A_log = param(torch.zeros(h, dtype=f32, device=device),
                           ("ssm_heads",))
        self.D = param(torch.ones(h, dtype=f32, device=device),
                       ("ssm_heads",))
        self.dt_bias = param(torch.full((h,), -2.0, dtype=f32, device=device),
                             ("ssm_heads",))
        self.ln_gate = L.RMSNorm(di, dt, device=device)
        self.wo = param(fan_in_normal((di, d), di, dt, **kw),
                        ("inner", "embed"))


def block_init(cfg: Mamba2Config, *, device, generator) -> Mamba2Block:
    return Mamba2Block(cfg, device=device, generator=generator)


# --- causal depthwise conv ----------------------------------------------------


def causal_conv(x: torch.Tensor, kernel: torch.Tensor,
                tail: torch.Tensor | None = None):
    """x: [B, S, C]; kernel: [W, C].  ``tail`` [B, W-1, C] is the decode
    conv state (pre-activation inputs preceding x); zeros when None.
    Returns (y [B, S, C], new_tail [B, W-1, C]).  A DTensor x runs on
    each partition's shards (:func:`_partitioned_conv`)."""
    if is_dtensor(x):
        return _partitioned_conv(x, kernel, tail)
    b, s, c = x.shape
    w = kernel.shape[0]
    if tail is None:
        tail = torch.zeros(b, w - 1, c, dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)        # [B, S+W-1, C]
    new_tail = xp[:, -(w - 1):, :] if w > 1 else tail
    if s == 1:
        # decode: explicit dot with the tail
        y = torch.einsum("bwc,wc->bc", xp, kernel.to(x.dtype))[:, None, :]
        return y.to(x.dtype), new_tail
    weight = kernel.to(x.dtype).T[:, None, :]           # [C, 1, W]
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 stays f32 on the card
    try:
        y = F.conv1d(xp.transpose(1, 2), weight, groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = allow
    # back to [B, S, C] rows: kernel B5 reads the heads through strides
    # but needs each head's P values contiguous
    return y.transpose(1, 2).contiguous().to(x.dtype), new_tail


def _partitioned_conv(x, kernel, tail):
    """The depthwise conv on one partition's shards: x and the tail over
    x's batch shards and over the channel shards of either (a
    replicated one is split locally), the kernel over those channels
    (the sequence whole); y and the new tail placed as x then is."""
    from torch.distributed.tensor import Replicate, Shard

    tail_pl = tail.placements if tail is not None else \
        (Replicate(),) * x.device_mesh.ndim
    pl = tuple(
        Shard(0) if p.is_shard(0) else  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
        Shard(2) if p.is_shard(2) or q.is_shard(2) else Replicate()  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
        for p, q in zip(x.placements, tail_pl))
    kernel_pl = tuple(Shard(1) if p.is_shard(2) else Replicate() for p in pl)  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values
    return on_shards(causal_conv, "causal_conv", (
        ("x", x, pl), ("kernel", kernel, kernel_pl), ("tail", tail, pl)),
        (pl, pl))


# --- chunked SSD --------------------------------------------------------------


def ssd_chunked(xh, la, b, c, state0=None):
    """Chunked SSD on kernel B5.  xh: [B,S,H,P]; la: [B,S,H] (log
    decay); b,c: [B,S,N].  Returns (y [B,S,H,P] f32, final_state
    [B,H,N,P]).  la goes in as f32; b and c in the model's dtype (f32 or
    bf16), which the kernel widens to f32 exactly, as the reference casts
    them to its f32 compute dtype for the model path's f32 xh.  The
    reference's constraints inside its jnp scan (the chunk cumsum of la
    and the decay matrix, head-sharded) constrain B5's la and x here."""
    la = shard(la.float(), "act_batch", None, "act_heads")
    xh = shard(xh, "act_batch", None, "act_heads", None)
    y, final = _scan(xh, la, b, c, state0)
    return y.float(), final


def _scan(x, la, b, c, h0):
    """B5.  DTensors run on one partition's shards: sharded over batch
    and heads (x's), the sequence and the state dims whole; la follows
    x's batch and heads, b and c its batch, h0 its batch and heads.  y
    is placed as x, the final state over x's batch and heads."""
    if not is_dtensor(x):
        return scan.ssd_scan(x, la, b, c, h0)
    from torch.distributed.tensor import Replicate, Shard

    x_pl = kept(x, (0, 2))

    def like_x(heads_dim):
        return tuple(Shard(0) if p.is_shard(0) else
                     Shard(heads_dim) if p.is_shard(2) and heads_dim
                     else Replicate() for p in x_pl)

    return on_shards(scan.ssd_scan, "ssd_scan", (
        ("x", x, x_pl), ("la", la, like_x(2)), ("b", b, like_x(None)),
        ("c", c, like_x(None)), ("h0", h0, like_x(1))), (x_pl, like_x(1)))


# --- block apply --------------------------------------------------------------


@spanned("layer.mamba2")
def block_apply(cfg: Mamba2Config, params: Mamba2Block, x, *,
                cache: SSMCache | None):
    """Pre-norm Mamba2 block; returns (x, new_cache)."""
    x = shard(x, "act_batch", "act_seq", "act_embed")
    hin = params.ln(x, cfg.norm_eps)

    z = hin @ params.wz
    xs = hin @ params.wx
    bb = hin @ params.wB
    cc = hin @ params.wC
    dt = F.softplus(
        hin.float() @ params.wdt.to(hin.dtype).float() + params.dt_bias
    )                                                   # [B,S,H]

    tails = ((cache.conv_x, cache.conv_b, cache.conv_c) if cache is not None
             else (None,) * 3)
    xs, tail_x = causal_conv(xs, params.conv_x, tails[0])
    bb, tail_b = causal_conv(bb, params.conv_b, tails[1])
    cc, tail_c = causal_conv(cc, params.conv_c, tails[2])
    xs, bb, cc = F.silu(xs), F.silu(bb), F.silu(cc)
    xs = shard(xs, "act_batch", "act_seq", "act_mlp")

    bsz, s, _ = xs.shape
    h, p = cfg.heads, cfg.head_dim
    xh = shard(unflatten_last(xs, (h, p)), "act_batch", "act_seq",
               "act_heads", None)
    la = -torch.exp(params.A_log) * dt                  # [B,S,H] log decay
    xin = xh.float() * dt[..., None]

    state0 = cache.state if cache is not None else None
    if cache is not None and s == 1:
        # single-step recurrence (decode)
        lat = la[:, 0, :]                               # [B,H]
        hb = torch.einsum("bn,bhp->bhnp", bb[:, 0].float(), xin[:, 0])
        state = torch.exp(lat)[:, :, None, None] * cache.state + hb
        y = torch.einsum("bn,bhnp->bhp", cc[:, 0].float(), state)
        y = y[:, None]                                  # [B,1,H,P]
        final = state
    else:
        y, final = ssd_chunked(xin, la, bb, cc, state0)
    final = shard(final, "act_batch", "act_heads", None, None)

    y = y + params.D[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, cfg.d_inner).to(x.dtype)
    y = params.ln_gate(y * F.silu(z), cfg.norm_eps)
    out = shard(y @ params.wo, "act_batch", "act_seq", "act_embed")

    new_cache = None
    if cache is not None:
        new_cache = SSMCache(tail_x, tail_b, tail_c, final, cache.length + s)
    return x + out, new_cache


def layer_cache(caches: SSMCache, *index) -> SSMCache:
    """One layer's cache: views into the stacked tensors at ``index``."""
    return SSMCache(caches.conv_x[index], caches.conv_b[index],
                    caches.conv_c[index], caches.state[index],
                    caches.length)


def store_layer_cache(caches: SSMCache, new: SSMCache, *index) -> None:
    """Write one layer's updated cache back into the stack, in place."""
    for dst, src in zip(caches[:4], new[:4]):
        dst[index].copy_(src)


# --- LM stack -----------------------------------------------------------------


def logits_of(embed: L.Embedding, x: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Tied logits with the padded vocabulary masked to -1e30."""
    logits = shard(embed.unembed(x), "act_batch", "act_seq", "act_vocab")
    return L.mask_padded_vocab(logits, vocab)


class Mamba2LM(nn.Module):
    """Embedding (tied with the logits head), blocks, final norm."""

    def __init__(self, cfg: Mamba2Config, *, device, generator):
        super().__init__()
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, cfg.dtype,
                                 device=device, generator=generator)
        self.blocks = nn.ModuleList(
            block_init(cfg, device=device, generator=generator)
            for _ in range(cfg.layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.dtype, device=device)


def init(cfg: Mamba2Config, *, device, seed: int = 0) -> Mamba2LM:
    """Random weights from ``seed`` on ``device``."""
    gen = L.generator(device, seed)
    return Mamba2LM(cfg, device=device, generator=gen)


def apply_block(cfg: Mamba2Config, blk: Mamba2Block, x):
    """One block without a cache, remat'ed with ``cfg.remat`` (the
    reference's remat of the layer body)."""
    return L.remat(cfg.remat, _uncached, cfg, blk, x)


def _uncached(cfg: Mamba2Config, blk: Mamba2Block, x):
    return block_apply(cfg, blk, x, cache=None)[0]


def forward(params: Mamba2LM, tokens, cfg: Mamba2Config, *, caches=None):
    x = shard(params.embed(tokens).to(cfg.dtype), "act_batch", "act_seq",
              "act_embed")
    for i, blk in enumerate(params.blocks):
        if caches is None:
            x = apply_block(cfg, blk, x)
            continue
        x, new = block_apply(cfg, blk, x, cache=layer_cache(caches, i))
        store_layer_cache(caches, new, i)
    x = params.final_norm(x, cfg.norm_eps)
    logits = logits_of(params.embed, x, cfg.vocab)
    new_caches = None
    if caches is not None:
        new_caches = caches._replace(length=caches.length + tokens.shape[1])
    return logits, new_caches


def loss_fn(params: Mamba2LM, batch: dict, cfg: Mamba2Config):
    """batch: ``{"tokens": [B, S], "labels": [B, S]}``."""
    from repro_torch.models.transformer import softmax_xent

    logits, _ = forward(params, batch["tokens"], cfg)
    return softmax_xent(logits, batch["labels"], cfg.zloss)


def ssm_caches(lead: tuple, batch: int, cfg: Mamba2Config, *,
               device) -> SSMCache:
    w, di, n = cfg.conv_width, cfg.d_inner, cfg.ssm_state

    def zeros(*shape, dtype=cfg.dtype):
        return torch.zeros(*lead, batch, *shape, dtype=dtype, device=device)

    return SSMCache(
        conv_x=zeros(w - 1, di), conv_b=zeros(w - 1, n),
        conv_c=zeros(w - 1, n),
        state=zeros(cfg.heads, n, cfg.head_dim, dtype=torch.float32),
        length=0,
    )


def init_caches(cfg: Mamba2Config, batch: int, max_len: int = 0, *,
                device) -> SSMCache:
    """Stacked [L, ...] SSM caches; ``max_len`` is ignored (O(1) state)."""
    return ssm_caches((cfg.layers,), batch, cfg, device=device)


@torch.no_grad()
def prefill(params, tokens, cfg: Mamba2Config, caches):
    logits, caches = forward(params, tokens, cfg, caches=caches)
    return logits[:, -1, :], caches


@torch.no_grad()
def decode_step(params, token, cfg: Mamba2Config, caches, length):
    del length  # SSM state is position-free
    logits, caches = forward(params, token, cfg, caches=caches)
    return logits[:, -1, :], caches
