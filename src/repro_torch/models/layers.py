"""Common layers: initialisers, RMSNorm, linear, embedding, RoPE, SwiGLU
MLP, and the remat helper of the training forward.

Mirrors ``repro/models/layers.py``.  A block's parameters are the
``nn.Parameter``s of its module, in the reference's layouts (``[d_in,
d_out]`` weights), so that the reference's values carry across unchanged
(:mod:`repro_torch.interop`); each carries the logical axes of the
reference's ``PSpec`` (:func:`param`), which :func:`param_axes` reads for
the sharding rules.  Initialisers draw
from a ``torch.Generator``; they do not reproduce ``jax.random``'s
numbers, so parity tests carry the reference's weights across instead.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import lookup_rows
from repro_torch.runtime import tracing


# --- initializers ------------------------------------------------------------


def normal(shape, scale: float, dtype, *, device, generator) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32, cast to ``dtype`` (on the meta
    device, an empty tensor: nothing is drawn)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (scale * x).to(dtype)


def fan_in_normal(shape, fan_in: int, dtype, *, device,
                  generator) -> torch.Tensor:
    return normal(shape, fan_in ** -0.5, dtype, device=device,
                  generator=generator)


def param(t: torch.Tensor, axes: tuple) -> nn.Parameter:
    """A parameter carrying the logical axis names of its dims
    (``axes``, the reference's ``PSpec`` axes, one per dim)."""
    if len(axes) != t.dim():
        raise ValueError(f"axes {axes} for a {t.dim()}-D parameter")
    p = nn.Parameter(t, requires_grad=False)
    p.axes = tuple(axes)
    return p


def generator(device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    the meta device, where nothing is drawn (an abstract model)."""
    device = torch.device(device)
    if device.type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def param_axes(model: nn.Module) -> dict[str, tuple]:
    """``{leaf: logical axes}`` of ``model``'s parameters, by the leaves
    of :func:`repro_torch.train.optimizer.param_leaves`: a leaf's own
    axes behind one ``"layers"`` per stacked dimension, as the
    reference's ``stack_layer_params`` prepends them (twice for the
    hybrid's groups of layers)."""
    from repro_torch.train.optimizer import param_leaves

    params = dict(model.named_parameters())
    return {leaf: ("layers",) * len(info.lead) + params[info.names[0]].axes
            for leaf, info in param_leaves(model).items()}


def remat(enabled: bool, fn, *args):
    """``fn(*args)``; under grad with ``enabled``, inside
    ``torch.utils.checkpoint``, which saves only the arguments and
    recomputes the rest in the backward (the reference's
    ``jax.checkpoint`` with ``nothing_saveable``)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --- norms -------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, *, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device),
                           ("embed",))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """The reference's order: an f32 sum of squares, the inverse
        cast to ``x.dtype`` before the multiply."""
        ss = torch.einsum("...d,...d->...", x.float(), x.float())
        inv = torch.rsqrt(ss[..., None] / x.shape[-1] + eps)
        return x * inv.to(x.dtype) * self.scale.to(x.dtype)


# --- linear ------------------------------------------------------------------


class Linear(nn.Module):
    """``w [d_in, d_out]``, fan-in normal, with the logical ``axes`` of
    its two dims (the reference's ``linear_init``/``linear``)."""

    def __init__(self, d_in: int, d_out: int, dtype, *, axes, device,
                 generator):
        super().__init__()
        self.w = param(fan_in_normal((d_in, d_out), d_in, dtype,
                                     device=device, generator=generator),
                       axes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w


# --- embedding ---------------------------------------------------------------


class Embedding(nn.Module):
    """Token table ``[vocab, d]``; :meth:`unembed` is the tied head."""

    def __init__(self, vocab: int, d: int, dtype, *, device, generator):
        super().__init__()
        self.table = param(normal((vocab, d), 1.0, dtype, device=device,
                                  generator=generator), ("vocab", "embed"))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return lookup_rows(self.table, tokens)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-weights logits head: (..., d) @ (vocab, d)^T."""
        return x @ self.table.T


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Logits of the padded vocabulary (ids >= ``vocab``) set to -1e30,
    as the reference's forward does."""
    padded = logits.shape[-1]
    if padded == vocab:
        return logits
    pad = torch.arange(padded, device=logits.device) >= vocab
    return logits.masked_fill(pad, -1e30)


# --- rotary position embeddings ----------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / theta ** (np.arange(0, head_dim, 2, np.float32) / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = torch.from_numpy(rope_frequencies(x.shape[-1], theta)).to(x.device)  # repro-lint: disable=TS103 -- ROADMAP "Decode is host-bound": RoPE frequencies copied per attention call
    tracing.count("host_sync.rope_freqs", int(x.is_cuda))  # pageable copy
    ang = positions[..., :, None].float() * freqs        # [..., S, hd/2]
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --- gated MLP (SwiGLU) --------------------------------------------------------


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.wi = param(fan_in_normal((d, d_ff), d, dtype, **kw),
                        ("embed", "mlp"))
        self.wg = param(fan_in_normal((d, d_ff), d, dtype, **kw),
                        ("embed", "mlp"))
        self.wo = param(fan_in_normal((d_ff, d), d_ff, dtype, **kw),
                        ("mlp", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi
        g = x @ self.wg
        return (nn.functional.silu(g) * h) @ self.wo
