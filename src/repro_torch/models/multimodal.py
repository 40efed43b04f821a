"""VLM wrapper (phi-3-vision): the projection of precomputed patch
embeddings ``[B, P, clip_dim]`` (the CLIP frontend is a stub, as in the
reference) into the backbone's embedding space, ahead of the text; the
rest is the transformer backbone (:mod:`repro_torch.models.transformer`).

Mirrors ``repro/models/multimodal.py`` for serving.  The cache holds the
``num_patches`` prefix positions before the text, so a decode step after
a prompt of ``S`` text tokens is at ``length = num_patches + S + t``, the
model's contract (``repro/launch/serve.py`` passes ``S + t``, which the
port does not copy: ROADMAP C7).  :func:`loss_fn` puts the projected
patches ahead of the text and takes the backbone's loss on the text
positions only.  ``prefill`` and ``decode_step`` run without grad.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    backbone: tfm.TransformerConfig
    clip_dim: int = 1024
    num_patches: int = 1024

    @property
    def param_count(self) -> int:
        return self.backbone.param_count + self.clip_dim * self.backbone.d_model

    active_param_count = param_count

    @property
    def padded_vocab(self) -> int:
        return self.backbone.padded_vocab


class VLM(nn.Module):
    """``backbone`` (a :class:`~repro_torch.models.transformer.TransformerLM`)
    and ``patch_proj`` ``[clip_dim, d_model]``."""

    def __init__(self, cfg: VLMConfig, *, device, generator):
        super().__init__()
        bb = cfg.backbone
        self.backbone = tfm.TransformerLM(bb, device=device,
                                          generator=generator)
        self.patch_proj = L.Linear(cfg.clip_dim, bb.d_model, bb.dtype,
                                   axes=("embed", None), device=device,
                                   generator=generator)


def init(cfg: VLMConfig, *, device, seed: int = 0) -> VLM:
    """Random weights from ``seed`` on ``device``."""
    gen = L.generator(device, seed)
    return VLM(cfg, device=device, generator=gen)


def _project(params: VLM, patches: torch.Tensor) -> torch.Tensor:
    return params.patch_proj(patches.to(params.patch_proj.w.dtype))


def loss_fn(params: VLM, batch: dict, cfg: VLMConfig):
    """batch: ``{"patches": [B, P, clip_dim], "tokens": [B, S_text],
    "labels": [B, S_text]}``."""
    b = dict(batch)
    b["patch_embeds"] = _project(params, batch["patches"])
    return tfm.loss_fn(params.backbone, b, cfg.backbone)


def init_caches(cfg: VLMConfig, batch: int, max_len: int, *, device):
    """The backbone's caches; ``max_len`` counts the patch prefix."""
    return tfm.init_caches(cfg.backbone, batch, max_len, device=device)


@torch.no_grad()
def prefill(params: VLM, patches, tokens, cfg: VLMConfig, caches):
    """The projected patches, then the text, through the backbone.
    Returns (last-token logits [B, Vp], caches)."""
    prefix = _project(params, patches)
    return tfm.prefill(params.backbone, tokens, cfg.backbone, caches,
                       prefix_embeds=prefix)


@torch.no_grad()
def decode_step(params: VLM, token, cfg: VLMConfig, caches, length: int):
    """One decode step; ``length`` counts the patch prefix."""
    return tfm.decode_step(params.backbone, token, cfg.backbone, caches,
                           length)
