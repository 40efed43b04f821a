"""Reduced (smoke-test) variants of every architecture — same family and
code paths, small dims: the branches of ``repro/configs/reduced.py``,
unchanged.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, Shape
from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.hybrid import Zamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.models.multimodal import VLMConfig
from repro_torch.models.ssm import Mamba2Config
from repro_torch.models.transformer import TransformerConfig

SMOKE_SHAPE = Shape("smoke", 64, 4, "train")
SMOKE_PREFILL = Shape("smoke_prefill", 32, 2, "prefill")
SMOKE_DECODE = Shape("smoke_decode", 32, 2, "decode")


def _reduce_transformer(cfg: TransformerConfig) -> TransformerConfig:
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=4, top_k=2, tokens_per_group=32,
                        capacity_factor=cfg.moe.capacity_factor)
    return dataclasses.replace(
        cfg, layers=2, d_model=64, heads=4, kv_heads=min(cfg.kv_heads, 2) if
        cfg.kv_heads < cfg.heads else 4, d_ff=128, vocab=256, head_dim=16,
        window=16 if cfg.window else None, moe=moe, block_q=16,
        vocab_pad_multiple=32,
    )


def reduced(spec: ArchSpec) -> ArchSpec:
    cfg = spec.config
    if isinstance(cfg, TransformerConfig):
        small = _reduce_transformer(cfg)
    elif isinstance(cfg, Mamba2Config):
        small = dataclasses.replace(
            cfg, layers=2, d_model=32, vocab=256, ssm_state=16, head_dim=8,
            chunk=8, vocab_pad_multiple=32,
        )
    elif isinstance(cfg, Zamba2Config):
        small = dataclasses.replace(
            cfg, layers=5, d_model=32, vocab=256, heads=4, kv_heads=4,
            d_ff=64, ssm_state=16, head_dim=8, attn_every=2, chunk=8,
            block_q=16, vocab_pad_multiple=32,
        )
    elif isinstance(cfg, EncDecConfig):
        small = dataclasses.replace(
            cfg, enc_layers=2, dec_layers=2, d_model=32, heads=4, kv_heads=4,
            d_ff=64, vocab=256, head_dim=8, block_q=16, vocab_pad_multiple=32,
        )
    elif isinstance(cfg, VLMConfig):
        small = VLMConfig(
            backbone=_reduce_transformer(cfg.backbone),
            clip_dim=24, num_patches=8,
        )
    else:
        raise TypeError(type(cfg))
    return dataclasses.replace(
        spec, config=small, grad_accum={"smoke": 2}, skip={},
    )


def reduced_arch(arch_id: str) -> ArchSpec:
    return reduced(get_arch(arch_id))
