"""mixtral-8x7b [moe] — 8 experts top-2 + sliding-window attention,
arXiv:2401.04088.

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=14336,
vocab=32000, window=4096.  The published widths of
``repro/configs/mixtral_8x7b.py``, unchanged; the window runs inside
kernel B4.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="mixtral-8x7b",
    family_name="transformer",
    config=TransformerConfig(
        layers=32,
        d_model=4096,
        heads=32,
        kv_heads=8,
        d_ff=14336,
        vocab=32000,
        head_dim=128,
        rope_theta=1_000_000.0,
        window=4096,
        moe=MoEConfig(num_experts=8, top_k=2, tokens_per_group=4096),
        dense_ff=False,
    ),
    rules={"experts": None},   # 8 % 16 != 0 -> TP-MoE over the FFN dim
    grad_accum={"train_4k": 4},
)
