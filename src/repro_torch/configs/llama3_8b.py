"""llama3-8b [dense] — GQA + 128k vocab, arXiv:2407.21783.

32L, d_model=4096, 32 heads (GQA kv=8, head_dim=128), d_ff=14336,
vocab=128256, rope theta 5e5.  The published widths of
``repro/configs/llama3_8b.py``, unchanged; 8,030,261,248 parameters.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="llama3-8b",
    family_name="transformer",
    config=TransformerConfig(
        layers=32,
        d_model=4096,
        heads=32,
        kv_heads=8,
        d_ff=14336,
        vocab=128256,
        head_dim=128,
        rope_theta=500000.0,
    ),
    grad_accum={"train_4k": 4},
    skip={"long_500k": FULL_ATTN_SKIP},
)
