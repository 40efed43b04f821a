"""deepseek-67b [dense] — llama-arch, arXiv:2401.02954.

95L, d_model=8192, 64 heads (GQA kv=8, head_dim=128), d_ff=22016,
vocab=102400.  The published widths of ``repro/configs/deepseek_67b.py``,
unchanged.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="deepseek-67b",
    family_name="transformer",
    config=TransformerConfig(
        layers=95,
        d_model=8192,
        heads=64,
        kv_heads=8,
        d_ff=22016,
        vocab=102400,
        head_dim=128,
        rope_theta=10000.0,
        sp_residuals=True,
    ),
    grad_accum={"train_4k": 1},
    skip={"long_500k": FULL_ATTN_SKIP},
)
