"""yi-34b [dense] — llama-arch GQA, arXiv:2403.04652.

60L, d_model=7168, 56 heads (GQA kv=8, head_dim=128), d_ff=20480,
vocab=64000.  The published widths of ``repro/configs/yi_34b.py``,
unchanged; ``attn_sp``/``sp_residuals`` are the reference's mesh
layout and have no effect on one device.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="yi-34b",
    family_name="transformer",
    config=TransformerConfig(
        layers=60,
        d_model=7168,
        heads=56,
        kv_heads=8,
        d_ff=20480,
        vocab=64000,
        head_dim=128,
        rope_theta=5_000_000.0,
        attn_sp=True,
        sp_residuals=True,
    ),
    rules={"heads": None},          # 56 % 16 != 0
    grad_accum={"train_4k": 1},
    skip={"long_500k": FULL_ATTN_SKIP},
)
