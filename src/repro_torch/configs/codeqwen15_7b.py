"""codeqwen1.5-7b [dense] — qwen1.5-arch, hf:Qwen/CodeQwen1.5-7B.

32L, d_model=4096, 32 heads (kv=32 — full MHA KV), d_ff=13440,
vocab=92416.  The published widths of ``repro/configs/codeqwen15_7b.py``,
unchanged, with the reference's sharding rules.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="codeqwen1.5-7b",
    family_name="transformer",
    config=TransformerConfig(
        layers=32,
        d_model=4096,
        heads=32,
        kv_heads=32,
        d_ff=13440,
        vocab=92416,
        head_dim=128,
        rope_theta=1_000_000.0,
    ),
    # the reference's mesh-axis name "tp" matches no mesh axis, so these
    # replicate (ROADMAP C10)
    rules={"kv_heads": "tp", "act_kv_heads": "tp", "act_kv_seq": None},
    grad_accum={"train_4k": 4},
    skip={"long_500k": FULL_ATTN_SKIP},
)
