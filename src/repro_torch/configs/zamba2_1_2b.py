"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block,
arXiv:2411.15242.

38 Mamba2 layers, d_model=2048 (d_inner=4096, 64 SSD heads of P=64),
ssm_state=64, shared attn block (32H, kv=32, head_dim=64, d_ff=8192)
applied every 6 layers on concat(hidden, embedding).  The published
widths of ``repro/configs/zamba2_1_2b.py``, unchanged.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.hybrid import Zamba2Config

SPEC = ArchSpec(
    arch_id="zamba2-1.2b",
    family_name="hybrid",
    config=Zamba2Config(
        layers=38,
        d_model=2048,
        vocab=32000,
        heads=32,
        kv_heads=32,
        d_ff=8192,
        ssm_state=64,
        head_dim=64,
        attn_every=6,
    ),
    # the reference's mesh-axis name "tp" matches no mesh axis, so these
    # replicate (ROADMAP C10)
    rules={"kv_heads": "tp", "act_kv_heads": "tp", "act_kv_seq": None},
    grad_accum={"train_4k": 8},
)
