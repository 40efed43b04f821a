"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP,
hf:Snowflake/snowflake-arctic-base.

35L, d_model=7168, 56 heads (GQA kv=8), per-expert d_ff=4864,
vocab=32000.  The published widths of ``repro/configs/arctic_480b.py``,
unchanged, with its training knobs (Adafactor and bf16 gradient
accumulators) and the reference's sharding rules.
"""
import torch

from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="arctic-480b",
    family_name="transformer",
    config=TransformerConfig(
        layers=35,
        d_model=7168,
        heads=56,
        kv_heads=8,
        d_ff=4864,
        vocab=32000,
        head_dim=128,
        attn_sp=True,
        sp_residuals=True,
        moe=MoEConfig(num_experts=128, top_k=2, tokens_per_group=1024),
        dense_ff=True,          # arctic's dense residual MLP branch
    ),
    rules={"heads": None, "mlp": None, "act_mlp": None},
    # "dp" matches no mesh axis: the embedding replicates (ROADMAP C10)
    serve_rules={"embed": "dp"},
    grad_accum={"train_4k": 1},
    accum_dtype=torch.bfloat16,
    optimizer_name="adafactor",
    skip={"long_500k": FULL_ATTN_SKIP},
    notes="most-collective-bound hillclimb candidate: EP all-to-all + "
          "FSDP gathers",
)
