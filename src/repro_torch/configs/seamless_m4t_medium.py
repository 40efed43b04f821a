"""seamless-m4t-medium [audio] — enc-dec multimodal backbone,
arXiv:2308.11596.

12L encoder + 12L decoder, d_model=1024, 16 heads (MHA kv=16,
head_dim=64), d_ff=4096, vocab=256206 (padded to 256256).  The published
widths of ``repro/configs/seamless_m4t_medium.py``, unchanged;
977,860,608 parameters.  The audio frontend is a stub: the encoder takes
precomputed frame embeddings.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.encdec import EncDecConfig

SPEC = ArchSpec(
    arch_id="seamless-m4t-medium",
    family_name="encdec",
    config=EncDecConfig(
        enc_layers=12,
        dec_layers=12,
        d_model=1024,
        heads=16,
        kv_heads=16,
        d_ff=4096,
        vocab=256206,
        head_dim=64,
    ),
    # the reference's mesh-axis name "tp" matches no mesh axis, so these
    # replicate (ROADMAP C10)
    rules={"kv_heads": "tp", "act_kv_heads": "tp", "act_kv_seq": None},
    grad_accum={"train_4k": 1},
    flops_token_factor=0.5,  # src/tgt halves each traverse half the stack
    skip={"long_500k": FULL_ATTN_SKIP},
)
