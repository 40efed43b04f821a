"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (a
stub), hf:microsoft/Phi-3-vision-128k-instruct.

32L, d_model=3072, 32 heads (MHA kv=32, head_dim=96), d_ff=8192,
vocab=32064; 1024 patches of clip_dim=1024 projected ahead of the text.
The published widths of ``repro/configs/phi3_vision_4_2b.py``,
unchanged; 3,824,618,496 parameters.
"""
from repro_torch.configs.base import FULL_ATTN_SKIP, ArchSpec
from repro_torch.models.multimodal import VLMConfig
from repro_torch.models.transformer import TransformerConfig

SPEC = ArchSpec(
    arch_id="phi-3-vision-4.2b",
    family_name="vlm",
    config=VLMConfig(
        backbone=TransformerConfig(
            layers=32,
            d_model=3072,
            heads=32,
            kv_heads=32,
            d_ff=8192,
            vocab=32064,
            head_dim=96,
            rope_theta=10000.0,
        ),
        clip_dim=1024,
        num_patches=1024,
    ),
    # the reference's mesh-axis name "tp" matches no mesh axis, so these
    # replicate (ROADMAP C10)
    rules={"kv_heads": "tp", "act_kv_heads": "tp", "act_kv_seq": None},
    grad_accum={"train_4k": 4},
    skip={"long_500k": FULL_ATTN_SKIP},
)
