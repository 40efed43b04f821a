"""mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060.

48L, d_model=1536 (d_inner=3072, 48 SSD heads of P=64), ssm_state=128,
vocab=50280, attention-free.  The published widths of
``repro/configs/mamba2_780m.py``, unchanged.
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.ssm import Mamba2Config

SPEC = ArchSpec(
    arch_id="mamba2-780m",
    family_name="ssm",
    config=Mamba2Config(
        layers=48,
        d_model=1536,
        vocab=50280,
        ssm_state=128,
        head_dim=64,
    ),
    # the reference's mesh-axis names "dp", "tp" and "dp+tp" match no
    # mesh axis, so each of these overrides replicates (ROADMAP C10)
    rules={
        "act_batch": "dp+tp", "inner": None, "conv_dim": None,
        "ssm_heads": None, "act_mlp": None, "act_heads": None,
        "vocab": None, "act_vocab": None, "embed": None,
    },
    opt_rules={"embed": "dp+tp"},
    serve_rules={
        "act_batch": "dp", "inner": "tp", "conv_dim": "tp",
        "ssm_heads": "tp", "act_mlp": "tp", "act_heads": "tp",
        "vocab": "tp", "act_vocab": "tp", "embed": "dp",
    },
    grad_accum={"train_4k": 1},
    notes="the SSD chunked scan (kernel B5) is the hot spot of its prefill",
)
