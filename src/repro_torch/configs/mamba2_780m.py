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
    grad_accum={"train_4k": 1},
    notes="the SSD chunked scan (kernel B5) is the hot spot of its prefill",
)
