from .flash_attention import (
    HEAD_DIMS,
    LAUNCHES,
    flash_attention,
    flash_attention_plain,
)

__all__ = ["HEAD_DIMS", "LAUNCHES", "flash_attention", "flash_attention_plain"]
