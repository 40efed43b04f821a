from .flash_attention import (
    HEAD_DIMS,
    LAUNCHES,
    LAUNCHES_BY_BWD_FORM,
    LAUNCHES_BY_FORM,
    SPLIT_COLUMNS,
    SPLIT_MAX_ROWS,
    TC_HEAD_DIMS,
    attention_bwd_ops,
    attention_ops,
    backward_form,
    flash_attention,
    flash_attention_bwd,
    flash_attention_plain,
    kernel_form,
    split_kv_plain,
    split_range,
)

__all__ = ["HEAD_DIMS", "LAUNCHES", "LAUNCHES_BY_BWD_FORM", "LAUNCHES_BY_FORM",
           "SPLIT_COLUMNS", "SPLIT_MAX_ROWS", "TC_HEAD_DIMS",
           "attention_bwd_ops", "attention_ops", "backward_form",
           "flash_attention", "flash_attention_bwd", "flash_attention_plain",
           "kernel_form", "split_kv_plain", "split_range"]
