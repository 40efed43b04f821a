from .moe import (
    LAUNCHES, MAX_EXPERTS, MAX_K, combine, combine_plain, dispatch,
    dispatch_plain, experts, experts_plain, gemm_ops, grouped_down,
    grouped_down_plain, grouped_swiglu, grouped_swiglu_plain, supports,
)

__all__ = ["LAUNCHES", "MAX_EXPERTS", "MAX_K", "combine", "combine_plain",
           "dispatch", "dispatch_plain", "experts", "experts_plain",
           "gemm_ops", "grouped_down", "grouped_down_plain",
           "grouped_swiglu", "grouped_swiglu_plain", "supports"]
