"""moe_gemm_roofline.prefill: the MoE layer's grouped expert GEMMs in
prefill (gate/up and down), the least time of the window's expert
products (6 d f a (token, expert) pair; ``counts.expert_flops``) over
the device time of every ``grouped_gemm_kernel``, percent."""
from portbench import readers


def read(ctx):
    return readers.roofline(ctx, readers.MOE_GEMM, "expert", backward=False)
