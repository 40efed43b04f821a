from repro_torch.hw.targets import (
    ALL_TARGETS,
    BROADWELL_E5_2699V4,
    CPU_TARGETS,
    HASWELL_I7_5960X,
    TPU_V5E,
    CPUTarget,
    TPUTarget,
    ZEN2_EPYC_7702P,
    resolve_target,
)

__all__ = [
    "ALL_TARGETS",
    "BROADWELL_E5_2699V4",
    "CPU_TARGETS",
    "HASWELL_I7_5960X",
    "TPU_V5E",
    "CPUTarget",
    "TPUTarget",
    "ZEN2_EPYC_7702P",
    "resolve_target",
]
