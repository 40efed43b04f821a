"""Architecture registry of the port: ``get_arch("<id>")`` /
``--arch <id>``, every architecture of the reference's registry
(families ``transformer``, ``ssm``, ``hybrid``, ``encdec``, ``vlm``)."""
from repro_torch.configs.base import (
    ArchSpec, Shape, SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)
from repro_torch.configs import (  # noqa: E402
    arctic_480b,
    codeqwen15_7b,
    deepseek_67b,
    llama3_8b,
    mamba2_780m,
    mixtral_8x7b,
    phi3_vision_4_2b,
    seamless_m4t_medium,
    yi_34b,
    zamba2_1_2b,
)

REGISTRY: dict[str, ArchSpec] = {
    m.SPEC.arch_id: m.SPEC
    for m in (
        mamba2_780m, yi_34b, deepseek_67b, llama3_8b, codeqwen15_7b,
        arctic_480b, mixtral_8x7b, seamless_m4t_medium, phi3_vision_4_2b,
        zamba2_1_2b,
    )
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}"
        )
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = [
    "ArchSpec", "Shape", "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "REGISTRY", "get_arch", "list_archs",
]
