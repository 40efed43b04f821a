"""Architecture registry of the port: ``get_arch("<id>")`` /
``--arch <id>`` for the ported families (``ssm``, ``hybrid``)."""
from repro_torch.configs.base import ArchSpec, Shape
from repro_torch.configs import mamba2_780m, zamba2_1_2b  # noqa: E402

REGISTRY: dict[str, ArchSpec] = {
    m.SPEC.arch_id: m.SPEC for m in (mamba2_780m, zamba2_1_2b)
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(
            f"unknown or unported arch {arch_id!r}; ported: "
            f"{sorted(REGISTRY)} (the rest: ROADMAP A-11)"
        )
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    return sorted(REGISTRY)


__all__ = ["ArchSpec", "Shape", "REGISTRY", "get_arch", "list_archs"]
