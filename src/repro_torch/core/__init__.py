"""Port of ``repro/core``: the paper's pipeline (Fig. 1) — labeled trace
-> mimicked private traces (Alg. 1) -> interleaved shared trace
(Alg. 2) -> PRD/CRD reuse profiles -> SDCM hit rates (Eq. 1-3) ->
analytical runtime (Eq. 4-7).

Re-exports resolve lazily (PEP 562), as in the reference:
``repro_torch.hw.targets`` imports the leaf ``core.levels``, and an
eager predictor import here would close an hw <-> core cycle.  The
reference's ``phit_given_d`` (its jitted SDCM) has no counterpart: the
port's SDCM runs in ``kernels/sdcm``.
"""
from __future__ import annotations

_EXPORTS = {
    "PPTMulticorePredictor": "repro_torch.core.predictor",
    "Prediction": "repro_torch.core.predictor",
    "OpCounts": "repro_torch.core.runtime_model",
    "predict_runtime_s": "repro_torch.core.runtime_model",
    "hit_rate": "repro_torch.core.sdcm",
    "phit_given_d_np": "repro_torch.core.sdcm",
    "CacheLevelConfig": "repro_torch.core.levels",
    "LevelResult": "repro_torch.core.levels",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(
        f"module 'repro_torch.core' has no attribute {name!r}")
