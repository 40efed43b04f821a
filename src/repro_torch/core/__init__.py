"""Port of ``repro/core``: the paper's pipeline (Fig. 1) — labeled trace
-> mimicked private traces (Alg. 1) -> interleaved shared trace
(Alg. 2) -> PRD/CRD reuse profiles -> SDCM hit rates (Eq. 1-3) ->
analytical runtime (Eq. 4-7)."""
