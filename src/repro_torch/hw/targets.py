"""Port of ``repro/hw/targets.py``: the same tables, field by field.

Hardware targets.

* The paper's three CPUs (Table 5) with latency/throughput parameters
  taken from vendor documentation, Agner Fog's instruction tables and
  7-cpu.com — same sources the paper cites (§4.2).  Values are modeling
  parameters, not measurements.
* TPU v5e-class chip (the adaptation target): peak bf16 FLOP/s, HBM
  bandwidth, ICI link bandwidth per the project brief, VMEM treated as a
  software-managed last-level "cache" for the reuse-profile model.
* A GPU-like SM target (``gpu-sm``): wide-throughput / high-latency
  per-class port tables with an HBM memory chain, addressed through
  the same CPUTarget interface so the whole pipeline (SDCM, exact LRU,
  every runtime model, ``repro.validate --targets gpu-sm``) treats it
  as just another hierarchy.

CPU targets additionally carry OSACA-style per-class ``incore`` port
tables (``repro_torch.core.incore.InCoreTimings``) feeding the ECM runtime
model; ``docs/runtime.md`` documents every table, and the port's tests
hold these tables equal to the reference's field by field.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.incore import ClassTiming, InCoreTimings
from repro_torch.core.levels import CacheLevelConfig


@dataclass(frozen=True)
class InstrTimings:
    """Per-class instruction latency δ (cycles) and reciprocal throughput β
    (cycles/instr) — paper §3.4.2 (T_CPU), sources: Agner Fog tables."""

    delta_int: float
    beta_int: float
    delta_fp: float
    beta_fp: float
    delta_div: float
    beta_div: float


@dataclass(frozen=True)
class CPUTarget:
    name: str
    microarch: str
    cores: int
    freq_hz: float
    levels: tuple[CacheLevelConfig, ...]
    # per-access latency δ (cycles) and reciprocal throughput β (cycles)
    # per level, ending with RAM — Eq. 6/7 inputs.
    level_latency_cy: tuple[float, ...]
    level_beta_cy: tuple[float, ...]
    ram_latency_cy: float
    ram_beta_cy: float
    instr: InstrTimings
    shared_level: int = -1  # index of the level shared across cores (LLC)
    word_bytes: int = 8
    # OSACA-style per-class port table for the ECM in-core model
    # (repro_torch.core.incore); None falls back to a 1-port table derived
    # from ``instr``.  Aggregate βs stay consistent by construction:
    # instr.beta_X == incore.X.beta / incore.X.ports.
    incore: InCoreTimings | None = None

    @property
    def cycle_s(self) -> float:
        return 1.0 / self.freq_hz


# --- Table 5 CPUs -----------------------------------------------------------

HASWELL_I7_5960X = CPUTarget(
    name="i7-5960X",
    microarch="haswell",
    cores=8,
    freq_hz=3.0e9,
    levels=(
        CacheLevelConfig("L1", 32 * 1024, 64, 8),
        CacheLevelConfig("L2", 256 * 1024, 64, 8),
        CacheLevelConfig("L3", 20 * 1024 * 1024, 64, 20),
    ),
    level_latency_cy=(4.0, 12.0, 36.0),
    level_beta_cy=(0.5, 3.0, 8.0),
    ram_latency_cy=240.0,
    ram_beta_cy=14.0,
    instr=InstrTimings(1.0, 0.25, 3.0, 0.5, 20.0, 8.0),
    # Haswell port model: 4 ALU ports (p0156), 2 FMA pipes (p01), one
    # radix div unit (p0), 2 load AGUs (p23), 1 store-data port (p4)
    incore=InCoreTimings(
        int_ops=ClassTiming(1.0, 1.0, 4),
        fp_ops=ClassTiming(3.0, 1.0, 2),
        div_ops=ClassTiming(20.0, 8.0, 1),
        loads=ClassTiming(4.0, 1.0, 2),
        stores=ClassTiming(4.0, 1.0, 1),
    ),
)

BROADWELL_E5_2699V4 = CPUTarget(
    name="Xeon E5-2699 v4",
    microarch="broadwell",
    cores=22,
    freq_hz=2.2e9,
    levels=(
        CacheLevelConfig("L1", 32 * 1024, 64, 8),
        CacheLevelConfig("L2", 256 * 1024, 64, 8),
        CacheLevelConfig("L3", 55 * 1024 * 1024, 64, 20),
    ),
    level_latency_cy=(4.0, 12.0, 50.0),
    level_beta_cy=(0.5, 3.0, 10.0),
    ram_latency_cy=200.0,
    ram_beta_cy=12.0,
    instr=InstrTimings(1.0, 0.25, 3.0, 0.5, 23.0, 10.0),
    # Broadwell keeps Haswell's port layout; the div unit is slower
    incore=InCoreTimings(
        int_ops=ClassTiming(1.0, 1.0, 4),
        fp_ops=ClassTiming(3.0, 1.0, 2),
        div_ops=ClassTiming(23.0, 10.0, 1),
        loads=ClassTiming(4.0, 1.0, 2),
        stores=ClassTiming(4.0, 1.0, 1),
    ),
)

ZEN2_EPYC_7702P = CPUTarget(
    name="EPYC 7702P",
    microarch="zen2",
    cores=64,
    freq_hz=2.0e9,
    levels=(
        # Table 5 lists chip-aggregate sizes (2MB/32MB/256MB over 64
        # cores); the per-core/CCX view used for simulation:
        CacheLevelConfig("L1", 32 * 1024, 64, 8),
        CacheLevelConfig("L2", 512 * 1024, 64, 8),
        CacheLevelConfig("L3", 16 * 1024 * 1024, 64, 16),
    ),
    level_latency_cy=(4.0, 12.0, 39.0),
    level_beta_cy=(0.5, 3.0, 9.0),
    ram_latency_cy=230.0,
    ram_beta_cy=13.0,
    instr=InstrTimings(1.0, 0.25, 3.0, 0.5, 13.0, 5.0),
    # Zen2: 4 ALUs, 2 FMA pipes (FP0/FP1), fast radix-4 divider,
    # 2 load + 1 store AGU ops per cycle
    incore=InCoreTimings(
        int_ops=ClassTiming(1.0, 1.0, 4),
        fp_ops=ClassTiming(3.0, 1.0, 2),
        div_ops=ClassTiming(13.0, 5.0, 1),
        loads=ClassTiming(4.0, 1.0, 2),
        stores=ClassTiming(4.0, 1.0, 1),
    ),
)

CPU_TARGETS = {
    t.name: t
    for t in (HASWELL_I7_5960X, BROADWELL_E5_2699V4, ZEN2_EPYC_7702P)
}


# --- GPU-like SM target (ECM adaptation; PPT-GPU-style abstraction) ---------
#
# One streaming multiprocessor modeled through the SAME CPUTarget
# interface: "cores" are SMs, the per-SM L1/shared-memory level is
# private, the chip L2 is the shared level, and the RAM terms model the
# HBM chain.  The in-core table carries the GPU signature: very WIDE
# throughput (32-lane port groups, β_eff « 1 cy/op) at HIGH
# dependent-issue latency (δ_int/fp ≈ 4–8 cy, SFU ≈ 16 cy) — the
# opposite corner of the (δ, β) plane from the CPUs, which is exactly
# what makes it a useful stress target for the ECM vs Eq. 4–7 split.

GPU_SM90_LIKE = CPUTarget(
    name="gpu-sm",
    microarch="sm90-like",
    cores=108,                       # SMs ("cores" in a grid request)
    freq_hz=1.4e9,
    levels=(
        # per-SM L1/shared-memory carveout; chip-wide L2
        CacheLevelConfig("L1", 128 * 1024, 128, 64),
        CacheLevelConfig("L2", 40 * 1024 * 1024, 128, 16),
    ),
    level_latency_cy=(28.0, 200.0),
    level_beta_cy=(0.25, 2.0),
    ram_latency_cy=480.0,            # HBM round trip
    ram_beta_cy=4.0,                 # HBM chain: wide but contended
    instr=InstrTimings(4.0, 0.03125, 4.0, 0.03125, 16.0, 0.0625),
    shared_level=1,
    word_bytes=4,
    incore=InCoreTimings(
        int_ops=ClassTiming(4.0, 1.0, 32),
        fp_ops=ClassTiming(4.0, 1.0, 32),
        div_ops=ClassTiming(16.0, 1.0, 16),   # SFU quad-pumped lanes
        loads=ClassTiming(28.0, 1.0, 4),      # LSU: 4 accesses/cy/SM
        stores=ClassTiming(28.0, 1.0, 4),
    ),
)


# --- TPU target (adaptation; constants from the project brief) --------------

@dataclass(frozen=True)
class TPUTarget:
    """TPU chip modeled through the SAME cache-hierarchy interface as
    the CPUs: ``levels``/``shared_level``/``cores`` make it a drop-in
    target for the ``repro_torch.api`` pipeline (VMEM = one fully-associative
    shared level), so there is no separate TPU prediction code path.
    """

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # per chip
    hbm_bandwidth: float = 819e9         # bytes/s per chip
    ici_bandwidth: float = 50e9          # bytes/s per link
    hbm_bytes: int = 16 * 1024**3
    vmem_bytes: int = 128 * 1024**2      # software-managed on-chip memory
    vmem_line: int = 512                 # modeling granule for reuse analysis
    chips_per_pod: int = 256
    # latency terms for the Eq.6-style chain (seconds)
    vmem_latency_s: float = 10e-9
    hbm_latency_s: float = 500e-9
    ici_latency_s: float = 1e-6
    host_bandwidth: float = 25e9
    shared_level: int = 0                # VMEM is shared by all compute units

    def vmem_cache_config(self) -> CacheLevelConfig:
        # VMEM modeled as a fully-associative "cache" over 512B granules:
        # with A == B the SDCM rule degenerates to the exact LRU stack
        # rule, matching a perfectly-managed scratchpad.
        n = self.vmem_bytes // self.vmem_line
        return CacheLevelConfig("VMEM", self.vmem_bytes, self.vmem_line, n)

    @property
    def levels(self) -> tuple[CacheLevelConfig, ...]:
        return (self.vmem_cache_config(),)

    @property
    def cores(self) -> int:
        # "core count" in a grid request maps to chips for this target
        return self.chips_per_pod


TPU_V5E = TPUTarget()

# Unified registry: every target the prediction API can address by name.
ALL_TARGETS: dict[str, CPUTarget | TPUTarget] = {
    **CPU_TARGETS,
    GPU_SM90_LIKE.name: GPU_SM90_LIKE,
    TPU_V5E.name: TPU_V5E,
}


def resolve_target(target):
    """Accept a target object or its registry name."""
    if isinstance(target, str):
        try:
            return ALL_TARGETS[target]
        except KeyError:
            raise KeyError(
                f"unknown target {target!r}; known: {sorted(ALL_TARGETS)}"
            ) from None
    return target
