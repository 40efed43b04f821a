"""Port of ``repro/core/incore.py``: host f64 scalar maths, bit-identical.

ECM-style in-core runtime model (instruction-aware stage 4).

The paper's Eq. 4–7 chain treats compute as one aggregate latency/
throughput pair per class and memory as a single average-cost stream.
The execution-cache-memory (ECM) family of models ("Bridging the
Architecture Gap", the OSACA throughput paper — PAPERS.md) is finer:

* **in-core**: every instruction class (int / fp / div / load / store)
  is issued onto a *port group* with its own dependent-issue latency δ
  and per-port reciprocal throughput β.  Port groups run concurrently,
  so the in-core compute time is the busiest port group, not the sum.
* **data**: the load/store units move every reference through L1, and
  each cache-level boundary adds *non-overlapping* transfer cycles for
  the traffic that misses its way down — the ECM sum
  ``T_data = T_L1 + T_L1L2 + T_L2L3 + T_L3Mem``, with per-level traffic
  from the cumulative hit rates the SDCM stage predicts.
* **combine**: throughput mode overlaps compute with the data chain
  (``max``); latency mode serializes a dependent chain (δ per
  instruction, Eq. 6 per access).
* **multicore**: per-core work divides, but traffic through the shared
  levels (LLC and RAM) serializes chip-wide — runtime saturates at the
  shared-bandwidth term once enough cores are throwing traffic at it.

Per-class tables live on the targets (``hw.targets`` — paper Table 5
sources plus OSACA-style port counts); this module only consumes them,
so the hw→core import direction is preserved (``hw.targets`` imports
the table schema from here).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, ClassVar

from repro_torch.core.runtime_model import OpCounts, effective_latency_cy

if TYPE_CHECKING:  # break the hw<->core import cycle (annotations only)
    from repro_torch.hw.targets import CPUTarget


# --- per-class timing tables -------------------------------------------------


@dataclass(frozen=True)
class ClassTiming:
    """One instruction class on one port group.

    ``delta`` — dependent-issue latency (cycles); ``beta`` — reciprocal
    throughput of ONE port (cycles/instr); ``ports`` — how many ports
    serve the class concurrently.  Effective class throughput is
    ``beta / ports`` cycles per instruction.
    """

    delta: float
    beta: float
    ports: int = 1

    @property
    def beta_effective(self) -> float:
        return self.beta / max(self.ports, 1)


@dataclass(frozen=True)
class InCoreTimings:
    """Per-class table: field names match :class:`OpCounts` fields, so
    mixes zip against timings without a translation layer."""

    int_ops: ClassTiming
    fp_ops: ClassTiming
    div_ops: ClassTiming
    loads: ClassTiming
    stores: ClassTiming

    COMPUTE_CLASSES: ClassVar[tuple[str, ...]] = ("int_ops", "fp_ops", "div_ops")
    MEM_CLASSES: ClassVar[tuple[str, ...]] = ("loads", "stores")
    CLASSES: ClassVar[tuple[str, ...]] = COMPUTE_CLASSES + MEM_CLASSES

    def timing(self, cls: str) -> ClassTiming:
        return getattr(self, cls)


def timings_of(target) -> InCoreTimings:
    """The target's per-class table, or a 1-port table derived from its
    aggregate Eq. 4–7 parameters (load/store inherit the L1 δ/β) so ECM
    still runs on a target that predates the per-class tables."""
    inc = getattr(target, "incore", None)
    if inc is not None:
        return inc
    instr = getattr(target, "instr", None)
    if instr is None:
        raise ValueError(
            f"target {getattr(target, 'name', target)!r} has neither "
            "per-class 'incore' timings nor aggregate 'instr' timings — "
            "the ECM model cannot run on it"
        )
    l1_delta = float(target.level_latency_cy[0])
    l1_beta = float(target.level_beta_cy[0])
    return InCoreTimings(
        int_ops=ClassTiming(instr.delta_int, instr.beta_int),
        fp_ops=ClassTiming(instr.delta_fp, instr.beta_fp),
        div_ops=ClassTiming(instr.delta_div, instr.beta_div),
        loads=ClassTiming(l1_delta, l1_beta),
        stores=ClassTiming(l1_delta, l1_beta),
    )


# --- model pieces (all in cycles) --------------------------------------------


def t_comp_cy(timings: InCoreTimings, counts: OpCounts,
              mode: str = "throughput") -> float:
    """In-core compute cycles.

    ``throughput`` — port groups drain concurrently: the busiest one
    bounds (``max`` over classes of n·β/ports); ``latency`` — one
    serialized dependency chain (Σ n·δ).
    """
    if mode == "throughput":
        return max(
            getattr(counts, cls) * timings.timing(cls).beta_effective
            for cls in InCoreTimings.COMPUTE_CLASSES
        )
    if mode == "latency":
        return sum(
            getattr(counts, cls) * timings.timing(cls).delta
            for cls in InCoreTimings.COMPUTE_CLASSES
        )
    raise ValueError(f"unknown in-core mode: {mode}")


def t_lsu_cy(timings: InCoreTimings, counts: OpCounts) -> float:
    """Load/store-unit issue cycles — every reference occupies an L1
    port regardless of where it eventually hits."""
    return (counts.loads * timings.loads.beta_effective
            + counts.stores * timings.stores.beta_effective)


def miss_fractions(hit_rates: list[float]) -> list[float]:
    """Fraction of references still unresolved after each level, from
    the paper's *cumulative* hit-rate convention (Table 6 metric):
    ``1 - P_i``, clamped into [0, 1] and made monotone non-increasing
    so a non-monotone input cannot create traffic out of thin air."""
    out: list[float] = []
    reach = 1.0
    for p in hit_rates:
        reach = min(reach, max(0.0, 1.0 - p))
        out.append(reach)
    return out


def transfer_cy(target: CPUTarget, hit_rates: list[float],
                mem_ops: float) -> list[float]:
    """Non-overlapping inter-level transfer cycles, one entry per
    boundary: ``out[i]`` is the cycles moving the traffic that missed
    level i across the level-(i+1) port (the last entry is the RAM
    boundary), using the target's per-level β."""
    if len(hit_rates) != len(target.levels):
        raise ValueError(
            f"{len(hit_rates)} hit rates for {len(target.levels)} levels "
            f"of {target.name}"
        )
    betas = list(target.level_beta_cy[1:]) + [target.ram_beta_cy]
    return [
        mem_ops * m * b
        for m, b in zip(miss_fractions(hit_rates), betas)
    ]


def shared_transfer_cy(target: CPUTarget, hit_rates: list[float],
                       counts: OpCounts) -> float:
    """Chip-wide serialized cycles: transfers crossing into the shared
    levels (LLC and beyond) and RAM contend across *all* cores, so
    they are computed on the undivided counts."""
    shared_idx = getattr(target, "shared_level", -1) % len(target.levels)
    transfers = transfer_cy(target, hit_rates, counts.mem_ops)
    # transfers[i] crosses the level-(i+1) port; it contends once the
    # destination is the shared level or deeper (i + 1 >= shared_idx)
    return sum(t for i, t in enumerate(transfers) if i + 1 >= shared_idx)


def ecm_cycles(target: CPUTarget, hit_rates: list[float], counts: OpCounts,
               *, mode: str = "throughput") -> dict[str, float]:
    """Single-core ECM decomposition for one core's share of work.

    ``throughput``: ``T = max(T_comp, T_LSU + Σ T_transfer)`` — compute
    overlaps the data chain, the data chain's pieces do not overlap
    each other (the ECM non-overlap assumption).
    ``latency``: fully serialized — the δ chain for compute plus the
    Eq. 6 per-access latency for every reference.
    """
    timings = timings_of(target)
    comp = t_comp_cy(timings, counts, mode)
    if mode == "throughput":
        data = t_lsu_cy(timings, counts) + sum(
            transfer_cy(target, hit_rates, counts.mem_ops)
        )
        core = max(comp, data)
    else:
        if len(hit_rates) != len(target.levels):
            raise ValueError(
                f"{len(hit_rates)} hit rates for {len(target.levels)} "
                f"levels of {target.name}"
            )
        data = counts.mem_ops * effective_latency_cy(target, hit_rates)
        core = comp + data
    return {"t_comp_cy": comp, "t_data_cy": data, "t_core_cy": core}


# --- stage-4 model -----------------------------------------------------------


class ECMRuntimeModel:
    """Instruction-aware stage 4: the ECM decomposition above, scaled
    to ``cores`` with chip-wide shared-bandwidth saturation.

    Per-core runtime uses each core's 1/cores share of the mix; the
    prediction is ``max(per-core ECM time, shared-transfer time of the
    FULL traffic)`` — so adding cores helps until the shared levels'
    ports saturate, then the curve goes flat (the classic ECM multicore
    scaling shape, and the behaviour Eq. 4–7 cannot express).

    ``gap_bytes`` is accepted for stage-interface compatibility and
    ignored: spatial locality lives in the line-granular reuse profiles
    whose hit rates this model consumes, not in a post-hoc block
    correction.
    """

    name = "ecm"

    def runtime(self, target, hit_rates: dict[str, float], counts: OpCounts,
                cores: int, *, mode: str = "throughput",
                gap_bytes: float = 0.0) -> dict[str, float]:
        ordered = [hit_rates[lvl.name] for lvl in target.levels]
        share = counts.scaled(1.0 / max(cores, 1))
        cyc = ecm_cycles(target, ordered, share, mode=mode)
        sat = shared_transfer_cy(target, ordered, counts)
        total_cy = max(cyc["t_core_cy"], sat)
        cs = target.cycle_s
        return {
            "t_pred_s": total_cy * cs,
            "t_cpu_s": cyc["t_comp_cy"] * cs,
            "t_mem_s": cyc["t_data_cy"] * cs,
            "t_shared_bw_s": sat * cs,
            "bound": "bandwidth" if sat > cyc["t_core_cy"] else (
                "compute" if cyc["t_comp_cy"] >= cyc["t_data_cy"]
                else "data"
            ),
        }


__all__ = [
    "ClassTiming",
    "ECMRuntimeModel",
    "InCoreTimings",
    "ecm_cycles",
    "miss_fractions",
    "shared_transfer_cy",
    "t_comp_cy",
    "t_lsu_cy",
    "timings_of",
    "transfer_cy",
]
