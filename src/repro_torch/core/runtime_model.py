"""Port of ``repro/core/runtime_model.py``: host f64 scalar maths, bit-identical.

Analytical runtime prediction — paper §3.4 (Eq. 4–7).

    T_pred = T_mem + T_cpu                                        (Eq. 4)
    T_mem  = (δ_avg + (b-1)·β_avg)/b · total_mem                  (Eq. 5)
    δ_avg  = P1·δ1 + (1-P1)[P2·δ2 + (1-P2)[P3·δ3 + (1-P3)·δRAM]]  (Eq. 6)
    β_avg  = same chain over reciprocal throughputs               (Eq. 7)

plus the §3.4.2 non-contiguous block-size correction and the two-mode
(latency-bound vs throughput-bound) T_CPU.  Counts are divided across
cores (the paper's Fig. 7 tasklist divides ALU ops by core count).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # break the hw<->core import cycle (annotations only)
    from repro_torch.hw.targets import CPUTarget, InstrTimings


@dataclass(frozen=True)
class OpCounts:
    """Byfl-style operation counts for a kernel (paper §3.4)."""

    int_ops: float = 0.0
    fp_ops: float = 0.0
    div_ops: float = 0.0
    loads: float = 0.0
    stores: float = 0.0
    total_bytes: float = 0.0  # total memory footprint touched (bytes)

    @property
    def mem_ops(self) -> float:
        return self.loads + self.stores

    def scaled(self, f: float) -> "OpCounts":
        return OpCounts(
            self.int_ops * f,
            self.fp_ops * f,
            self.div_ops * f,
            self.loads * f,
            self.stores * f,
            self.total_bytes * f,
        )


def level_chain(values: list[float], hit_rates: list[float], final: float) -> float:
    """The Eq. 6/7 chain:  Σ over levels of P_i·v_i weighted by upstream
    misses, terminating in the RAM/final term.

    ``values`` and ``hit_rates`` must be per-level parallel lists: a
    2-level rate list against a 3-level cost list would silently drop
    the deepest level under ``zip`` truncation, so a length mismatch is
    an error, not a shorter chain.
    """
    if len(values) != len(hit_rates):
        raise ValueError(
            f"level_chain needs one hit rate per level: got "
            f"{len(hit_rates)} rates for {len(values)} levels"
        )
    acc = final
    for p, v in zip(reversed(hit_rates), reversed(values)):
        acc = p * v + (1.0 - p) * acc
    return acc


def effective_latency_cy(target: CPUTarget, hit_rates: list[float]) -> float:
    """δ_avg (Eq. 6), in cycles."""
    return level_chain(list(target.level_latency_cy), hit_rates, target.ram_latency_cy)


def effective_beta_cy(target: CPUTarget, hit_rates: list[float]) -> float:
    """β_avg (Eq. 7), in cycles."""
    return level_chain(list(target.level_beta_cy), hit_rates, target.ram_beta_cy)


def cumulative_to_conditional(hit_rates: list[float]) -> list[float]:
    """Convert the paper's cumulative per-level hit rates (Table 6
    metric) into conditional (given upstream miss) rates for the chain.
    The paper plugs cumulative rates into Eq. 6 directly; the conversion
    is offered because the conditional chain is the textbook AMAT form —
    benchmarks report both."""
    cond = []
    miss_prob = 1.0
    for p_cum in hit_rates:
        served_here = max(0.0, p_cum - (1.0 - miss_prob))
        cond.append(min(1.0, served_here / miss_prob) if miss_prob > 1e-12 else 1.0)
        miss_prob = max(0.0, 1.0 - p_cum)
    return cond


def noncontiguous_block_size(
    b_new: float, transfer_chunk: float, max_block: float
) -> float:
    """§3.4.2 block-size clamping: gaps inflate the block, transfers
    quantize to the chunk C, and blocks cap at S.

    The cap applies AFTER quantization: when C does not divide S, the
    ceil-to-chunk of a block just under the cap overshoots it (e.g.
    C=64, S=100, b_new=99 -> 128), and S is the hardware's hard limit.
    """
    if b_new <= transfer_chunk:
        return transfer_chunk
    if b_new >= max_block:
        return max_block
    import math

    return min(math.ceil(b_new / transfer_chunk) * transfer_chunk, max_block)


def t_mem_s(
    target: CPUTarget,
    hit_rates: list[float],
    total_bytes: float,
    *,
    block_bytes: float | None = None,
    gap_bytes: float = 0.0,
    transfer_chunk: float | None = None,
    max_block: float | None = None,
    conditional_chain: bool = False,
) -> float:
    """T_mem (Eq. 5), seconds.  ``gap_bytes > 0`` engages the
    non-contiguous model of §3.4.2."""
    rates = cumulative_to_conditional(hit_rates) if conditional_chain else hit_rates
    delta = effective_latency_cy(target, rates)
    beta = effective_beta_cy(target, rates)
    b = float(block_bytes if block_bytes is not None else target.word_bytes)
    if gap_bytes > 0.0:
        chunk = float(transfer_chunk if transfer_chunk is not None else target.levels[0].line_size)
        cap = float(max_block if max_block is not None else target.levels[-1].line_size * 64)
        b = noncontiguous_block_size(b + gap_bytes, chunk, cap)
    per_byte_cy = (delta + (b - 1.0) * beta) / b
    return per_byte_cy * total_bytes * target.cycle_s


def t_cpu_s(target: CPUTarget, counts: OpCounts, mode: str = "throughput") -> float:
    """T_CPU (§3.4.2), seconds, for the per-core share of `counts`.

    ``throughput`` — pipelined issue: one latency then β per instr;
    ``latency``    — serialized dependent chain: δ per instr.
    """
    t = target.instr
    classes = [
        (counts.int_ops, t.delta_int, t.beta_int),
        (counts.fp_ops, t.delta_fp, t.beta_fp),
        (counts.div_ops, t.delta_div, t.beta_div),
    ]
    cy = 0.0
    for n, delta, beta in classes:
        if n <= 0:
            continue
        if mode == "throughput":
            cy += delta + max(n - 1.0, 0.0) * beta
        elif mode == "latency":
            cy += n * delta
        else:
            raise ValueError(f"unknown T_CPU mode: {mode}")
    return cy * target.cycle_s


def predict_runtime_s(
    target: CPUTarget,
    hit_rates: list[float],
    counts: OpCounts,
    num_cores: int,
    *,
    mode: str = "throughput",
    gap_bytes: float = 0.0,
    conditional_chain: bool = False,
) -> dict:
    """T_pred (Eq. 4) for the parallel section on ``num_cores`` cores.

    Work (ops and bytes) is divided evenly across cores, the paper's
    assumption ("we assume that the total workload is distributed among
    multiple cores evenly") — which also reproduces its known failure
    mode on non-scaling apps (§4.2, jacobi).
    """
    share = counts.scaled(1.0 / max(num_cores, 1))
    tm = t_mem_s(
        target,
        hit_rates,
        share.total_bytes,
        gap_bytes=gap_bytes,
        conditional_chain=conditional_chain,
    )
    tc = t_cpu_s(target, share, mode=mode)
    return {"t_pred_s": tm + tc, "t_mem_s": tm, "t_cpu_s": tc}
