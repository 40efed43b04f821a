"""Three-term roofline from the dry-run artifacts (EXPERIMENTS.md §Roofline);
port of ``repro/analysis/roofline.py``.

    compute_s    = HLO_FLOPs_per_chip / peak_FLOP/s
    memory_s     = HLO_bytes_per_chip / HBM_bw
    collective_s = ici_bytes_per_chip / link_bw

(cost_analysis of the SPMD executable is already per-partition —
probe-verified — so the brief's "global / chips" form is identical.)

The step-time lower bound is max(terms) (perfect overlap); the roofline
fraction reported in §Perf is useful model FLOPs over that bound:

    fraction = (MODEL_FLOPS / chips / peak) / max(terms)

MODEL_FLOPS uses 6·N_active·tokens for training and 2·N_active·tokens
for inference (fwd-only), the standard accounting.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.hw.targets import TPU_V5E, TPUTarget


@dataclass(frozen=True)
class Roofline:
    arch: str
    shape: str
    mesh: str
    kind: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_chip: float       # useful FLOPs per chip per step
    hlo_flops_chip: float
    chips: int
    useful_bytes_chip: float = 0.0  # args (params+caches) read once/step

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def t_step_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_compute_s(self) -> float:
        return self.model_flops_chip / TPU_V5E.peak_flops_bf16

    @property
    def roofline_fraction(self) -> float:
        b = self.t_step_bound_s
        return self.useful_compute_s / b if b else 0.0

    @property
    def flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — how much compiled compute is useful
        (catches remat/redundancy/padding waste)."""
        return (self.model_flops_chip / self.hlo_flops_chip
                if self.hlo_flops_chip else 0.0)

    @property
    def memory_fraction(self) -> float:
        """For memory-bound kinds (decode): ideal-stream fraction — the
        time to read params+caches once over the achieved bound.  The
        compute-centric roofline_fraction is ~0 for decode by design;
        this is the bandwidth-utilization analog."""
        if not self.useful_bytes_chip:
            return 0.0
        ideal = self.useful_bytes_chip / TPU_V5E.hbm_bandwidth
        b = self.t_step_bound_s
        return ideal / b if b else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "kind": self.kind,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "t_step_bound_s": self.t_step_bound_s,
            "roofline_fraction": self.roofline_fraction,
            "flops_ratio": self.flops_ratio,
        }


def model_flops(kind: str, active_params: int, seq_len: int,
                global_batch: int) -> float:
    if kind == "train":
        tokens = seq_len * global_batch
        return 6.0 * active_params * tokens
    if kind == "prefill":
        tokens = seq_len * global_batch
        return 2.0 * active_params * tokens
    # decode: one token per sequence
    return 2.0 * active_params * global_batch


def from_record(rec: dict, target: TPUTarget = TPU_V5E) -> Roofline:
    """Build roofline terms from one launch/dryrun JSON record: its cost
    and collectives are one partition's, over ``devices`` chips (the
    port's records: 1 on the ``host`` mesh, 256 or 512 on the pods;
    the reference's records, which have no ``devices``, by mesh name).
    A record with ``partitioned: false`` (a sharding plan, no per-chip
    cost: ROADMAP C12) raises."""
    from repro_torch.configs import SHAPES

    if rec.get("partitioned") is False:
        raise ValueError(
            f"{rec['arch']} x {rec['shape']} x {rec['mesh']}: an "
            "unpartitioned dry-run record (a sharding plan) has no per-chip "
            "cost (ROADMAP C12)")
    shape = SHAPES[rec["shape"]]
    chips = rec.get("devices") or {"multipod": 512, "host": 1}.get(
        rec["mesh"], 256)
    flops = float(rec["cost"].get("flops", 0.0))
    bytes_acc = float(rec["cost"].get("bytes accessed", 0.0))
    ici = float(rec["collectives"]["ici_bytes"])
    mf = model_flops(rec["kind"], rec["active_param_count"],
                     shape.seq_len, shape.global_batch) / chips
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        kind=rec["kind"],
        compute_s=flops / target.peak_flops_bf16,
        memory_s=bytes_acc / target.hbm_bandwidth,
        collective_s=ici / target.ici_bandwidth,
        model_flops_chip=mf,
        hlo_flops_chip=flops,
        chips=chips,
    )


def format_table(rows: list[Roofline]) -> str:
    hdr = (f"{'arch':<20} {'shape':<12} {'mesh':<9} {'bound':<11} "
           f"{'compute_s':>10} {'memory_s':>10} {'collect_s':>10} "
           f"{'t_bound_s':>10} {'roofl%':>7} {'useful%':>8} {'membw%':>7}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<20} {r.shape:<12} {r.mesh:<9} {r.bottleneck:<11} "
            f"{r.compute_s:>10.4g} {r.memory_s:>10.4g} "
            f"{r.collective_s:>10.4g} {r.t_step_bound_s:>10.4g} "
            f"{100 * r.roofline_fraction:>6.1f}% "
            f"{100 * r.flops_ratio:>7.1f}% "
            f"{100 * r.memory_fraction:>6.1f}%"
        )
    return "\n".join(lines)
