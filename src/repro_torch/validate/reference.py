"""Paper reference data for the validation harness (machine-readable;
port of ``repro/validate/reference.py``, a copy of its own).

Encodes, as plain data:

* the paper's headline validation claims — 1.23% average absolute
  cache-hit-rate error and 9.08% average runtime error (abstract, §4) —
  broken down per modeled architecture as reported by the Tables 6–8 /
  Figs. 8–10 validation matrix;
* the Table 4 benchmark roster (full names, suite, domain, and the
  paper's standard input sizes) keyed by the ``MAKERS`` abbreviations
  used across this repo;
* the paper's known weak spots (workload × level cells the paper itself
  calls out as high-error).

Measurement convention: the paper validates predicted hit rates against
PAPI hardware counters and predicted runtimes against wall-clock runs.
This container has neither, so the reproduction's "measured" side is
the exact set-associative LRU simulation of the same mimicked traces
(``repro_torch.api.stages.ExactLRU`` — the PAPI stand-in) and the
Eq. 4–7 chain evaluated with those
exact rates.  Input sizes are scaled down (the paper's traces run
7–335 GB); absolute hit rates therefore differ from the paper's tables,
and the comparison that carries over is the *error statistic*: our
SDCM-vs-exact error per cell, aggregated per architecture, against the
paper's claimed per-architecture averages below.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PaperClaim:
    """One architecture's claimed average errors (percent)."""

    hit_rate_err_pct: float
    runtime_err_pct: float
    source: str  # which paper table/figure the figure is transcribed from


# Abstract / §4 headline aggregates.
PAPER_OVERALL = PaperClaim(1.23, 9.08, "abstract; §4.3–4.4 aggregate")

# Per-architecture averages of the paper's validation matrix
# (hit rates: Tables 6–8; runtimes: Figs. 8–10).  Keyed by the target
# registry names in ``repro_torch.hw.targets.CPU_TARGETS``.
PAPER_ARCH_CLAIMS: dict[str, PaperClaim] = {
    "i7-5960X": PaperClaim(1.20, 8.42, "Table 6 / Fig. 8 (Haswell)"),
    "Xeon E5-2699 v4": PaperClaim(1.30, 9.85, "Table 7 / Fig. 9 (Broadwell)"),
    "EPYC 7702P": PaperClaim(1.19, 8.98, "Table 8 / Fig. 10 (Zen2)"),
}


@dataclass(frozen=True)
class WorkloadRef:
    """Table 4 roster entry for one benchmark."""

    abbr: str
    name: str
    suite: str
    domain: str
    paper_input: str  # the standard input the paper traced


# The paper's benchmark roster (Table 4), keyed by the MAKERS
# abbreviation used by ``repro_torch.workloads.polybench``.
PAPER_TABLE4: dict[str, WorkloadRef] = {
    "adi": WorkloadRef("adi", "ADI", "PolyBench", "Stencils",
                       "N=1024, TSTEPS=10"),
    "atx": WorkloadRef("atx", "ATAX", "PolyBench", "Linear Algebra",
                       "N=4000"),
    "bcg": WorkloadRef("bcg", "BICG", "PolyBench", "Linear Algebra",
                       "N=4000"),
    "blk": WorkloadRef("blk", "Blackscholes", "PARSEC", "RMS",
                       "native input, 100 runs"),
    "c2d": WorkloadRef("c2d", "Convolution-2D", "PolyBench", "Stencils",
                       "N=4096"),
    "cov": WorkloadRef("cov", "Covariance", "PolyBench", "Datamining",
                       "N=1000"),
    "dgn": WorkloadRef("dgn", "Doitgen", "PolyBench", "Linear Algebra",
                       "NQ=NR=NP=128"),
    "dbn": WorkloadRef("dbn", "Durbin", "PolyBench", "Linear Algebra",
                       "N=4000"),
    "grm": WorkloadRef("grm", "Gramschmidt", "PolyBench", "Linear Algebra",
                       "N=512"),
    "jcb": WorkloadRef("jcb", "Jacobi-2D", "PolyBench", "Stencils",
                       "N=1024, TSTEPS=10"),
    "lu": WorkloadRef("lu", "LU", "PolyBench", "Linear Algebra",
                      "N=1024"),
    "2mm": WorkloadRef("2mm", "2MM", "PolyBench", "Linear Algebra",
                       "N=1024"),
    "mvt": WorkloadRef("mvt", "MVT", "PolyBench", "Linear Algebra",
                       "N=4000"),
    "smm": WorkloadRef("smm", "SYMM", "PolyBench", "Linear Algebra",
                       "N=1024"),
}

# Cells the paper itself flags as its weak spots (§4.3): the mimicked
# interleaving misses some L2 locality for these kernels.
PAPER_KNOWN_WEAK_SPOTS: tuple[tuple[str, str], ...] = (
    ("grm", "L2"),
    ("smm", "L2"),
)

# Provenance of the stage-4 runtime models the validation tier scores
# side by side (``aggregates.runtime_models``): what each one computes
# and which literature its parameters transcribe.
RUNTIME_MODEL_REFS: dict[str, str] = {
    "eq": "paper Eq. 4–7 chain + two-mode T_CPU (§3.4; Table 5 "
          "latency/throughput parameters)",
    "ecm": "ECM-style in-core model: per-class port tables (Table 5 "
           "sources + OSACA-style port counts; 'Bridging the "
           "Architecture Gap' non-overlap data chain, chip-wide "
           "shared-bandwidth saturation)",
    "roofline": "two-term roofline: sustained-bandwidth memory stream "
                "vs peak-FLOP compute (declared peaks on accelerators, "
                "derived from Table 5 parameters on CPUs)",
}


def paper_claim(arch_name: str) -> PaperClaim:
    """Per-architecture claim, falling back to the overall aggregate
    for targets outside the paper's matrix (e.g. the TPU adaptation)."""
    return PAPER_ARCH_CLAIMS.get(arch_name, PAPER_OVERALL)


def reference_record() -> dict:
    """The whole reference block as JSON-serializable data — embedded
    into ``validation_full.json`` so the report is self-contained."""
    return {
        "overall": {
            "hit_rate_err_pct": PAPER_OVERALL.hit_rate_err_pct,
            "runtime_err_pct": PAPER_OVERALL.runtime_err_pct,
            "source": PAPER_OVERALL.source,
        },
        "per_arch": {
            name: {
                "hit_rate_err_pct": c.hit_rate_err_pct,
                "runtime_err_pct": c.runtime_err_pct,
                "source": c.source,
            }
            for name, c in PAPER_ARCH_CLAIMS.items()
        },
        "workloads": {
            abbr: {
                "name": r.name, "suite": r.suite, "domain": r.domain,
                "paper_input": r.paper_input,
            }
            for abbr, r in PAPER_TABLE4.items()
        },
        "known_weak_spots": [list(t) for t in PAPER_KNOWN_WEAK_SPOTS],
        "runtime_models": dict(RUNTIME_MODEL_REFS),
    }
