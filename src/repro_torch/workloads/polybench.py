"""Table-4 benchmark suite (PolyBench/OpenMP + PARSEC blackscholes) —
port of ``repro/workloads/polybench.py``: (a) analytic trace generators
for the parallel sections — the ROSE/Byfl stand-in (see tracegen.py) —
and (b) Byfl-style OpCounts.  Host numpy, bit-identical to the
reference.  The reference's ``jax_fn``/``jax_args`` fields are dropped:
nothing reads them.  Each maker registers in
:mod:`repro_torch.workloads.registry` as ``polybench/<abbr>``.

Input sizes are scaled down from the paper's standard inputs (their
traces run 7–335 GB) but keep
the exact loop structure, shared/private labeling, and per-iteration
BB instances of the Grauer-Gray OpenMP implementations, so reuse
behaviour per-set is faithful.

Each parallel-for iteration is one dynamic BB instance — Algorithm 1
splits instances across cores (static schedule) and offsets private
references; arrays accessed through the shared struct stay shared.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.core.runtime_model import OpCounts
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.workloads.tracegen import AddressSpace, TraceBuilder

ELEM = 8


@dataclass
class Workload:
    name: str
    abbr: str
    domain: str
    build_trace: Callable[[], LabeledTrace]
    op_counts: OpCounts

    def trace(self) -> LabeledTrace:
        return self.build_trace()


def _counts(fp=0.0, ints=0.0, divs=0.0, loads=0.0, stores=0.0) -> OpCounts:
    return OpCounts(
        int_ops=ints, fp_ops=fp, div_ops=divs, loads=loads, stores=stores,
        total_bytes=(loads + stores) * ELEM,
    )


# --- linear algebra ------------------------------------------------------------


def make_atax(n: int = 96) -> Workload:
    """A^T·(A·x): two parallel-for sections over rows."""
    sp = AddressSpace()
    A = sp.array("A", n, n)
    x = sp.array("x", n)
    tmp = sp.array("tmp", n)
    y = sp.array("y", n)

    def build():
        tb = TraceBuilder()
        j = np.arange(n)
        for i in range(n):
            tb.interleaved_instance(
                f"atax.tmp.{0}", [(A.addr(i, j), True), (x.addr(j), True)]
            )
            tb.instance("atax.tmp_w", [(tmp.addr(i), True)])
        for i in range(n):
            tb.interleaved_instance(
                "atax.y", [(A.addr(i, j), True), (tmp.addr(np.full(n, i)), True)]
            )
            tb.instance("atax.y_w", [(y.addr(i), True)])
        return tb.build()

    counts = _counts(fp=4 * n * n, ints=2 * n * n,
                     loads=4 * n * n, stores=2 * n)

    return Workload("ATAX", "atx", "Linear Algebra", build, counts)


def make_bicg(n: int = 96) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)
    p = sp.array("p", n)
    r = sp.array("r", n)
    q = sp.array("q", n)
    s = sp.array("s", n)

    def build():
        tb = TraceBuilder()
        j = np.arange(n)
        for i in range(n):
            tb.interleaved_instance(
                "bicg.q", [(A.addr(i, j), True), (p.addr(j), True)]
            )
            tb.instance("bicg.q_w", [(q.addr(i), True)])
        for jj in range(n):
            tb.interleaved_instance(
                "bicg.s", [(A.addr(np.arange(n), jj), True), (r.addr(np.arange(n)), True)]
            )
            tb.instance("bicg.s_w", [(s.addr(jj), True)])
        return tb.build()

    counts = _counts(fp=4 * n * n, ints=2 * n * n,
                     loads=4 * n * n, stores=2 * n)

    return Workload("BICG", "bcg", "Linear Algebra", build, counts)


def make_mvt(n: int = 128) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)
    x1 = sp.array("x1", n)
    x2 = sp.array("x2", n)
    y1 = sp.array("y1", n)
    y2 = sp.array("y2", n)

    def build():
        tb = TraceBuilder()
        j = np.arange(n)
        for i in range(n):
            tb.instance("mvt.x1r", [(x1.addr(i), True)])
            tb.interleaved_instance(
                "mvt.x1", [(A.addr(i, j), True), (y1.addr(j), True)]
            )
            tb.instance("mvt.x1w", [(x1.addr(i), True)])
        for i in range(n):
            tb.instance("mvt.x2r", [(x2.addr(i), True)])
            tb.interleaved_instance(
                "mvt.x2", [(A.addr(j, i), True), (y2.addr(j), True)]
            )
            tb.instance("mvt.x2w", [(x2.addr(i), True)])
        return tb.build()

    counts = _counts(fp=4 * n * n, ints=2 * n * n,
                     loads=4 * n * n + 2 * n, stores=2 * n)

    return Workload("MVT", "mvt", "Linear Algebra", build, counts)


def make_2mm(n: int = 40) -> Workload:
    """D = alpha*A*B*C + beta*D (two matrix multiplies)."""
    sp = AddressSpace()
    A = sp.array("A", n, n)
    B = sp.array("B", n, n)
    C = sp.array("C", n, n)
    D = sp.array("D", n, n)
    tmp = sp.array("tmp", n, n)

    def build():
        tb = TraceBuilder()
        k = np.arange(n)
        for i in range(n):
            for j in range(n):
                tb.interleaved_instance(
                    "2mm.tmp", [(A.addr(i, k), True), (B.addr(k, j), True)]
                )
                tb.instance("2mm.tmp_w", [(tmp.addr(i, j), True)])
        for i in range(n):
            for j in range(n):
                tb.interleaved_instance(
                    "2mm.D", [(tmp.addr(i, k), True), (C.addr(k, j), True)]
                )
                tb.instance("2mm.D_w", [(D.addr(i, j), True)])
        return tb.build()

    counts = _counts(fp=4 * n ** 3 + 3 * n * n, ints=2 * n ** 3,
                     loads=4 * n ** 3, stores=2 * n * n)

    return Workload("2MM", "2mm", "Linear Algebra", build, counts)


def make_symm(n: int = 48) -> Workload:
    """Symmetric matrix multiply C = alpha·A·B + beta·C (A symmetric)."""
    sp = AddressSpace()
    A = sp.array("A", n, n)
    B = sp.array("B", n, n)
    C = sp.array("C", n, n)

    def build():
        tb = TraceBuilder()
        for i in range(n):
            for j in range(n):
                k = np.arange(i)
                if len(k):
                    tb.interleaved_instance(
                        "symm.acc",
                        [(A.addr(i, k), True), (B.addr(k, j), True),
                         (C.addr(k, j), True)],
                    )
                tb.instance("symm.w", [
                    (A.addr(i, i), True), (B.addr(i, j), True),
                    (C.addr(i, j), True),
                ])
        return tb.build()

    counts = _counts(fp=3 * n * n * n / 2 + 4 * n * n,
                     ints=n * n * n, loads=1.5 * n ** 3, stores=n * n)

    return Workload("SYMM", "smm", "Linear Algebra", build, counts)



def make_doitgen(nq: int = 16, nr: int = 16, npp: int = 16) -> Workload:
    """Multi-resolution analysis kernel: sum[r,q,p] = A[r,q,s]·C4[s,p]."""
    sp = AddressSpace()
    A = sp.array("A", nr, nq, npp)
    C4 = sp.array("C4", npp, npp)
    s = sp.array("sum", nr, nq, npp)

    def build():
        tb = TraceBuilder()
        ss = np.arange(npp)
        for r in range(nr):
            for q in range(nq):
                for p in range(npp):
                    tb.interleaved_instance(
                        "doitgen.acc",
                        [(A.addr(r, q, ss), True), (C4.addr(ss, p), True)],
                    )
                    tb.instance("doitgen.w", [(s.addr(r, q, p), True)])
                tb.instance("doitgen.copy", [
                    (s.addr(r, q, np.arange(npp)), True),
                    (A.addr(r, q, np.arange(npp)), True),
                ])
        return tb.build()

    total = nr * nq * npp * npp
    counts = _counts(fp=2 * total, ints=total,
                     loads=2 * total + nr * nq * npp,
                     stores=nr * nq * npp * 2)

    return Workload("Doitgen", "dgn", "Linear Algebra", build, counts)


def make_durbin(n: int = 256) -> Workload:
    """Toeplitz solver — mostly sequential with a parallelizable inner
    loop; the paper traces the parallel section (the z-updates)."""
    sp = AddressSpace()
    r = sp.array("r", n)
    y = sp.array("y", n)
    z = sp.array("z", n)

    def build():
        tb = TraceBuilder()
        for k in range(1, n):
            i = np.arange(k)
            tb.interleaved_instance(
                "durbin.z", [(r.addr(k - 1 - i), True), (y.addr(i), True)]
            )
            tb.instance("durbin.zw", [(z.addr(i), True), (y.addr(i), True)])
            tb.instance("durbin.yk", [(y.addr(k), True), (r.addr(k), True)])
        return tb.build()

    counts = _counts(fp=2 * n * n, ints=n * n, divs=n,
                     loads=1.5 * n * n, stores=n * n)
    return Workload("Durbin", "dbn", "Linear Algebra", build, counts)


def make_gramschmidt(n: int = 40) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)
    R = sp.array("R", n, n)
    Q = sp.array("Q", n, n)

    def build():
        tb = TraceBuilder()
        rows = np.arange(n)
        for k in range(n):
            tb.instance("gs.norm", [(A.addr(rows, k), True)])
            tb.instance("gs.rkk", [(R.addr(k, k), True)])
            tb.instance("gs.q", [(A.addr(rows, k), True), (Q.addr(rows, k), True)])
            for j in range(k + 1, n):
                tb.interleaved_instance(
                    "gs.rkj", [(Q.addr(rows, k), True), (A.addr(rows, j), True)]
                )
                tb.instance("gs.rkj_w", [(R.addr(k, j), True)])
                tb.interleaved_instance(
                    "gs.update", [(A.addr(rows, j), True), (Q.addr(rows, k), True),
                                  (R.addr(k, np.full(n, j)), True)]
                )
        return tb.build()

    counts = _counts(fp=4 * n * n * n / 2 + 4 * n * n, ints=n ** 3 / 2,
                     divs=n * n, loads=2.5 * n ** 3 / 2, stores=n ** 3 / 2)

    return Workload("Gramschmidt", "grm", "Linear Algebra", build, counts)


def make_lu(n: int = 64) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)

    def build():
        tb = TraceBuilder()
        for k in range(n):
            j = np.arange(k + 1, n)
            if len(j) == 0:
                continue
            tb.instance("lu.div", [(A.addr(k, k), True), (A.addr(j, k), True)])
            for i in range(k + 1, n):
                tb.interleaved_instance(
                    "lu.update",
                    [(A.addr(np.full(n - k - 1, i), k), True),
                     (A.addr(k, j), True), (A.addr(i, j), True)],
                )
        return tb.build()

    counts = _counts(fp=2 * n ** 3 / 3, ints=n ** 3 / 3, divs=n * n / 2,
                     loads=n ** 3, stores=n ** 3 / 3)
    return Workload("LU", "lu", "Linear Algebra", build, counts)


# --- stencils ------------------------------------------------------------------


def make_jacobi2d(n: int = 64, tsteps: int = 2) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)
    B = sp.array("B", n, n)

    def build():
        tb = TraceBuilder()
        j = np.arange(1, n - 1)
        for _ in range(tsteps):
            for i in range(1, n - 1):
                tb.interleaved_instance(
                    "jacobi.b",
                    [(A.addr(i, j), True), (A.addr(i, j - 1), True),
                     (A.addr(i, j + 1), True), (A.addr(i - 1, j), True),
                     (A.addr(i + 1, j), True)],
                )
                tb.instance("jacobi.bw", [(B.addr(i, j), True)])
            for i in range(1, n - 1):
                tb.instance("jacobi.copy", [(B.addr(i, j), True),
                                            (A.addr(i, j), True)])
        return tb.build()

    inner = (n - 2) * (n - 2) * tsteps
    counts = _counts(fp=5 * inner, ints=2 * inner,
                     loads=6 * inner, stores=2 * inner)

    return Workload("Jacobi-2D", "jcb", "Stencils", build, counts)


def make_conv2d(n: int = 96) -> Workload:
    sp = AddressSpace()
    A = sp.array("A", n, n)
    B = sp.array("B", n, n)

    def build():
        tb = TraceBuilder()
        j = np.arange(1, n - 1)
        for i in range(1, n - 1):
            tb.interleaved_instance(
                "c2d.row",
                [(A.addr(i - 1, j - 1), True), (A.addr(i - 1, j), True),
                 (A.addr(i - 1, j + 1), True), (A.addr(i, j - 1), True),
                 (A.addr(i, j), True), (A.addr(i, j + 1), True),
                 (A.addr(i + 1, j - 1), True), (A.addr(i + 1, j), True),
                 (A.addr(i + 1, j + 1), True)],
            )
            tb.instance("c2d.w", [(B.addr(i, j), True)])
        return tb.build()

    inner = (n - 2) * (n - 2)
    counts = _counts(fp=17 * inner, ints=2 * inner,
                     loads=9 * inner, stores=inner)

    return Workload("Convolution-2D", "c2d", "Stencils", build, counts)


def make_adi(n: int = 48, tsteps: int = 2) -> Workload:
    """Alternating-direction implicit 2D heat: row sweeps then column
    sweeps, both parallelized over the other axis."""
    sp = AddressSpace()
    X = sp.array("X", n, n)
    A = sp.array("A", n, n)
    B = sp.array("B", n, n)

    def build():
        tb = TraceBuilder()
        for _ in range(tsteps):
            for i in range(n):
                j = np.arange(1, n)
                tb.interleaved_instance(
                    "adi.row",
                    [(X.addr(i, j), True), (X.addr(i, j - 1), True),
                     (A.addr(i, j), True), (B.addr(i, j), True),
                     (B.addr(i, j - 1), True)],
                )
            for j_col in range(n):
                i = np.arange(1, n)
                tb.interleaved_instance(
                    "adi.col",
                    [(X.addr(i, j_col), True), (X.addr(i - 1, j_col), True),
                     (A.addr(i, j_col), True), (B.addr(i, j_col), True),
                     (B.addr(i - 1, j_col), True)],
                )
        return tb.build()

    inner = 2 * n * (n - 1) * tsteps
    counts = _counts(fp=6 * inner, ints=2 * inner, divs=2 * inner,
                     loads=5 * inner, stores=2 * inner)
    return Workload("ADI", "adi", "Stencils", build, counts)


# --- data mining / RMS ----------------------------------------------------------


def make_covariance(n: int = 64) -> Workload:
    sp = AddressSpace()
    data = sp.array("data", n, n)
    cov = sp.array("cov", n, n)
    mean = sp.array("mean", n)

    def build():
        tb = TraceBuilder()
        rows = np.arange(n)
        for j in range(n):
            tb.instance("cov.mean", [(data.addr(rows, j), True),
                                     (mean.addr(j), True)])
        for i in range(n):
            tb.instance("cov.center", [(data.addr(i, rows), True),
                                       (mean.addr(rows), True)])
        for i in range(n):
            for j in range(i, n):
                tb.interleaved_instance(
                    "cov.acc",
                    [(data.addr(rows, i), True), (data.addr(rows, j), True)],
                )
                tb.instance("cov.w", [(cov.addr(i, j), True),
                                      (cov.addr(j, i), True)])
        return tb.build()

    counts = _counts(fp=n ** 3 + 4 * n * n, ints=n ** 3 / 2, divs=n + n * n / 2,
                     loads=n ** 3 + 3 * n * n, stores=n * n + n)

    return Workload("Covariance", "cov", "Datamining", build, counts)


def make_blackscholes(num_options: int = 2048) -> Workload:
    """PARSEC blackscholes: embarrassingly parallel over options; each
    option reads a 6-field struct and writes a price (AoS layout)."""
    sp = AddressSpace()
    opt = sp.array("options", num_options, 6)
    price = sp.array("prices", num_options)

    def build():
        tb = TraceBuilder()
        f = np.arange(6)
        # 100 runs in the paper; 4 here (trace size), same reuse pattern
        for _ in range(4):
            for i in range(num_options):
                tb.instance("blk.opt", [(opt.addr(i, f), True)])
                tb.instance("blk.w", [(price.addr(i), True)])
        return tb.build()

    runs = 4
    counts = _counts(fp=120 * num_options * runs, ints=10 * num_options * runs,
                     divs=6 * num_options * runs,
                     loads=6 * num_options * runs, stores=num_options * runs)

    return Workload("Blackscholes", "blk", "RMS", build, counts)


# --- registry -------------------------------------------------------------------

MAKERS = {
    "adi": make_adi,
    "atx": make_atax,
    "bcg": make_bicg,
    "blk": make_blackscholes,
    "c2d": make_conv2d,
    "cov": make_covariance,
    "dgn": make_doitgen,
    "dbn": make_durbin,
    "grm": make_gramschmidt,
    "jcb": make_jacobi2d,
    "lu": make_lu,
    "2mm": make_2mm,
    "mvt": make_mvt,
    "smm": make_symm,
}


def all_workloads(subset: list[str] | None = None) -> list[Workload]:
    keys = subset or list(MAKERS)
    return [MAKERS[k]() for k in keys]


# --- validation size presets ----------------------------------------------
#
# The paper traces standard inputs (7-335 GB of references); the
# validation harness (repro.validate) runs the full matrix at reduced
# sizes that keep each trace's loop structure and shared labeling
# intact.  "validation" targets ~8-12k references per workload (the
# committed experiments/results/validation_full.json run); "smoke"
# targets ~1-3k (the CI validation-smoke job).  "validation-xl"
# targets ~100-200k references per workload — infeasible under the old
# monolithic Fenwick scan (O(N)-per-step timeline), feasible now that
# reuse_distances routes large traces through the batched/offline
# engines and the exact-LRU baselines run per-set batched scans
# (core/reuse/batched.py).  "validation-xxl" targets >= 1M references
# per workload (every entry verified >= 1e6), the scale the
# SHARDS-sampled profile path (core/reuse/sampled.py) exists for —
# exact full-matrix passes remain possible but slow, sampled passes
# stay constant-memory.  Default maker sizes (no preset) are the
# quickstart/benchmark sizes.

SIZE_PRESETS: dict[str, dict[str, dict]] = {
    "validation-xxl": {
        "adi": dict(n=230, tsteps=2),
        "atx": dict(n=520),
        "bcg": dict(n=520),
        "blk": dict(num_options=36000),
        "c2d": dict(n=320),
        "cov": dict(n=99),
        "dgn": dict(nq=27, nr=27, npp=27),
        "dbn": dict(n=720),
        "grm": dict(n=74),
        "jcb": dict(n=254, tsteps=2),
        "lu": dict(n=102),
        "2mm": dict(n=64),
        "mvt": dict(n=520),
        "smm": dict(n=88),
    },
    "validation-xl": {
        "adi": dict(n=56, tsteps=2),
        "atx": dict(n=190),
        "bcg": dict(n=190),
        "blk": dict(num_options=5000),
        "c2d": dict(n=128),
        "cov": dict(n=54),
        "dgn": dict(nq=16, nr=16, npp=16),
        "dbn": dict(n=256),
        "grm": dict(n=36),
        "jcb": dict(n=90, tsteps=2),
        "lu": dict(n=48),
        "2mm": dict(n=33),
        "mvt": dict(n=190),
        "smm": dict(n=44),
    },
    "validation": {
        "adi": dict(n=20, tsteps=2),
        "atx": dict(n=48),
        "bcg": dict(n=48),
        "blk": dict(num_options=320),
        "c2d": dict(n=32),
        "cov": dict(n=20),
        "dgn": dict(nq=8, nr=8, npp=8),
        "dbn": dict(n=64),
        "grm": dict(n=15),
        "jcb": dict(n=24, tsteps=2),
        "lu": dict(n=21),
        "2mm": dict(n=14),
        "mvt": dict(n=48),
        "smm": dict(n=18),
    },
    "smoke": {
        "adi": dict(n=10, tsteps=1),
        "atx": dict(n=24),
        "bcg": dict(n=24),
        "blk": dict(num_options=96),
        "c2d": dict(n=16),
        "cov": dict(n=10),
        "dgn": dict(nq=5, nr=5, npp=5),
        "dbn": dict(n=32),
        "grm": dict(n=8),
        "jcb": dict(n=12, tsteps=1),
        "lu": dict(n=12),
        "2mm": dict(n=8),
        "mvt": dict(n=24),
        "smm": dict(n=10),
    },
}


def make_workload(abbr: str, sizes: str | None = None) -> Workload:
    """Build one workload at a named size preset (None = defaults)."""
    kwargs = SIZE_PRESETS[sizes].get(abbr, {}) if sizes else {}
    return MAKERS[abbr](**kwargs)


# --- registry shim ---------------------------------------------------------
#
# MAKERS/SIZE_PRESETS stay as the implementation detail; the public
# roster is repro_torch.workloads.registry, where each maker registers as
# "polybench/<abbr>" with its bare abbr kept as a legacy alias.  The
# declared fingerprint hashes the maker's *resolved* kwargs (preset
# entries merged over signature defaults), so a preset that happens to
# equal the defaults shares the defaults' artifact set.


def _resolved_kwargs(abbr: str, sizes: str | None) -> dict:
    import inspect

    defaults = {
        k: p.default
        for k, p in inspect.signature(MAKERS[abbr]).parameters.items()
        if p.default is not inspect.Parameter.empty
    }
    preset = SIZE_PRESETS[sizes].get(abbr, {}) if sizes else {}
    return {**defaults, **preset}


def _register_polybench() -> None:
    from repro_torch.workloads.registry import WorkloadSpec, register

    for abbr in MAKERS:
        def build(sizes, _abbr=abbr):
            return make_workload(_abbr, sizes)

        def size_kwargs(sizes, _abbr=abbr):
            return _resolved_kwargs(_abbr, sizes)

        register(WorkloadSpec(
            name=f"polybench/{abbr}",
            build=build,
            size_kwargs=size_kwargs,
            presets=tuple(sorted(SIZE_PRESETS)),
            aliases=(abbr,),
            description=f"Table-4 {abbr} analytic trace generator",
        ))


_register_polybench()
