"""CLI for the validation harness (port of ``repro/validate/__main__.py``).

    python -m repro_torch.validate               # full matrix -> json
    python -m repro_torch.validate --report r.md # ... and a report
    python -m repro_torch.validate --smoke       # tiny matrix twice, assert
                                                 # zero recomputes on run 2
    python -m repro_torch.validate --workloads atx jcb --device cpu

Runs on the card unless ``--device cpu`` is given.  The smoke mode is
the gate: it runs the whole workload roster at tiny sizes twice against
one shared artifact dir and fails loudly if the second run rebuilt any
reuse profile (the disk store must make it fully incremental).

Results go to ``experiments/results/torch/`` and the default store to
``.validation-cache-torch/``, never the reference's files; a full run
writes a markdown report only when ``--report`` names a path.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.validate.report import generate_report
from repro_torch.validate.runner import (
    MatrixSpec,
    run_validation,
    save_results,
)
from repro_torch.workloads.polybench import MAKERS

RESULTS_DIR = "experiments/results/torch"
DEFAULT_ARTIFACT_DIR = ".validation-cache-torch"


def check_runtime_gate(aggregates: dict) -> tuple[bool, str]:
    """The --runtime-gate criterion: the instruction-aware ECM model
    must predict runtime at least as accurately as the crude roofline
    baseline, aggregated over every scored cell.

    Returns ``(passed, message)``; missing per-model aggregates (a
    matrix that scored neither model) fail loudly rather than passing
    vacuously.
    """
    models = aggregates.get("runtime_models", {})
    ecm = models.get("ecm")
    roofline = models.get("roofline")
    if not ecm or not roofline:
        return False, ("runtime gate: matrix did not score both 'ecm' and "
                       f"'roofline' (scored: {sorted(models)})")
    e, r = ecm["overall_rel_err_pct"], roofline["overall_rel_err_pct"]
    msg = (f"runtime gate: ecm {e:.3f}% vs roofline {r:.3f}% aggregate "
           f"relative error over {ecm['cells']} cells")
    if e <= r + 1e-9:
        return True, f"OK: {msg}"
    return False, f"FAIL: {msg} — ECM must not be worse than roofline"


def check_sampling_gate(aggregates: dict) -> tuple[bool, str]:
    """The --sampling-gate criterion: every sampled SDCM hit rate must
    deviate from the exact-profile prediction by less than the error
    bound its own profile declared (core.reuse.sampled).

    Returns ``(passed, message)``; a matrix that scored no sampled
    cells (``sampled_check=False``) fails loudly rather than passing
    vacuously.
    """
    sampled = aggregates.get("sampled_profile") or {}
    cells = sampled.get("cells", 0)
    if not cells:
        return False, ("sampling gate: matrix scored no sampled cells "
                       "(was sampled_check disabled?)")
    msg = (f"sampling gate: max deviation {sampled['max_abs_dev']:.2e} "
           f"vs max declared bound {sampled['max_declared_bound']:.2e} "
           f"over {cells} level cells at rate "
           f"{sampled.get('rate')}")
    if sampled.get("within_bound"):
        return True, f"OK: {msg}"
    return False, (f"FAIL: {msg} — {sampled['bound_exceedances']} cell(s) "
                   "exceeded their declared error bound")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.validate")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, run twice, assert zero recomputes")
    ap.add_argument("--sizes", default=None,
                    choices=["validation", "validation-xl",
                             "validation-xxl", "smoke", "default"],
                    help="workload size preset (default: validation; "
                         "'validation-xl' = ~100-200k refs/workload, "
                         "feasible via the batched reuse-distance "
                         "engines; 'validation-xxl' = >=1M "
                         "refs/workload, the scale the SHARDS-sampled "
                         "profile path targets; 'default' = the "
                         "quickstart/benchmark sizes)")
    ap.add_argument("--workloads", nargs="+", default=None, metavar="NAME",
                    help="subset of registry workload names "
                         "(polybench/atx, synthetic/stream, ...); "
                         "legacy Table-4 abbreviations accepted as "
                         "aliases")
    ap.add_argument("--targets", nargs="+", default=None, metavar="TARGET",
                    help="subset of hardware targets (default: the three "
                         "Table-5 CPUs; add tpu-v5e for VMEM hit-rate "
                         "cells)")
    ap.add_argument("--cores", nargs="+", type=int, default=None,
                    metavar="N", help="core counts (default: 1 2 4 8)")
    ap.add_argument("--artifact-dir", default=DEFAULT_ARTIFACT_DIR,
                    help="shared disk store (cross-run incrementality + "
                         "the worker-shard channel; default: "
                         f"{DEFAULT_ARTIFACT_DIR}, gitignored).  Pass "
                         "'none' to disable and recompute everything "
                         "serially")
    ap.add_argument("--processes", type=int, default=None,
                    help="worker processes (default: 1 on the card, as "
                         "the reference on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain PyTorch path on the host)")
    ap.add_argument("--out", default=None,
                    help=f"results json path (default: {RESULTS_DIR}/"
                         "validation_full.json or validation_smoke.json)")
    ap.add_argument("--report", default=None,
                    help="markdown report path (full runs only; none is "
                         "written without it)")
    ap.add_argument("--no-report", action="store_true",
                    help="write no report even when --report is given")
    ap.add_argument("--runtime-gate", action="store_true",
                    help="fail unless the ECM model's aggregate runtime "
                         "error is <= the roofline baseline's")
    ap.add_argument("--sampling-gate", action="store_true",
                    help="fail unless every sampled SDCM hit rate "
                         "deviates from the exact prediction by less "
                         "than its profile's declared error bound")
    args = ap.parse_args(argv)

    sizes = args.sizes or ("smoke" if args.smoke else "validation")
    if sizes == "default":
        sizes = None
    if args.artifact_dir and args.artifact_dir.lower() == "none":
        args.artifact_dir = None
    workloads = tuple(args.workloads) if args.workloads else tuple(MAKERS)
    # fail fast on typos (and normalize aliases for the matrix id)
    from repro_torch.workloads import registry

    try:
        workloads = tuple(registry.canonical_name(w) for w in workloads)
    except KeyError as exc:
        ap.error(str(exc.args[0] if exc.args else exc))
    overrides = {}
    if args.targets:
        from repro_torch.hw.targets import ALL_TARGETS

        unknown = [t for t in args.targets if t not in ALL_TARGETS]
        if unknown:
            ap.error(f"unknown target(s) {unknown} "
                     f"(choose from {sorted(ALL_TARGETS)})")
        overrides["targets"] = tuple(args.targets)
    if args.cores:
        overrides["core_counts"] = tuple(args.cores)
    spec = MatrixSpec(workloads=workloads, sizes=sizes, **overrides)
    print(f"validation matrix: {spec.describe()}")

    if args.smoke:
        if not args.artifact_dir:
            ap.error("--smoke needs --artifact-dir (the incrementality "
                     "assertion is about the shared store)")
        first = run_validation(spec, artifact_dir=args.artifact_dir,
                               processes=args.processes, device=args.device)
        second = run_validation(spec, artifact_dir=args.artifact_dir,
                                processes=args.processes, device=args.device)
        s2 = second["session_stats"]
        rebuilt = s2.get("profile_builds", 0) + s2.get("rd_builds", 0)
        summary = {
            "mode": "smoke",
            "first_run_stats": first["session_stats"],
            "second_run_stats": s2,
            "aggregates": second["aggregates"],
            "description": second["description"],
            "matrix_id": second["matrix_id"],
        }
        out = args.out or f"{RESULTS_DIR}/validation_smoke.json"
        save_results(summary, out)
        print(f"wrote {out}")
        print(f"run 1: {first['session_stats']}")
        print(f"run 2: {s2}")
        if rebuilt:
            print(f"FAIL: second run rebuilt {rebuilt} profiles/distance "
                  "passes — the artifact store is not incremental",
                  file=sys.stderr)
            return 1
        print("OK: second run performed zero reuse-profile recomputations "
              f"({s2.get('store_hits', 0)} disk-store hits)")
        if args.runtime_gate:
            passed, msg = check_runtime_gate(second["aggregates"])
            print(msg, file=None if passed else sys.stderr)
            if not passed:
                return 1
        if args.sampling_gate:
            passed, msg = check_sampling_gate(second["aggregates"])
            print(msg, file=None if passed else sys.stderr)
            if not passed:
                return 1
        return 0

    summary = run_validation(spec, artifact_dir=args.artifact_dir,
                             processes=args.processes, device=args.device)
    out = args.out or f"{RESULTS_DIR}/validation_full.json"
    save_results(summary, out)
    print(f"wrote {out}")
    agg = summary["aggregates"]["overall"]
    print(f"overall: hit err {agg['hit_rate_err_pct']['ours']:.2f}% "
          f"(paper {agg['hit_rate_err_pct']['paper']:.2f}%), "
          f"runtime err {agg['runtime_err_pct']['ours']:.2f}% "
          f"(paper {agg['runtime_err_pct']['paper']:.2f}%)")
    binned = summary["aggregates"].get("binned_profile", {})
    if binned.get("cells"):
        print(f"binned-profile deviation: max "
              f"{binned['max_abs_dev']:.2e} over {binned['cells']} "
              f"level cells (tolerance {binned['tolerance']:.0e}, "
              f"{'OK' if binned['within_tolerance'] else 'EXCEEDED'})")
    sampled = summary["aggregates"].get("sampled_profile", {})
    if sampled.get("cells"):
        print(f"sampled-profile deviation: max "
              f"{sampled['max_abs_dev']:.2e} over {sampled['cells']} "
              f"level cells at rate {sampled.get('rate')} (max declared "
              f"bound {sampled['max_declared_bound']:.2e}, "
              f"{'OK' if sampled['within_bound'] else 'EXCEEDED'})")
    models = summary["aggregates"].get("runtime_models", {})
    for mname, entry in models.items():
        print(f"runtime model {mname}: {entry['overall_rel_err_pct']:.2f}% "
              f"aggregate error over {entry['cells']} cells")
    if args.report and not args.no_report:
        generate_report(out, args.report)
        print(f"wrote {args.report}")
    if args.runtime_gate:
        passed, msg = check_runtime_gate(summary["aggregates"])
        print(msg, file=None if passed else sys.stderr)
        if not passed:
            return 1
    if args.sampling_gate:
        passed, msg = check_sampling_gate(summary["aggregates"])
        print(msg, file=None if passed else sys.stderr)
        if not passed:
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
