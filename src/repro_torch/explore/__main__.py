"""CLI for the config-space autotuner — port of
``repro/explore/__main__.py``.

    python -m repro_torch.explore --workload polybench/atx --budget 256 \
        --agent hillclimb --artifact-dir .explore-cache
    python -m repro_torch.explore --workload polybench/atx --agent all \
        --space '{"sets": [512, 2048, 8192], "ways": [4, 8, 16]}' \
        --update-doc --doc report.md
    python -m repro_torch.explore --smoke --artifact-dir .explore-cache
    python -m repro_torch.explore --smoke --device cpu --artifact-dir DIR

Runs on the card unless ``--device cpu`` is given.  Results land in
``experiments/results/torch/explore_*.json`` (``--out``);
``--update-doc`` splices the best-configs report into the document that
``--doc`` names.  Smoke mode is the gate: on a seeded space it asserts
that the random and hill-climb agents recover the exhaustively verified
best config and that a warm re-run serves the whole search from the
ArtifactStore with zero recomputation.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.api.session import Session
from repro_torch.workloads import registry

from .agents import AGENTS
from .report import render_markdown, update_doc, write_result
from .runner import run_explore
from .space import SearchSpace

SMOKE_SPACE = {
    "sets": [256, 1024, 4096, 16384],
    "ways": [2, 4, 8],
    "latency_cy": [20.0, 36.0, 60.0],
    "cores": [1, 2],
}


def _session(artifact_dir: str | None, device=None) -> Session:
    if artifact_dir and artifact_dir.lower() != "none":
        return Session(cache_model="batched", artifact_dir=artifact_dir,
                       device=device)
    return Session(cache_model="batched", device=device)


def run_smoke(artifact_dir: str, seed: int, device=None) -> int:
    """The gate: agents recover the known best; warm re-runs recompute
    nothing."""
    name = "polybench/atx"
    space = SearchSpace.from_json(SMOKE_SPACE)
    workload = registry.resolve(name, "smoke")
    session = _session(artifact_dir, device)

    # exhaustive oracle: the random agent with the full space as budget
    n = space.size
    oracle = run_explore(
        workload, space, agent="random", budget=n, seed=seed,
        session=session, workload=name, refresh=True,
    )
    assert oracle["trajectory"]["evaluations"] == n, oracle["trajectory"]
    best_score = oracle["best"]["score"]
    print(f"smoke: exhaustive best over {n} configs: "
          f"{best_score:.4e} ({oracle['best']['config']})")

    failures = []
    for agent, budget in (("random", n), ("hillclimb", max(n // 2, 16))):
        res = run_explore(
            workload, space, agent=agent, budget=budget, seed=seed,
            session=session, workload=name, refresh=True,
        )
        got = res["best"]["score"]
        ok = got <= best_score * (1 + 1e-12)
        print(f"smoke: {agent} (budget {budget}) best {got:.4e} "
              f"after {res['trajectory']['evaluations']} evals — "
              f"{'OK' if ok else 'MISSED'}")
        if not ok:
            failures.append(
                f"{agent} missed the known-best config "
                f"({got:.6e} > {best_score:.6e})"
            )

    # warm re-run: a FRESH session must answer from the store alone
    warm = _session(artifact_dir, device)
    res = run_explore(
        workload, space, agent="hillclimb",
        budget=max(n // 2, 16), seed=seed,
        session=warm, workload=name,
    )
    stats = warm.stats
    recomputed = (stats.profile_builds + stats.rd_builds
                  + stats.kernel_shapes)
    if not res.get("cached"):
        failures.append("warm re-run was not served from the store")
    if recomputed:
        failures.append(
            f"warm re-run recomputed work: {stats}"
        )
    print(f"smoke: warm re-run cached={res.get('cached')} "
          f"session stats {stats}")

    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    if not failures:
        print("OK: agents recover the known best and warm re-runs "
              "recompute nothing")
    return 1 if failures else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.explore")
    ap.add_argument("--workload", default="polybench/atx",
                    help="registry workload name (polybench/atx, "
                         "synthetic/stride, ...)")
    ap.add_argument("--sizes", default=None,
                    help="workload size preset (registry presets; "
                         "default: the workload's default sizes)")
    ap.add_argument("--agent", default="hillclimb",
                    help=f"search agent: {', '.join(sorted(AGENTS))}, "
                         "or 'all'")
    ap.add_argument("--budget", type=int, default=256,
                    help="max unique configs to evaluate (default 256)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--space", default=None,
                    help="search-space JSON (inline or @file); axes "
                         "default to the built-in L3 sweep")
    ap.add_argument("--objective", default=None,
                    choices=["runtime", "llc_miss"],
                    help="fitness (default: runtime when the workload "
                         "declares op counts, else llc_miss)")
    ap.add_argument("--mode", default="throughput",
                    choices=["throughput", "latency"],
                    help="ECM combination mode for the runtime objective")
    ap.add_argument("--inner", default="vmap", choices=["vmap", "pallas"],
                    help="sweep inner evaluator: vmap = one ragged SDCM "
                         "launch per profile group, pallas = the "
                         "per-reference SDCM kernel per geometry")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; "
                         "'cpu' runs the plain PyTorch versions)")
    ap.add_argument("--artifact-dir", default=".explore-cache",
                    help="ArtifactStore dir for profiles + trajectories "
                         "('none' disables persistence)")
    ap.add_argument("--out", default="experiments/results/torch",
                    help="directory for explore_*.json results")
    ap.add_argument("--update-doc", action="store_true",
                    help="splice the best-configs report into the "
                         "document named by --doc")
    ap.add_argument("--doc", default=None,
                    help="document with explore:generated markers "
                         "(required with --update-doc)")
    ap.add_argument("--refresh", action="store_true",
                    help="ignore stored trajectories and re-search")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: known-best recovery + warm-store "
                         "zero-recompute assertions")
    args = ap.parse_args(argv)

    if args.update_doc and not args.doc:
        ap.error("--update-doc needs --doc PATH")
    if args.smoke:
        if not args.artifact_dir or args.artifact_dir.lower() == "none":
            ap.error("--smoke needs --artifact-dir (the zero-recompute "
                     "assertion is about the shared store)")
        return run_smoke(args.artifact_dir, args.seed, args.device)

    if args.space:
        raw = args.space
        if raw.startswith("@"):
            with open(raw[1:]) as fh:
                raw = fh.read()
        space = SearchSpace.from_json(json.loads(raw))
    else:
        space = SearchSpace()

    agents = sorted(AGENTS) if args.agent == "all" else [args.agent]
    for a in agents:
        if a not in AGENTS:
            ap.error(f"unknown agent {a!r} (known: {sorted(AGENTS)})")

    try:
        name = registry.canonical_name(args.workload)
    except KeyError as exc:
        ap.error(str(exc.args[0] if exc.args else exc))
    session = _session(args.artifact_dir, args.device)
    workload = registry.resolve(name, args.sizes, store=session.store)

    results = []
    for agent in agents:
        res = run_explore(
            workload, space, agent=agent, budget=args.budget,
            seed=args.seed, session=session, mode=args.mode,
            objective=args.objective, inner=args.inner,
            workload=name, refresh=args.refresh,
        )
        path = write_result(res, args.out)
        print(f"[{agent}] cached={res['cached']} "
              f"evals={res['trajectory']['evaluations']}/{args.budget} "
              f"best={res['best']['score']:.4e} -> {path}")
        results.append(res)

    if args.update_doc:
        update_doc(args.doc, results)
        print(f"updated {args.doc}")
    else:
        print(render_markdown(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
