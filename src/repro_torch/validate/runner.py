"""Paper-matrix validation runner (port of ``repro/validate/runner.py``).

Executes the paper's full validation matrix — every
``repro_torch.workloads.polybench`` workload × the three Table-5 CPUs ×
core counts {1,2,4,8} × interleave strategies — through the
``PredictionRequest``/``Session`` grid, and scores each cell the way
the paper does:

* **hit rates** — analytical SDCM prediction vs the exact
  set-associative LRU simulation of the same mimicked traces (the
  container's PAPI stand-in), absolute error per level in percent;
* **runtimes** — the Eq. 4–7 chain with SDCM rates vs the same chain
  with exact rates, relative error in percent (isolates the SDCM
  approximation, the paper's modeling contribution).

Every Session runs on ``device`` (the card unless ``"cpu"`` is asked
for): reuse distances, profiles, the binned check's histogram (kernel
B2) and the exact-LRU ground truth.  Hit rates come from the
reference's default cache model, the float64 SDCM oracle, so every
score is the reference's to float64 rounding.

Cells are sharded by workload (one workload's cells share mimicked
traces, so they stay together for in-memory cache locality).  On the
card ``processes=None`` means one, in-process: one H100 serves one CUDA
context best.  ``processes > 1`` spawns workers (never forks), each
resolving the device itself; every worker layers its Session on the
SAME disk-backed :class:`~repro_torch.validate.store.ArtifactStore`,
and results are merged store-mediated: each worker writes its
per-workload payload under the ``validation`` kind and the parent reads
the shards back.  A second run with the same ``artifact_dir`` therefore
performs zero reuse-profile recomputations
(``session_stats.profile_builds == 0``) and zero exact-LRU
resimulations.

Store keys: ``exact`` baselines keep the reference's keys (the port's
ground truth equals the reference's bit for bit), so a store warmed by
either package serves the other.  ``validation`` shards do not: the
binned check's deviations follow the port's log2 bins, which differ from
the reference's at the C2 bin points, so the port's shard keys carry
:data:`SHARD_STAMP` (ROADMAP queue C, C6).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
from pathlib import Path

import numpy as np

from repro_torch.api import PredictionRequest, Session
from repro_torch.api.stages import (
    default_runtime_model,
    resolve_runtime_model,
    shared_level_index,
    supported_runtime_models,
)
from repro_torch.device import resolve_device
from repro_torch.hw.targets import CPU_TARGETS, resolve_target
from repro_torch.validate.reference import (
    PAPER_OVERALL,
    paper_claim,
    reference_record,
)
from repro_torch.validate.store import ArtifactStore, atomic_write_bytes
from repro_torch.workloads.polybench import MAKERS

DEFAULT_TARGETS = tuple(CPU_TARGETS)          # the three Table-5 CPUs
DEFAULT_CORES = (1, 2, 4, 8)
DEFAULT_STRATEGIES = ("round_robin", "uniform")
#: Joins every ``validation`` shard key of the port (C6).
SHARD_STAMP = "repro_torch"


@dataclasses.dataclass(frozen=True)
class MatrixSpec:
    """Declarative description of one validation matrix.

    ``workloads`` entries are registry names (``polybench/atx``,
    ``synthetic/stream``); legacy Table-4 abbreviations keep resolving
    as aliases, so the default roster stays spelled as the paper
    abbreviates it.  The spec and its :meth:`matrix_id` are the
    reference's.
    """

    workloads: tuple[str, ...] = tuple(MAKERS)
    targets: tuple[str, ...] = DEFAULT_TARGETS
    core_counts: tuple[int, ...] = DEFAULT_CORES
    strategies: tuple[str, ...] = DEFAULT_STRATEGIES
    sizes: str | None = "validation"   # polybench.SIZE_PRESETS key
    seed: int = 0
    # also run every cell through a binned=True Session (the fused
    # device-histogram profile path) and record the absolute deviation
    # of its SDCM hit rates from the exact-profile prediction
    binned_check: bool = True
    # also run every cell through a sampled=R Session (SHARDS-sampled
    # profiles, core/reuse/sampled.py) and record the absolute
    # deviation of its SDCM hit rates from the exact-profile
    # prediction ALONGSIDE the per-level error bound each sampled
    # profile declares — the gate's tolerance is the bound itself,
    # not a fixed constant like the binned check's 1e-3
    sampled_check: bool = True
    sampled_rate: float = 0.5

    def matrix_id(self) -> str:
        """Stable id of the matrix — namespaces the result shards in
        the store so different matrices never mix."""
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def describe(self) -> str:
        return (
            f"{len(self.workloads)} workloads x {len(self.targets)} targets"
            f" x cores {list(self.core_counts)}"
            f" x strategies {list(self.strategies)}"
            f" (sizes={self.sizes or 'default'})"
        )


def _levels_fingerprint(target) -> str:
    """Content key of a target's cache hierarchy — exact-LRU baselines
    depend only on the hierarchy, so targets sharing one (or reruns)
    share the cached simulation."""
    t = resolve_target(target)
    parts = [
        (lvl.name, lvl.size_bytes, lvl.line_size, lvl.assoc)
        for lvl in t.levels
    ]
    parts.append(("shared_level", getattr(t, "shared_level", -1)))
    return hashlib.sha1(repr(parts).encode()).hexdigest()[:12]


def _exact_hit_rates(session: Session, store: ArtifactStore | None,
                     tid: str, source, target, cores: int, strategy: str,
                     seed: int) -> dict[str, float]:
    """Exact-LRU baseline for one cell, store-cached under the trace
    content hash + hierarchy fingerprint."""
    key = (f"{tid}-{_levels_fingerprint(target)}"
           f"-c{cores}-{strategy}-s{seed}")
    if store is not None:
        cached = store.get_json("exact", key)
        if cached is not None:
            return {k: float(v) for k, v in cached.items()}
    rates = session.ground_truth_hit_rates(
        source, target, cores, strategy=strategy, seed=seed
    )
    if store is not None:
        store.put_json("exact", key, rates)
    return rates


def _shard_key(spec: MatrixSpec, name: str) -> str:
    """Store key of one workload's shard, stamped as the port's (C6);
    registry names contain ``/`` which must not become directory
    separators."""
    return f"{spec.matrix_id()}-{SHARD_STAMP}-{name.replace('/', '_')}"


def run_workload(abbr: str, spec: MatrixSpec,
                 artifact_dir: str | os.PathLike | None,
                 device=None) -> dict:
    """Score every matrix cell of one workload (one worker's shard) on
    ``device`` (``None``: the card)."""
    from repro_torch.workloads import registry

    device = resolve_device(device)
    store = ArtifactStore(artifact_dir) if artifact_dir else None
    session = Session(store=store, device=device)
    w = registry.resolve(abbr, spec.sizes, store=store)
    # fingerprint only — the trace is materialized lazily, so a warm
    # store serves the whole shard with zero trace builds
    tid = session.identify(w)

    request = PredictionRequest(
        targets=spec.targets,
        core_counts=spec.core_counts,
        strategies=spec.strategies,
        counts=w.op_counts,
        seed=spec.seed,
        respect_core_limit=False,
    )
    predset = session.predict(w, request)

    binned_by_key: dict[tuple, dict] = {}
    binned_stats = None
    if spec.binned_check:
        # separate Session: the binned builder has its own store
        # fingerprint, so its cells are cached/persisted independently
        bsession = Session(store=store, binned=True, device=device)
        bpred = bsession.predict(w, request)
        binned_by_key = {
            (p.target, p.cores, p.strategy, p.mode): p.hit_rates
            for p in bpred
        }
        binned_stats = dataclasses.asdict(bsession.stats)

    sampled_by_key: dict[tuple, dict] = {}
    sampled_session = None
    sampled_stats = None
    if spec.sampled_check:
        # separate sampled Session, same store: ``+sampled{R}``
        # fingerprints keep its cells disjoint from exact/binned ones
        sampled_session = Session(store=store, sampled=spec.sampled_rate,
                                  device=device)
        spred = sampled_session.predict(w, request)
        sampled_by_key = {
            (p.target, p.cores, p.strategy, p.mode): p.hit_rates
            for p in spred
        }

    records = []
    for cell in predset:
        target = resolve_target(cell.target)
        exact = _exact_hit_rates(
            session, store, tid, w, target, cell.cores, cell.strategy,
            spec.seed,
        )
        levels = {
            lvl: {
                "predicted": float(cell.hit_rates[lvl]),
                "exact": float(exact[lvl]),
                "abs_err_pct": abs(cell.hit_rates[lvl] - exact[lvl]) * 100,
            }
            for lvl in cell.hit_rates
        }
        # the cell's reference runtime: the per-target default model
        # (Eq. 4–7 for the instruction-timed CPUs, roofline for the
        # TPU) evaluated with the EXACT rates — this container's
        # stand-in for the paper's wall-clock measurement
        t_exact = default_runtime_model(target).runtime(
            target, exact, w.op_counts, cell.cores, mode=cell.mode
        )["t_pred_s"]
        # every named stage-4 model the target supports, scored against
        # that ONE common reference.  Scoring each model against its
        # own exact-rates prediction would measure rate sensitivity,
        # not fidelity (a model that ignores hit rates scores a
        # degenerate 0%) — the --runtime-gate comparison (ECM vs
        # Roofline) needs a shared yardstick.
        runtime_models = {}
        for mname in supported_runtime_models(target):
            model = resolve_runtime_model(mname, target)
            t_sdcm = model.runtime(
                target, cell.hit_rates, w.op_counts, cell.cores,
                mode=cell.mode,
            )["t_pred_s"]
            runtime_models[mname] = {
                "t_pred_s": float(t_sdcm),
                "rel_err_pct":
                    abs(t_sdcm - t_exact) / max(t_exact, 1e-12) * 100,
            }
        rec = {
            "workload": w.workload_name,
            "target": cell.target,
            "cores": cell.cores,
            "strategy": cell.strategy,
            "levels": levels,
            "t_pred_s": float(cell.t_pred_s),
            "t_exact_rates_s": float(t_exact),
            "runtime_rel_err_pct":
                abs(cell.t_pred_s - t_exact) / max(t_exact, 1e-12) * 100,
            "runtime_models": runtime_models,
        }
        bkey = (cell.target, cell.cores, cell.strategy, cell.mode)
        if bkey in binned_by_key:
            brates = binned_by_key[bkey]
            rec["binned_abs_dev"] = {
                lvl: abs(float(brates[lvl]) - float(cell.hit_rates[lvl]))
                for lvl in cell.hit_rates
            }
        if bkey in sampled_by_key:
            srates = sampled_by_key[bkey]
            rec["sampled_abs_dev"] = {
                lvl: abs(float(srates[lvl]) - float(cell.hit_rates[lvl]))
                for lvl in cell.hit_rates
            }
            # per-level DECLARED bound: private levels read the PRD
            # estimate, the shared level(s) the CRD one (same routing
            # as AnalyticalSDCM) — served from the sampled Session's
            # in-memory cell cache, so this costs zero rebuilds
            sart = sampled_session.artifacts(
                w, cell.cores, strategy=cell.strategy, seed=spec.seed,
                line_size=target.levels[0].line_size,
            )
            shared_idx = shared_level_index(target)
            rec["sampled_bound"] = {
                lvl.name: float(
                    (sart.crd if i >= shared_idx else sart.prd).error_bound
                    or 0.0
                )
                for i, lvl in enumerate(target.levels)
                if lvl.name in cell.hit_rates
            }
        records.append(rec)

    stats = dataclasses.asdict(session.stats)
    if sampled_session is not None:
        # read AFTER the record loop: the bound lookups go through the
        # sampled Session's cell cache and must show up as hits there
        sampled_stats = dataclasses.asdict(sampled_session.stats)
    for extra in (binned_stats, sampled_stats):
        if extra:  # fold the check Sessions' counters in
            for k, v in extra.items():
                stats[k] = stats.get(k, 0) + int(v)
    # refs come from the store's workload meta when the trace never
    # materialized this run (warm store); only a store-less run has to
    # load the trace just to count it
    refs = None
    if store is not None:
        meta = store.get_json("workload", tid)
        if meta:
            refs = meta.get("refs")
    if refs is None:
        refs = len(session.load(w)[1])
    payload = {
        "workload": w.workload_name,
        "trace_id": tid,
        "refs": int(refs),
        "records": records,
        "session_stats": stats,
        "store_stats": dataclasses.asdict(store.stats) if store else None,
    }
    if store is not None:
        # store-mediated merge: the parent reads this shard back
        store.put_json("validation", _shard_key(spec, w.workload_name),
                       payload)
    return payload


def _worker(args) -> str:
    abbr, spec, artifact_dir, device = args
    run_workload(abbr, spec, artifact_dir, device)
    return abbr


def _merge(shards: list[dict], spec: MatrixSpec) -> dict:
    """Fold per-workload shards into the validation summary: per-cell
    records, per-architecture and aggregate errors, paper comparison,
    and the summed Session counters the zero-recompute assertions use."""
    hit_by_arch: dict[str, list] = {}
    rt_by_arch: dict[str, list] = {}
    hit_by_level: dict[str, list] = {}
    per_workload: dict[str, dict] = {}
    stats_total: dict[str, int] = {}
    all_hit, all_rt = [], []
    binned_devs: list[float] = []
    sampled_devs: list[float] = []
    sampled_bounds: list[float] = []
    sampled_exceed = 0
    # per named stage-4 model: model -> {"all": [...], arch: [...]}
    model_errs: dict[str, dict[str, list]] = {}

    for shard in shards:
        w_hit, w_rt = [], []
        for rec in shard["records"]:
            arch = rec["target"]
            for lvl, entry in rec["levels"].items():
                err = entry["abs_err_pct"]
                hit_by_arch.setdefault(arch, []).append(err)
                hit_by_level.setdefault(lvl, []).append(err)
                all_hit.append(err)
                w_hit.append(err)
            binned_devs.extend(rec.get("binned_abs_dev", {}).values())
            sdev = rec.get("sampled_abs_dev", {})
            sbound = rec.get("sampled_bound", {})
            for lvl, dev in sdev.items():
                bound = float(sbound.get(lvl, 0.0))
                sampled_devs.append(float(dev))
                sampled_bounds.append(bound)
                if float(dev) > bound:
                    sampled_exceed += 1
            rt = rec["runtime_rel_err_pct"]
            rt_by_arch.setdefault(arch, []).append(rt)
            all_rt.append(rt)
            w_rt.append(rt)
            for mname, entry in rec.get("runtime_models", {}).items():
                buckets = model_errs.setdefault(mname, {"all": []})
                buckets["all"].append(entry["rel_err_pct"])
                buckets.setdefault(arch, []).append(entry["rel_err_pct"])
        per_workload[shard["workload"]] = {
            "refs": shard["refs"],
            "trace_id": shard["trace_id"],
            "avg_hit_err_pct": float(np.mean(w_hit)) if w_hit else 0.0,
            "avg_runtime_err_pct": float(np.mean(w_rt)) if w_rt else 0.0,
        }
        for k, v in shard["session_stats"].items():
            stats_total[k] = stats_total.get(k, 0) + int(v)

    def vs_paper(ours: float, claimed: float) -> dict:
        return {"ours": ours, "paper": claimed,
                "delta": ours - claimed}

    per_arch = {}
    for arch in hit_by_arch:
        claim = paper_claim(arch)
        per_arch[arch] = {
            "hit_rate_err_pct": vs_paper(
                float(np.mean(hit_by_arch[arch])), claim.hit_rate_err_pct
            ),
            "runtime_err_pct": vs_paper(
                float(np.mean(rt_by_arch[arch])), claim.runtime_err_pct
            ),
            "cells": len(rt_by_arch[arch]),
        }

    return {
        "spec": dataclasses.asdict(spec),
        "matrix_id": spec.matrix_id(),
        "description": spec.describe(),
        "reference": reference_record(),
        "aggregates": {
            "overall": {
                "hit_rate_err_pct": vs_paper(
                    float(np.mean(all_hit)) if all_hit else 0.0,
                    PAPER_OVERALL.hit_rate_err_pct,
                ),
                "runtime_err_pct": vs_paper(
                    float(np.mean(all_rt)) if all_rt else 0.0,
                    PAPER_OVERALL.runtime_err_pct,
                ),
                "cells": len(all_rt),
            },
            "per_arch": per_arch,
            "per_level_hit_err_pct": {
                lvl: float(np.mean(v)) for lvl, v in hit_by_level.items()
            },
            # every named stage-4 model scored identically (prediction
            # with SDCM rates vs with exact rates); the --runtime-gate
            # compares ecm vs roofline here
            "runtime_models": {
                mname: {
                    "overall_rel_err_pct": float(np.mean(buckets["all"])),
                    "cells": len(buckets["all"]),
                    "per_arch": {
                        arch: float(np.mean(errs))
                        for arch, errs in buckets.items()
                        if arch != "all"
                    },
                }
                for mname, buckets in sorted(model_errs.items())
            },
            # fused device-binned profiles vs exact profiles, same SDCM:
            # the binned path is usable iff this stays under tolerance
            "binned_profile": {
                "cells": len(binned_devs),
                "max_abs_dev": float(np.max(binned_devs))
                if binned_devs else 0.0,
                "mean_abs_dev": float(np.mean(binned_devs))
                if binned_devs else 0.0,
                "tolerance": 1e-3,
                "within_tolerance": bool(
                    not binned_devs or float(np.max(binned_devs)) <= 1e-3
                ),
            },
            # SHARDS-sampled profiles vs exact profiles, same SDCM:
            # unlike the binned check's fixed 1e-3, each level cell is
            # gated against the error bound ITS OWN profile declared
            # (core/reuse/sampled.sampling_error_bound), so the
            # tolerance tightens automatically as traces grow
            "sampled_profile": {
                "cells": len(sampled_devs),
                "rate": spec.sampled_rate if spec.sampled_check else None,
                "max_abs_dev": float(np.max(sampled_devs))
                if sampled_devs else 0.0,
                "mean_abs_dev": float(np.mean(sampled_devs))
                if sampled_devs else 0.0,
                "max_declared_bound": float(np.max(sampled_bounds))
                if sampled_bounds else 0.0,
                "mean_declared_bound": float(np.mean(sampled_bounds))
                if sampled_bounds else 0.0,
                "bound_exceedances": int(sampled_exceed),
                "within_bound": bool(sampled_exceed == 0),
            },
        },
        "per_workload": per_workload,
        "records": [r for s in shards for r in s["records"]],
        "session_stats": stats_total,
    }


def run_validation(
    spec: MatrixSpec | None = None,
    *,
    artifact_dir: str | os.PathLike | None = None,
    processes: int | None = None,
    device=None,
) -> dict:
    """Run the validation matrix on ``device`` (``None``: the card) and
    return the merged summary.

    ``processes > 1`` shards workloads across spawned worker processes
    that share ``artifact_dir``; ``processes=1`` (or a single workload)
    runs in-process.  ``processes=None`` runs in-process on the card or
    without a store, and on the CPU spawns one worker a workload up to
    the CPU count, as the reference does.  Without an ``artifact_dir``
    everything is recomputed (no cross-run incrementality).
    """
    spec = spec or MatrixSpec()
    if processes is None:
        # no store -> no channel for worker shards: default to serial
        # rather than erroring out (an explicit processes>1 still does);
        # the card serves one context best
        if artifact_dir is None or resolve_device(device).type == "cuda":
            processes = 1
        else:
            processes = max(1, min(len(spec.workloads), os.cpu_count() or 1))

    if processes <= 1 or len(spec.workloads) <= 1:
        shards = [
            run_workload(abbr, spec, artifact_dir, device)
            for abbr in spec.workloads
        ]
    else:
        if artifact_dir is None:
            raise ValueError(
                "multi-process validation needs an artifact_dir: workers "
                "hand their shards to the parent through the store"
            )
        ctx = multiprocessing.get_context("spawn")
        # the device travels by name: each worker resolves it itself
        name = None if device is None else str(device)
        jobs = [(abbr, spec, artifact_dir, name) for abbr in spec.workloads]
        with ctx.Pool(processes) as pool:
            done = pool.map(_worker, jobs)
        # store-mediated merge: read every worker's shard back from disk
        from repro_torch.workloads import registry

        store = ArtifactStore(artifact_dir)
        shards = []
        for abbr in done:
            shard = store.get_json(
                "validation", _shard_key(spec, registry.canonical_name(abbr))
            )
            if shard is None:
                raise RuntimeError(
                    f"worker shard for {abbr!r} missing from the store"
                )
            shards.append(shard)
    return _merge(shards, spec)


def save_results(summary: dict, path: str | os.PathLike) -> Path:
    """Atomically write the merged summary json (same fsync'd
    temp-file + replace discipline as the store's payloads)."""
    path = Path(path)
    blob = json.dumps(summary, indent=2, default=float).encode()
    atomic_write_bytes(path, blob)
    return path
