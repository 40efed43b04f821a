"""Validation report generator (port of ``repro/validate/report.py``) —
renders a merged runner summary into markdown, the same sections as the
reference's report.

The markdown is fully derived from the merged runner summary: matrix
description, per-architecture error tables (per workload, averaged
over core counts and strategies), the aggregate comparison against the
paper's claimed 1.23% hit-rate / 9.08% runtime errors, and the
incrementality counters.  Render one with::

    PYTHONPATH=src python -m repro_torch.validate.report \
        experiments/results/torch/validation_full.json <report.md>
"""
from __future__ import annotations

import json
from pathlib import Path

GENERATED_BANNER = (
    "<!-- GENERATED by repro_torch.validate.report from {src} — do not "
    "edit;\n     rerun `python -m repro_torch.validate` to refresh. -->"
)


def _fmt(x: float, digits: int = 2) -> str:
    return f"{x:.{digits}f}"


def _md_table(headers: list[str], rows: list[list[str]]) -> str:
    out = ["| " + " | ".join(headers) + " |",
           "|" + "|".join("---" for _ in headers) + "|"]
    out += ["| " + " | ".join(str(c) for c in row) + " |" for row in rows]
    return "\n".join(out)


def _workload_name(summary: dict, abbr: str) -> str:
    wls = summary.get("reference", {}).get("workloads", {})
    # Table-4 reference rows are keyed by bare abbreviation; registry
    # names carry a namespace prefix ("polybench/atx") to strip first
    ref = wls.get(abbr) or wls.get(abbr.rsplit("/", 1)[-1])
    return ref["name"] if ref else abbr


def _arch_section(summary: dict, arch: str) -> str:
    """Per-workload error table for one architecture: hit-rate error
    per level plus runtime error, averaged over cores x strategies."""
    levels: list[str] = []
    per_wl: dict[str, dict[str, list]] = {}
    for rec in summary["records"]:
        if rec["target"] != arch:
            continue
        slot = per_wl.setdefault(rec["workload"], {"rt": []})
        for lvl, entry in rec["levels"].items():
            if lvl not in levels:
                levels.append(lvl)
            slot.setdefault(lvl, []).append(entry["abs_err_pct"])
        slot["rt"].append(rec["runtime_rel_err_pct"])

    rows = []
    for abbr in sorted(per_wl):
        slot = per_wl[abbr]
        rows.append(
            [abbr, _workload_name(summary, abbr)]
            + [
                _fmt(sum(slot[lvl]) / len(slot[lvl]))
                if slot.get(lvl) else "-"
                for lvl in levels
            ]
            + [_fmt(sum(slot["rt"]) / len(slot["rt"]))]
        )
    agg = summary["aggregates"]["per_arch"][arch]
    claim_src = (
        summary["reference"]["per_arch"].get(arch, {}).get("source", "")
    )
    table = _md_table(
        ["abbr", "workload"]
        + [f"{lvl} hit err %" for lvl in levels]
        + ["runtime err %"],
        rows,
    )
    return "\n".join([
        f"### {arch}",
        "",
        table,
        "",
        f"Average over {agg['cells']} cells: hit-rate error "
        f"**{_fmt(agg['hit_rate_err_pct']['ours'])}%** "
        f"(paper: {_fmt(agg['hit_rate_err_pct']['paper'])}%, "
        f"{claim_src}), runtime error "
        f"**{_fmt(agg['runtime_err_pct']['ours'])}%** "
        f"(paper: {_fmt(agg['runtime_err_pct']['paper'])}%).",
    ])


def _runtime_models_section(summary: dict) -> str:
    """Side-by-side runtime-model comparison: every named stage-4 model
    scored with the same (SDCM rates vs exact rates) methodology."""
    models = summary["aggregates"].get("runtime_models", {})
    if not models:
        return ("## Runtime-model comparison\n\n"
                "This matrix predates the per-model runtime scoring — "
                "rerun `python -m repro_torch.validate` to populate it.")
    archs = sorted({a for m in models.values() for a in m["per_arch"]})
    refs = summary.get("reference", {}).get("runtime_models", {})
    rows = []
    for mname, entry in models.items():
        rows.append(
            [f"`{mname}`", _fmt(entry["overall_rel_err_pct"])]
            + [
                _fmt(entry["per_arch"][a]) if a in entry["per_arch"] else "-"
                for a in archs
            ]
            + [str(entry["cells"])]
        )
    parts = [
        "## Runtime-model comparison",
        "",
        "Every named stage-4 model (`docs/runtime.md`), scored per "
        "cell against one common reference — the per-target default "
        "chain (Eq. 4–7 on CPUs) evaluated with the exact-LRU hit "
        "rates, this container's stand-in for measured runtime.  "
        "Relative error in %:",
        "",
        _md_table(
            ["model", "overall err %"]
            + [f"{a} err %" for a in archs] + ["cells"],
            rows,
        ),
        "",
        "The runtime gate (`python -m repro_torch.validate --smoke "
        "--runtime-gate`) fails when `ecm` aggregate error exceeds "
        "`roofline` — the instruction-aware model must never be worse "
        "than the crude baseline.",
    ]
    if refs:
        parts += [""] + [
            f"* `{m}` — {src}" for m, src in sorted(refs.items())
            if m in models or m == "eq"
        ]
    return "\n".join(parts)


def _sampled_section(summary: dict) -> str:
    """SHARDS-sampled profile deviation vs the per-cell declared error
    bounds (the statistically gated check of ``docs/sampling.md``)."""
    sampled = summary["aggregates"].get("sampled_profile")
    if not sampled or not sampled.get("cells"):
        return ("## Sampled-profile deviation\n\n"
                "This matrix predates the sampled-profile check (or ran "
                "with `sampled_check=False`) — rerun "
                "`python -m repro_torch.validate` to populate it.")
    verdict = ("**within every declared bound**" if sampled["within_bound"]
               else f"**{sampled['bound_exceedances']} cell(s) EXCEEDED "
                    "their declared bound**")
    return "\n".join([
        "## Sampled-profile deviation",
        "",
        "Every cell also runs through a SHARDS-sampled Session "
        f"(rate R = {sampled.get('rate')}, `docs/sampling.md`); its "
        "SDCM hit rates are scored against the exact-profile "
        "prediction.  Unlike the binned check's fixed 1e-3 tolerance, "
        "each level cell is gated against the Bernstein cluster-"
        "sampling bound its own profile declares (`repro_torch.core."
        "reuse.sampled.sampling_error_bound`), including the Hajek ratio "
        "correction that widens the bound when the spatial filter "
        "drops a mass-dominant line:",
        "",
        _md_table(
            ["level cells", "max abs dev", "mean abs dev",
             "max declared bound", "mean declared bound"],
            [[str(sampled["cells"]),
              f"{sampled['max_abs_dev']:.2e}",
              f"{sampled['mean_abs_dev']:.2e}",
              f"{sampled['max_declared_bound']:.2e}",
              f"{sampled['mean_declared_bound']:.2e}"]],
        ),
        "",
        f"Result: {verdict}.  The sampling gate "
        "(`python -m repro_torch.validate --smoke --sampling-gate`) fails on "
        "any exceedance — and reruns the matrix against the same store "
        "to assert the sampled cells persist under their own "
        "`+sampled{R}` keys (zero rebuilds on run 2).",
    ])


def render_markdown(summary: dict, source_name: str) -> str:
    agg = summary["aggregates"]["overall"]
    stats = summary.get("session_stats", {})
    sizes = summary["spec"].get("sizes") or "default"

    agg_rows = []
    for arch, entry in sorted(summary["aggregates"]["per_arch"].items()):
        agg_rows.append([
            arch,
            _fmt(entry["hit_rate_err_pct"]["ours"]),
            _fmt(entry["hit_rate_err_pct"]["paper"]),
            _fmt(entry["hit_rate_err_pct"]["delta"], 2),
            _fmt(entry["runtime_err_pct"]["ours"]),
            _fmt(entry["runtime_err_pct"]["paper"]),
            _fmt(entry["runtime_err_pct"]["delta"], 2),
        ])
    agg_rows.append([
        "**overall**",
        f"**{_fmt(agg['hit_rate_err_pct']['ours'])}**",
        f"**{_fmt(agg['hit_rate_err_pct']['paper'])}**",
        f"**{_fmt(agg['hit_rate_err_pct']['delta'], 2)}**",
        f"**{_fmt(agg['runtime_err_pct']['ours'])}**",
        f"**{_fmt(agg['runtime_err_pct']['paper'])}**",
        f"**{_fmt(agg['runtime_err_pct']['delta'], 2)}**",
    ])

    level_rows = [
        [lvl, _fmt(err)]
        for lvl, err in summary["aggregates"]["per_level_hit_err_pct"].items()
    ]

    wl_rows = [
        [abbr, _workload_name(summary, abbr), f"{entry['refs']:,}",
         _fmt(entry["avg_hit_err_pct"]), _fmt(entry["avg_runtime_err_pct"])]
        for abbr, entry in sorted(summary["per_workload"].items())
    ]

    parts = [
        GENERATED_BANNER.format(src=source_name),
        "",
        "# Validation report — the paper matrix, reproduced",
        "",
        f"Matrix: {summary['description']} — "
        f"{agg['cells']} grid cells (matrix id `{summary['matrix_id']}`).",
        "",
        "Methodology (see `docs/architecture.md` and "
        "`src/repro_torch/validate/reference.py`): the container has no PAPI "
        "counters or multicore hardware, so each cell scores the "
        "analytical SDCM prediction against the **exact set-associative "
        "LRU simulation** of the same mimicked traces (hit rates, "
        "absolute error in %), and the Eq. 4–7 runtime chain with SDCM "
        "rates against the same chain with exact rates (relative error "
        "in %).  Workload inputs run at the scaled-down "
        f"`{sizes}` size preset "
        "(`repro_torch.workloads.polybench.SIZE_PRESETS`); the statistic that "
        "carries over to the paper is the *error aggregate*, compared "
        "against the paper's claimed per-architecture averages.",
        "",
        "## Aggregate errors vs the paper",
        "",
        _md_table(
            ["architecture",
             "hit err % (ours)", "hit err % (paper)", "Δ",
             "runtime err % (ours)", "runtime err % (paper)", "Δ"],
            agg_rows,
        ),
        "",
        "Paper claims: **1.23%** average hit-rate error and **9.08%** "
        "average runtime error (abstract; per-architecture rows from "
        "Tables 6–8 / Figs. 8–10, transcribed in "
        "`repro_torch/validate/reference.py`).",
        "",
        "Negative Δ means this reproduction's SDCM-vs-exact error is "
        "*smaller* than the paper's SDCM-vs-hardware error.  Expected: "
        "the scaled-down working sets mostly fit in the upper cache "
        "levels, where the SDCM binomial model is nearly exact, and the "
        "exact-LRU baseline removes the hardware noise (prefetchers, "
        "replacement approximations, TLBs) PAPI counters include.  The "
        "paper's weak spots (gramschmidt/symm L2) only emerge at "
        "L2-pressure-scale inputs.",
        "",
        "## Hit-rate error by cache level",
        "",
        _md_table(["level", "avg abs err %"], level_rows),
        "",
        _runtime_models_section(summary),
        "",
        _sampled_section(summary),
        "",
        "## Per-workload summary",
        "",
        _md_table(
            ["abbr", "workload", "trace refs",
             "avg hit err %", "avg runtime err %"],
            wl_rows,
        ),
        "",
        "Workload abbreviations are decoded in `docs/workloads.md`; "
        "known paper weak spots (gramschmidt/symm L2) are flagged in "
        "`reference.PAPER_KNOWN_WEAK_SPOTS`.",
        "",
        "## Per-architecture detail",
        "",
    ]
    for arch in sorted(summary["aggregates"]["per_arch"]):
        parts += [_arch_section(summary, arch), ""]

    parts += [
        "## Incrementality",
        "",
        f"Reuse-profile builds this run: "
        f"**{stats.get('profile_builds', 0)}** "
        f"(disk-store hits: {stats.get('store_hits', 0)}, write-backs: "
        f"{stats.get('store_puts', 0)}).  With a shared `artifact_dir` "
        "the second run of this matrix performs **zero** reuse-profile "
        "recomputations — asserted by "
        "`tests/test_torch_validate.py` and "
        "`python -m repro_torch.validate --smoke`.",
        "",
        f"Full per-cell records: `experiments/results/torch/{source_name}`.",
        "",
    ]
    return "\n".join(parts)


def generate_report(results_path: str | Path, md_path: str | Path) -> Path:
    results_path, md_path = Path(results_path), Path(md_path)
    summary = json.loads(results_path.read_text())
    md = render_markdown(summary, results_path.name)
    md_path.parent.mkdir(parents=True, exist_ok=True)
    md_path.write_text(md)
    return md_path


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 3:
        raise SystemExit("usage: python -m repro_torch.validate.report "
                         "<results.json> <report.md>")
    print(f"wrote {generate_report(sys.argv[1], sys.argv[2])}")
