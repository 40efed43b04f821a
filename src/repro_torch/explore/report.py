"""Best-configs report generation (markdown/JSON) — port of
``repro/explore/report.py``.

`write_result` lands each search under
``<out_dir>/explore_<workload>__<agent>__<key>.json``; `render_markdown`
turns a list of results into the table that ``python -m
repro_torch.explore --update-doc --doc PATH`` splices into a document
between the GENERATED markers.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

GENERATED_BEGIN = "<!-- explore:generated:begin -->"
GENERATED_END = "<!-- explore:generated:end -->"

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def _slug(name: str) -> str:
    return _SLUG_RE.sub("-", name).strip("-")


def result_path(result: dict, out_dir: Path) -> Path:
    tag = (f"explore_{_slug(result['workload'])}"
           f"__{result['agent']}__{result['key'][:8]}")
    return Path(out_dir) / f"{tag}.json"


def write_result(result: dict, out_dir) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = result_path(result, out_dir)
    path.write_text(json.dumps(result, indent=2, default=float) + "\n")
    return path


def _fmt_config(cfg: dict) -> str:
    kib = cfg["size_bytes"] / 1024
    cap = f"{kib / 1024:g} MiB" if kib >= 1024 else f"{kib:g} KiB"
    return (f"{cfg['sets']}x{cfg['ways']}w/{cfg['line_size']}B ({cap}), "
            f"d={cfg['latency_cy']:g}cy b={cfg['beta_cy']:g}cy, "
            f"{cfg['cores']}c {cfg['strategy']}")


def _fmt_score(result: dict, score: float) -> str:
    if result["objective"] == "runtime":
        return f"{score:.3e} s"
    return f"{score:.4f} miss"


def render_markdown(results: list[dict]) -> str:
    """One summary row per search plus a top-configs table each."""
    lines = [
        "| workload | agent | space | evals | best config | best score |",
        "|---|---|---|---|---|---|",
    ]
    for r in results:
        traj = r["trajectory"]
        lines.append(
            f"| `{r['workload']}` | {r['agent']} | {r['space_size']} "
            f"configs | {traj['evaluations']}/{r['budget']} "
            f"| {_fmt_config(r['best']['config'])} "
            f"| {_fmt_score(r, r['best']['score'])} |"
        )
    for r in results:
        lines += [
            "",
            f"### `{r['workload']}` — {r['agent']} "
            f"(objective: {r['objective']})",
            "",
            "| rank | config | score |",
            "|---|---|---|",
        ]
        for rank, row in enumerate(r["top"][:5], start=1):
            lines.append(
                f"| {rank} | {_fmt_config(row['config'])} "
                f"| {_fmt_score(r, row['score'])} |"
            )
        stats = r["stats"]
        lines += [
            "",
            f"{stats['configs_scored']} configs scored in "
            f"{stats['fused_dispatches']} fused dispatches "
            f"({stats['kernel_compiles']} new kernel compilations, "
            f"{stats['profile_groups']} profile packs).",
        ]
    return "\n".join(lines) + "\n"


def update_doc(doc_path, results: list[dict]) -> None:
    """Replace the GENERATED section of the document at ``doc_path``
    in place."""
    doc_path = Path(doc_path)
    text = doc_path.read_text()
    if GENERATED_BEGIN not in text or GENERATED_END not in text:
        raise ValueError(
            f"{doc_path} is missing the explore:generated markers"
        )
    head, rest = text.split(GENERATED_BEGIN, 1)
    _old, tail = rest.split(GENERATED_END, 1)
    body = render_markdown(results)
    doc_path.write_text(
        head + GENERATED_BEGIN + "\n" + body + GENERATED_END + tail
    )


__all__ = [
    "GENERATED_BEGIN",
    "GENERATED_END",
    "render_markdown",
    "result_path",
    "update_doc",
    "write_result",
]
