"""Committed-baseline support: accept known findings, fail on new ones —
port of ``repro/lint/baseline.py``, same format and version: either
linter reads the other's baseline.

A baseline is a JSON file mapping finding fingerprints (rule + file +
line *content* + occurrence index — stable across line-number drift) to
a human-readable record.  ``--write-baseline`` snapshots the current
findings; ``--check`` fails only on findings whose fingerprint is not
in the baseline, and reports (without failing) baseline entries that no
longer match anything so the file shrinks over time.

Repo convention: the committed baseline should be empty — genuine
findings get fixed, deliberate exceptions get an inline
``# repro-lint: disable=RULE -- reason`` suppression next to the code
they excuse.  The baseline exists for incremental adoption (landing
the linter before a large fix-up) and for rules added faster than
their findings can be burned down.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

from repro_torch.lint.engine import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = ".repro-lint-baseline.json"


def fingerprints(findings: list[Finding]) -> dict[str, Finding]:
    """Fingerprint every finding, disambiguating identical lines by
    occurrence index (two copies of one offending line get two
    entries)."""
    seen: Counter = Counter()
    out: dict[str, Finding] = {}
    for f in findings:
        key = (f.rule_id, f.path, f.line_text)
        out[f.fingerprint(seen[key])] = f
        seen[key] += 1
    return out


def write_baseline(path: str | Path, findings: list[Finding]) -> dict:
    entries = {
        fp: {"rule": f.rule_id, "path": f.path, "line_text": f.line_text}
        for fp, f in fingerprints(findings).items()
    }
    payload = {"version": BASELINE_VERSION, "entries": entries}
    Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True)
                          + "\n")
    return payload


def load_baseline(path: str | Path) -> dict[str, dict]:
    p = Path(path)
    if not p.is_file():
        return {}
    payload = json.loads(p.read_text())
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {p} has version {payload.get('version')!r}; "
            f"this tool writes version {BASELINE_VERSION} — regenerate "
            f"with --write-baseline"
        )
    return dict(payload.get("entries", {}))


@dataclasses.dataclass
class BaselineDiff:
    new: list[Finding]          # findings not covered by the baseline
    accepted: list[Finding]     # findings the baseline covers
    stale: list[str]            # baseline fingerprints matching nothing


def apply_baseline(findings: list[Finding],
                   entries: dict[str, dict]) -> BaselineDiff:
    fps = fingerprints(findings)
    new = [f for fp, f in fps.items() if fp not in entries]
    accepted = [f for fp, f in fps.items() if fp in entries]
    stale = sorted(fp for fp in entries if fp not in fps)
    new.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return BaselineDiff(new=new, accepted=accepted, stale=stale)
