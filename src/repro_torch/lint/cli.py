"""``python -m repro_torch.lint`` command line — port of
``repro/lint/cli.py``, with the same exit codes, output and options.

Exit-code contract (what CI keys on):

* ``0`` — no findings, or every finding is covered by the baseline
  (``--report-only`` always exits 0).
* ``1`` — at least one unbaselined finding.
* ``2`` — a file failed to parse, the baseline is unreadable, or the
  arguments are inconsistent.

Typical invocations::

    python -m repro_torch.lint src tools                  # human output
    python -m repro_torch.lint --json src                 # machine output
    python -m repro_torch.lint --check --baseline .repro-lint-baseline.json src tools
    python -m repro_torch.lint --write-baseline --baseline FILE src
    python -m repro_torch.lint --report-only tests        # inventory, exit 0
    python -m repro_torch.lint --list-rules
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.lint.baseline import (
    DEFAULT_BASELINE,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from repro_torch.lint.engine import lint_paths
from repro_torch.lint.rules import RULES, rules_by_family

_FAMILY_TITLES = {
    "JP": "jax-purity",
    "DN": "donation",
    "CC": "concurrency",
    "CK": "cache-keys",
    "TS": "torch-sync",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="repro-lint",
        description="Project-specific static analysis: JAX purity, "
                    "buffer donation, lock discipline, cache-key "
                    "invariants, torch host syncs in loops.",
    )
    p.add_argument("paths", nargs="*",
                   help="files or directories to lint (default: src/ "
                        "and tools/ if they exist)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as JSON")
    p.add_argument("--baseline", metavar="FILE", nargs="?",
                   const=DEFAULT_BASELINE, default=None,
                   help=f"baseline file (default when given bare: "
                        f"{DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current findings into the baseline "
                        "and exit 0")
    p.add_argument("--check", action="store_true",
                   help="fail (exit 1) on findings not covered by the "
                        "baseline")
    p.add_argument("--report-only", action="store_true",
                   help="print findings but always exit 0 (inventory "
                        "mode)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def _list_rules() -> None:
    for family, rules in rules_by_family().items():
        print(f"{family} ({_FAMILY_TITLES.get(family, family)})")
        for r in rules:
            print(f"  {r.id} [{r.severity:7s}] {r.name}: {r.summary}")


def main(argv: list[str] | None = None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        _list_rules()
        return 0

    paths = args.paths or [p for p in ("src", "tools") if Path(p).is_dir()]
    if not paths:
        print("repro-lint: no paths given and no src/ or tools/ here",
              file=sys.stderr)
        return 2

    result = lint_paths(paths)
    for err in result.parse_errors:
        print(f"repro-lint: parse error: {err}", file=sys.stderr)

    baseline_path = args.baseline
    if baseline_path is None and not args.write_baseline \
            and Path(DEFAULT_BASELINE).is_file():
        baseline_path = DEFAULT_BASELINE

    if args.write_baseline:
        target = baseline_path or DEFAULT_BASELINE
        payload = write_baseline(target, result.findings)
        print(f"repro-lint: wrote {len(payload['entries'])} baseline "
              f"entr{'y' if len(payload['entries']) == 1 else 'ies'} "
              f"to {target}")
        return 0 if not result.parse_errors else 2

    entries = {}
    if baseline_path is not None:
        try:
            entries = load_baseline(baseline_path)
        except (ValueError, OSError, json.JSONDecodeError) as exc:
            print(f"repro-lint: bad baseline: {exc}", file=sys.stderr)
            return 2
    diff = apply_baseline(result.findings, entries)

    if args.as_json:
        payload = result.to_dict()
        payload["new_findings"] = [f.to_dict() for f in diff.new]
        payload["baselined"] = len(diff.accepted)
        payload["stale_baseline_entries"] = diff.stale
        print(json.dumps(payload, indent=2))
    else:
        for f in diff.new:
            print(f.render())
            if f.rule.fix_hint:
                print(f"    hint: {f.rule.fix_hint}")
        summary = (f"repro-lint: {result.files_checked} files, "
                   f"{len(diff.new)} finding(s)")
        if diff.accepted:
            summary += f", {len(diff.accepted)} baselined"
        if result.suppressed:
            summary += f", {result.suppressed} suppressed inline"
        if diff.stale:
            summary += (f", {len(diff.stale)} stale baseline entr"
                        f"{'y' if len(diff.stale) == 1 else 'ies'} "
                        f"(regenerate with --write-baseline)")
        print(summary)

    if result.parse_errors:
        return 2
    if args.report_only:
        return 0
    return 1 if diff.new else 0


if __name__ == "__main__":
    raise SystemExit(main())
