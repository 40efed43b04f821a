"""Lint engine: file walking, suppression comments, finding plumbing —
port of ``repro/lint/engine.py``.  The suppression marker and the
fingerprint are the reference's, so a comment or a baseline entry means
the same to both linters.

The engine owns everything rule-agnostic: parsing each file once into a
:class:`ModuleContext`, running every registered analyzer over it,
filtering ``# repro-lint: disable=RULE`` suppressions, and stamping
each surviving :class:`Finding` with a line-content fingerprint (stable
across unrelated line-number drift) that the baseline machinery keys
on.

Suppression grammar (checked on the finding's line, the line above it,
and file-wide):

    x = something()          # repro-lint: disable=JP102
    # repro-lint: disable=CC301  -- justification for the next line
    # repro-lint: disable-file=CK403  -- justification (whole file)

A bare ``disable=`` with no justification still works — but the
repo convention (enforced by review, not the tool) is that every
suppression carries a reason after ``--``.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from collections import Counter
from pathlib import Path

from repro_torch.lint.rules import RULES, Rule

_DISABLE_RE = re.compile(
    r"#\s*repro-lint:\s*disable=([A-Za-z0-9*,\s]+?)(?:\s*--.*)?$"
)
_DISABLE_FILE_RE = re.compile(
    r"#\s*repro-lint:\s*disable-file=([A-Za-z0-9*,\s]+?)(?:\s*--.*)?$"
)

_SKIP_DIRS = {"__pycache__", ".git", ".venv", "node_modules", ".pytest_cache"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule_id: str
    path: str                  # posix-relative to the lint root
    line: int
    col: int
    message: str
    line_text: str = ""        # stripped source line (fingerprint input)

    @property
    def rule(self) -> Rule:
        return RULES[self.rule_id]

    @property
    def severity(self) -> str:
        return self.rule.severity

    def fingerprint(self, occurrence: int = 0) -> str:
        """Stable identity for baselining: rule + file + line *content*
        (not number) + occurrence index among identical lines — so
        unrelated edits shifting line numbers don't churn the baseline.
        """
        blob = f"{self.rule_id}|{self.path}|{self.line_text}|{occurrence}"
        return hashlib.sha1(blob.encode()).hexdigest()[:20]

    def to_dict(self) -> dict:
        return {
            "rule": self.rule_id,
            "severity": self.severity,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "fix_hint": self.rule.fix_hint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule_id} [{self.severity}] {self.message}")


def _parse_disables(blob: str) -> set[str]:
    return {tok.strip() for tok in blob.split(",") if tok.strip()}


class ModuleContext:
    """One parsed source file plus its suppression map."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        self._line_disables: dict[int, set[str]] = {}
        self._file_disables: set[str] = set()
        for i, line in enumerate(self.lines, start=1):
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self._file_disables |= _parse_disables(m.group(1))
                continue
            m = _DISABLE_RE.search(line)
            if m:
                self._line_disables[i] = _parse_disables(m.group(1))

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def _match(self, rules: set[str], rule_id: str) -> bool:
        return "*" in rules or rule_id in rules or rule_id[:2] in rules

    def suppressed(self, rule_id: str, line: int) -> bool:
        """A rule is suppressed on its own line, by a comment-only line
        directly above, or file-wide."""
        if self._match(self._file_disables, rule_id):
            return True
        for cand in (line, line - 1):
            rules = self._line_disables.get(cand)
            if rules is None:
                continue
            if cand == line - 1:
                # the line above only scopes to the next line when it is
                # a pure comment (otherwise it suppresses itself only)
                text = self.line_text(cand)
                if not text.startswith("#"):
                    continue
            if self._match(rules, rule_id):
                return True
        return False

    def finding(self, rule_id: str, node: ast.AST | tuple[int, int],
                message: str) -> Finding:
        if isinstance(node, tuple):
            line, col = node
        else:
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
        return Finding(rule_id, self.rel, line, col, message,
                       self.line_text(line))


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    files_checked: int = 0
    suppressed: int = 0
    parse_errors: list[str] = dataclasses.field(default_factory=list)
    # inline suppressions by rule id (not in to_dict: the JSON output
    # stays the reference's)
    suppressed_by_rule: Counter = dataclasses.field(default_factory=Counter)

    def to_dict(self) -> dict:
        return {
            "files_checked": self.files_checked,
            "suppressed": self.suppressed,
            "parse_errors": self.parse_errors,
            "findings": [f.to_dict() for f in self.findings],
        }


def iter_python_files(paths: list[Path]) -> list[Path]:
    out: list[Path] = []
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            out.append(p)
        elif p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if not any(part in _SKIP_DIRS or part.startswith(".")
                           for part in f.parts):
                    out.append(f)
    return out


def _analyzers():
    from repro_torch.lint.analyzers import ALL_ANALYZERS

    return ALL_ANALYZERS


def lint_paths(paths: list[str | Path], *,
               root: str | Path | None = None) -> LintResult:
    """Lint every ``.py`` under ``paths``; findings are reported with
    paths relative to ``root`` (default: the current directory)."""
    root = Path(root) if root is not None else Path.cwd()
    result = LintResult(findings=[])
    for file in iter_python_files([Path(p) for p in paths]):
        try:
            rel = file.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = file.as_posix()
        try:
            ctx = ModuleContext(file, rel, file.read_text())
        except (SyntaxError, UnicodeDecodeError, OSError) as exc:
            result.parse_errors.append(f"{rel}: {exc}")
            continue
        result.files_checked += 1
        for analyze in _analyzers():
            for finding in analyze(ctx):
                if ctx.suppressed(finding.rule_id, finding.line):
                    result.suppressed += 1
                    result.suppressed_by_rule[finding.rule_id] += 1
                else:
                    result.findings.append(finding)
    result.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule_id))
    return result
