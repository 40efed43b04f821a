"""Every case of ``tests/lint/`` through ``repro_torch.lint``, with the
same expectations, and at every lint the port's findings held field for
field (fingerprints included) to the reference's on the same file.

The cases are the reference's own test functions, loaded from
``tests/lint/`` and run with the port's entry points in place of the
reference's; each one is a parametrised case here.  One case is not
reused as is: ``test_registry_shape`` asserts the reference's four
families, and the port has a fifth (TS), so it is restated below for
the port.
"""
from __future__ import annotations

import importlib.util
import inspect
import textwrap
from pathlib import Path

import pytest

from repro.lint import engine as ref_engine
from repro.lint.rules import RULES as REF_RULES
from repro_torch.lint import baseline as port_baseline
from repro_torch.lint import cli as port_cli
from repro_torch.lint import engine as port_engine
from repro_torch.lint import rules as port_rules

LINT_TESTS = Path(__file__).resolve().parent / "lint"
MODULES = ("test_cache_keys", "test_concurrency", "test_donation",
           "test_engine_cli", "test_jax_purity")
RESTATED = {"test_registry_shape"}
REF_FAMILIES = ("JP", "DN", "CC", "CK")


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_lint_cases.{name}", LINT_TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the port's entry points in place of the reference's
    for attr, value in (
            ("lint_paths", port_engine.lint_paths),
            ("main", port_cli.main),
            ("apply_baseline", port_baseline.apply_baseline),
            ("load_baseline", port_baseline.load_baseline),
            ("write_baseline", port_baseline.write_baseline),
            ("RULES", port_rules.RULES),
            ("SEVERITIES", port_rules.SEVERITIES),
            ("rules_by_family", port_rules.rules_by_family)):
        if hasattr(mod, attr):
            setattr(mod, attr, value)
    return mod


def _cases():
    out = []
    for name in MODULES:
        mod = _load(name)
        for fname, fn in inspect.getmembers(mod, inspect.isfunction):
            if not fname.startswith("test_") or fname in RESTATED \
                    or fn.__module__ != mod.__name__:
                continue
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                out.append(pytest.param(fn, {}, id=f"{name}::{fname}"))
                continue
            (mark,) = marks
            argname, values = mark.args
            for v in values:
                out.append(pytest.param(fn, {argname: v},
                                        id=f"{name}::{fname}[{v}]"))
    return out


def _fields(f) -> tuple:
    return (f.rule_id, f.severity, f.path, f.line, f.col, f.message,
            f.line_text, f.fingerprint())


def assert_parity(paths, root):
    """The port's findings restricted to the reference's families equal
    the reference's, field for field; the port adds none of its own
    where nothing imports torch."""
    want = ref_engine.lint_paths(paths, root=root)
    got = port_engine.lint_paths(paths, root=root)
    mine = [f for f in got.findings if f.rule_id[:2] in REF_FAMILIES]
    assert [_fields(f) for f in mine] == [_fields(f) for f in want.findings]
    assert got.files_checked == want.files_checked
    assert got.parse_errors == want.parse_errors
    ts_suppressed = sum(n for r, n in got.suppressed_by_rule.items()
                        if r[:2] not in REF_FAMILIES)
    assert got.suppressed - ts_suppressed == want.suppressed
    return got


@pytest.fixture
def lint_source(tmp_path):
    def run(source: str, name: str = "snippet.py"):
        path = tmp_path / name
        path.write_text(textwrap.dedent(source))
        return assert_parity([path], tmp_path)

    return run


@pytest.fixture
def rule_ids(lint_source):
    def run(source: str, name: str = "snippet.py"):
        return sorted(f.rule_id for f in lint_source(source, name).findings)

    return run


@pytest.mark.parametrize("fn,params", _cases())
def test_reference_lint_case(fn, params, tmp_path, capsys, lint_source,
                             rule_ids):
    available = dict(tmp_path=tmp_path, capsys=capsys,
                     lint_source=lint_source, rule_ids=rule_ids, **params)
    fn(**{p: available[p] for p in inspect.signature(fn).parameters})


def test_every_reference_case_is_run():
    """72 test functions in ``tests/lint/``; one restated, one
    parametrised over four families."""
    ids = [c.id for c in _cases()]
    assert len(ids) == len(set(ids)) == 74
    assert not any("test_registry_shape" in i for i in ids)


def test_registry_shape():
    """The reference's registry check for the port: every rule well
    formed, the reference's 14 rules unchanged field for field, and the
    port's families the reference's four plus TS."""
    rules = port_rules.RULES
    for rid, rule in rules.items():
        assert rule.id == rid
        assert rule.severity in port_rules.SEVERITIES
        assert rule.summary and rule.fix_hint
    assert len(REF_RULES) == 14
    for rid, ref in REF_RULES.items():
        got = rules[rid]
        assert (got.name, got.severity, got.summary, got.fix_hint) == (
            ref.name, ref.severity, ref.summary, ref.fix_hint)
    assert set(port_rules.rules_by_family()) == {"JP", "DN", "CC", "CK",
                                                 "TS"}
    assert sorted(set(rules) - set(REF_RULES)) == ["TS102", "TS103",
                                                   "TS110"]
