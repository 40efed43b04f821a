"""``repro_torch.lint`` against ``repro.lint`` on the repo's own trees,
and the repo's lint gate.

* The gate: ``python -m repro.lint --check --baseline
  .repro-lint-baseline.json src tools tests`` (CI's lint job) finds
  nothing the committed, empty baseline does not cover; the port's
  linter with the same arguments neither.
* Tree parity: on ``src/repro``, ``src/repro_torch``, ``tools`` and
  ``tests`` the port's JP, DN, CC and CK findings equal the reference's
  field for field, fingerprints included, both before inline
  suppressions (each analyzer on each file) and after them.
* The CLI: the same exit codes and the same ``--json`` output on those
  trees and on seeded ones, restricted to the four families;
  ``--list-rules`` prints the reference's catalogue plus TS's.
* Baselines: either linter reads the other's.
"""
from __future__ import annotations

import json
import textwrap
from pathlib import Path

import pytest

from repro.lint import baseline as ref_baseline
from repro.lint import cli as ref_cli
from repro.lint import engine as ref_engine
from repro.lint.analyzers import ALL_ANALYZERS as REF_ANALYZERS
from repro_torch.lint import baseline as port_baseline
from repro_torch.lint import cli as port_cli
from repro_torch.lint import engine as port_engine
from repro_torch.lint.analyzers import (
    cache_keys,
    concurrency,
    donation,
    jax_purity,
)

ROOT = Path(__file__).resolve().parents[1]
LINT_PATHS = ("src", "tools", "tests")
TREES = ("src/repro", "src/repro_torch", "tools", "tests")
BASELINE = ROOT / ".repro-lint-baseline.json"
REF_FAMILIES = ("JP", "DN", "CC", "CK")
PORT_ANALYZERS = (jax_purity.analyze, donation.analyze, concurrency.analyze,
                  cache_keys.analyze)


def fields(f) -> tuple:
    return (f.rule_id, f.severity, f.path, f.line, f.col, f.message,
            f.line_text)


def four(findings) -> list:
    return [f for f in findings if f.rule_id[:2] in REF_FAMILIES]


@pytest.fixture(scope="module")
def linted():
    """Both linters over src, tools and tests, as CI runs them."""
    paths = [ROOT / p for p in LINT_PATHS]
    return (ref_engine.lint_paths(paths, root=ROOT),
            port_engine.lint_paths(paths, root=ROOT))


# -- the gate ------------------------------------------------------------------


def test_baseline_is_empty():
    assert json.loads(BASELINE.read_text()) == {"entries": {}, "version": 1}


@pytest.mark.parametrize("which", ["reference", "port"])
def test_lint_gate_finds_nothing_unbaselined(linted, which):
    """CI's lint job, in tier 1: no finding outside the (empty) baseline
    and no parse error, for the reference's linter and for the port's."""
    res = linted[0] if which == "reference" else linted[1]
    bl = ref_baseline if which == "reference" else port_baseline
    diff = bl.apply_baseline(res.findings, bl.load_baseline(BASELINE))
    assert not res.parse_errors
    assert [f.render() for f in diff.new] == []
    assert res.files_checked > 300


# -- tree parity ---------------------------------------------------------------


@pytest.mark.parametrize("tree", TREES)
def test_findings_after_suppression_equal(linted, tree):
    ref, port = linted
    want = [f for f in ref.findings if f.path.startswith(tree + "/")]
    got = [f for f in four(port.findings) if f.path.startswith(tree + "/")]
    assert [fields(f) for f in got] == [fields(f) for f in want]
    fp_want = ref_baseline.fingerprints(want)
    fp_got = port_baseline.fingerprints(got)
    assert list(fp_got) == list(fp_want)


@pytest.mark.parametrize("tree", TREES)
def test_raw_findings_equal_file_by_file(tree):
    """Each family's analyzer on each file of ``tree``, suppressions not
    applied: the suppressed findings (the repairs' inline exceptions)
    are compared too."""
    files = ref_engine.iter_python_files([ROOT / tree])
    assert files
    total = 0
    for path in files:
        rel = path.relative_to(ROOT).as_posix()
        text = path.read_text()
        rctx = ref_engine.ModuleContext(path, rel, text)
        pctx = port_engine.ModuleContext(path, rel, text)
        for ref_an, port_an in zip(REF_ANALYZERS, PORT_ANALYZERS):
            want = ref_an(rctx)
            got = port_an(pctx)
            assert [fields(f) + (f.fingerprint(),) for f in got] == \
                [fields(f) + (f.fingerprint(),) for f in want], rel
            assert [pctx.suppressed(f.rule_id, f.line) for f in got] == \
                [rctx.suppressed(f.rule_id, f.line) for f in want], rel
            total += len(want)
    if tree in ("src/repro", "src/repro_torch", "tests"):
        assert total > 0  # the trees' suppressed exceptions are compared


def test_suppressed_counts_differ_by_ts_alone(linted):
    ref, port = linted
    ts = sum(n for r, n in port.suppressed_by_rule.items() if r[:2] == "TS")
    assert ts > 0
    assert port.suppressed - ts == ref.suppressed
    assert port.files_checked == ref.files_checked


# -- the CLI -------------------------------------------------------------------


JP_BAD = """
    import jax

    @jax.jit
    def f(x):
        return float(x)
"""
CK_BAD = """
    def cell_key(tid, seed):
        return f"{tid}"
"""


def _json_four(out: str) -> dict:
    payload = json.loads(out)
    for key in ("findings", "new_findings"):
        payload[key] = [f for f in payload[key]
                        if f["rule"][:2] in REF_FAMILIES]
    payload.pop("suppressed")
    return payload


def _both(args, capsys) -> tuple:
    rc_ref = ref_cli.main(list(args))
    out_ref = capsys.readouterr()
    rc_port = port_cli.main(list(args))
    out_port = capsys.readouterr()
    return rc_ref, out_ref, rc_port, out_port


@pytest.mark.parametrize("args", [
    ("--json", "--check", "--baseline", ".repro-lint-baseline.json",
     *TREES),
    ("--check", "--baseline", ".repro-lint-baseline.json", *LINT_PATHS),
], ids=["json", "check"])
def test_cli_on_the_repo_trees(args, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc_ref, out_ref, rc_port, out_port = _both(args, capsys)
    assert rc_ref == rc_port == 0
    if "--json" in args:
        assert _json_four(out_port.out) == _json_four(out_ref.out)
    else:
        assert "0 finding(s)" in out_port.out
        assert out_port.out.split(",")[:2] == out_ref.out.split(",")[:2]


@pytest.mark.parametrize("case", [
    "clean", "jp", "ck", "parse_error", "report_only", "baseline_check",
    "bad_baseline",
])
def test_cli_exit_codes_and_output_equal(case, tmp_path, capsys,
                                         monkeypatch):
    """The 0/1/2 contract and the output, both linters, on the same
    seeded trees."""
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "tree"
    src.mkdir()
    body = {"clean": "x = 1\n", "jp": JP_BAD, "ck": CK_BAD,
            "parse_error": "def broken(:\n", "report_only": JP_BAD,
            "baseline_check": JP_BAD, "bad_baseline": JP_BAD}[case]
    (src / "mod.py").write_text(textwrap.dedent(body))
    args = ["--json", "tree"]
    if case == "report_only":
        args = ["--report-only", "tree"]
    elif case == "baseline_check":
        assert ref_cli.main(["--write-baseline", "--baseline", "bl.json",
                             "tree"]) == 0
        (src / "other.py").write_text(textwrap.dedent(CK_BAD))
        args = ["--check", "--baseline", "bl.json", "--json", "tree"]
    elif case == "bad_baseline":
        (tmp_path / "bl.json").write_text('{"version": 99, "entries": {}}')
        args = ["--check", "--baseline", "bl.json", "tree"]
    capsys.readouterr()
    rc_ref, out_ref, rc_port, out_port = _both(args, capsys)
    assert rc_port == rc_ref == {"clean": 0, "jp": 1, "ck": 1,
                                 "parse_error": 2, "report_only": 0,
                                 "baseline_check": 1,
                                 "bad_baseline": 2}[case]
    assert out_port.out == out_ref.out
    assert out_port.err == out_ref.err


def test_cli_write_baseline_equal(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "mod.py").write_text(textwrap.dedent(JP_BAD)
                                     + textwrap.dedent(CK_BAD))
    assert ref_cli.main(["--write-baseline", "--baseline", "ref.json",
                         "mod.py"]) == 0
    assert port_cli.main(["--write-baseline", "--baseline", "port.json",
                          "mod.py"]) == 0
    assert (tmp_path / "ref.json").read_text() == \
        (tmp_path / "port.json").read_text()
    assert json.loads((tmp_path / "ref.json").read_text())["entries"]


def test_list_rules_is_the_reference_catalogue_plus_ts(capsys):
    assert ref_cli.main(["--list-rules"]) == 0
    ref_out = capsys.readouterr().out
    assert port_cli.main(["--list-rules"]) == 0
    port_out = capsys.readouterr().out
    assert port_out.startswith(ref_out)
    tail = port_out[len(ref_out):].splitlines()
    assert tail[0] == "TS (torch-sync)"
    assert [ln.split()[0] for ln in tail[1:]] == ["TS102", "TS103", "TS110"]


# -- baselines across the two linters ------------------------------------------


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_baseline_round_trip_across_linters(writer, tmp_path):
    """A baseline written by one linter covers the other's findings on
    the same tree, and a new finding is new to both."""
    (tmp_path / "a.py").write_text(textwrap.dedent(JP_BAD))
    (tmp_path / "b.py").write_text(textwrap.dedent(CK_BAD))
    ref = ref_engine.lint_paths([tmp_path], root=tmp_path).findings
    port = port_engine.lint_paths([tmp_path], root=tmp_path).findings
    assert len(ref) == len(port) == 2
    bl = tmp_path / "bl.json"
    if writer == "reference":
        ref_baseline.write_baseline(bl, ref)
        entries = port_baseline.load_baseline(bl)
        diff = port_baseline.apply_baseline(port, entries)
    else:
        port_baseline.write_baseline(bl, port)
        entries = ref_baseline.load_baseline(bl)
        diff = ref_baseline.apply_baseline(ref, entries)
    assert diff.new == [] and len(diff.accepted) == 2 and diff.stale == []
    (tmp_path / "c.py").write_text(textwrap.dedent(JP_BAD).replace(
        "float", "int"))
    for eng, bmod in ((ref_engine, ref_baseline),
                      (port_engine, port_baseline)):
        fresh = eng.lint_paths([tmp_path], root=tmp_path).findings
        diff = bmod.apply_baseline(fresh, bmod.load_baseline(bl))
        assert [f.path for f in diff.new] == ["c.py"]
