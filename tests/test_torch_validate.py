"""The validation harness of the port (``repro_torch.validate``) on the
CPU: the reference's golden 18-cell matrix to 1e-6, a two-workload smoke
matrix against the reference's ``run_validation`` to 1e-6 with zero
rebuilds on its second run, the store keys (C6: ``validation`` shards
stamped as the port's, ``exact`` baselines shared), spawned workers, the
report, and the CLI's output paths."""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import pytest

from repro_torch.validate import (
    ArtifactStore,
    MatrixSpec,
    generate_report,
    run_validation,
    run_workload,
    save_results,
)
from repro_torch.validate.__main__ import (
    check_runtime_gate,
    check_sampling_gate,
    main,
)
from repro_torch.validate.reference import (
    PAPER_ARCH_CLAIMS,
    PAPER_OVERALL,
    PAPER_TABLE4,
    reference_record,
)
from repro_torch.validate.runner import SHARD_STAMP, _shard_key
from repro_torch.workloads.polybench import MAKERS, SIZE_PRESETS

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6

# tests/validate/test_runtime_golden.py: the spec and its committed
# aggregates (relative/absolute error in %)
GOLDEN_SPEC = MatrixSpec(
    workloads=("polybench/atx", "polybench/mvt", "polybench/jcb"),
    core_counts=(1, 4),
    strategies=("round_robin",),
    sizes="smoke",
    binned_check=False,
)
GOLDEN = {
    "hit": 0.259646889555145,
    "runtime": 1.367613486290153,
    "eq": 1.367613486290153,
    "ecm": 71.663113522307130,
    "roofline": 90.851810925179830,
}
GOLDEN_CELLS = 18

TINY = MatrixSpec(
    workloads=("atx", "jcb"),
    core_counts=(1, 2),
    strategies=("round_robin",),
    sizes="smoke",
)


def leaves(obj, prefix=""):
    """Every number in a nested dict, by its path."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield prefix, float(obj)


def assert_aggregates_close(got: dict, want: dict):
    got_l, want_l = dict(leaves(got)), dict(leaves(want))
    assert got_l.keys() == want_l.keys()
    for path, value in want_l.items():
        assert got_l[path] == pytest.approx(value, abs=TOL), path


# --- reference data ----------------------------------------------------------


def test_reference_tables_cover_roster_and_equal_the_reference():
    from repro.validate.reference import reference_record as ref_record

    assert set(PAPER_TABLE4) == set(MAKERS)
    archs = list(PAPER_ARCH_CLAIMS.values())
    assert sum(c.hit_rate_err_pct for c in archs) / len(archs) == \
        pytest.approx(PAPER_OVERALL.hit_rate_err_pct, abs=0.01)
    assert sum(c.runtime_err_pct for c in archs) / len(archs) == \
        pytest.approx(PAPER_OVERALL.runtime_err_pct, abs=0.01)
    for preset in SIZE_PRESETS.values():
        assert set(preset) <= set(MAKERS)
    assert reference_record() == ref_record()


def test_matrix_id_stable_spec_sensitive_and_the_reference_s():
    from repro.validate.runner import MatrixSpec as RefSpec

    assert TINY.matrix_id() == TINY.matrix_id()
    other = MatrixSpec(workloads=("atx",), sizes="smoke")
    assert other.matrix_id() != TINY.matrix_id()
    ref = RefSpec(workloads=("atx", "jcb"), core_counts=(1, 2),
                  strategies=("round_robin",), sizes="smoke")
    assert TINY.matrix_id() == ref.matrix_id()


# --- the golden matrix -------------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    return run_validation(GOLDEN_SPEC, artifact_dir=None, processes=1,
                          device="cpu")


@pytest.mark.parametrize("quantity", sorted(GOLDEN))
def test_golden_aggregates(golden, quantity):
    agg = golden["aggregates"]
    if quantity == "hit":
        got = agg["overall"]["hit_rate_err_pct"]["ours"]
    elif quantity == "runtime":
        got = agg["overall"]["runtime_err_pct"]["ours"]
    else:
        assert set(agg["runtime_models"]) == {"eq", "ecm", "roofline"}
        got = agg["runtime_models"][quantity]["overall_rel_err_pct"]
        assert agg["runtime_models"][quantity]["cells"] == GOLDEN_CELLS
    assert agg["overall"]["cells"] == GOLDEN_CELLS
    assert got == pytest.approx(GOLDEN[quantity], abs=TOL)


def test_golden_eq_model_is_the_legacy_metric_and_the_gate_holds(golden):
    agg = golden["aggregates"]
    assert agg["runtime_models"]["eq"]["overall_rel_err_pct"] == \
        pytest.approx(agg["overall"]["runtime_err_pct"]["ours"], abs=1e-12)
    passed, msg = check_runtime_gate(agg)
    assert passed, msg


# --- the runner --------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """TINY twice on one store, and the reference's TINY."""
    from repro.validate.runner import MatrixSpec as RefSpec
    from repro.validate.runner import run_validation as ref_run

    store = tmp_path_factory.mktemp("tiny")
    first = run_validation(TINY, artifact_dir=store, processes=1,
                           device="cpu")
    second = run_validation(TINY, artifact_dir=store, processes=1,
                            device="cpu")
    ref = ref_run(RefSpec(**{f: getattr(TINY, f) for f in
                             TINY.__dataclass_fields__}),
                  artifact_dir=tmp_path_factory.mktemp("ref"), processes=1)
    return first, second, ref, store


def test_runner_scores_every_cell(tiny):
    summary = tiny[0]
    cells = (len(TINY.workloads) * len(TINY.targets)
             * len(TINY.core_counts) * len(TINY.strategies))
    assert len(summary["records"]) == cells
    for rec in summary["records"]:
        assert set(rec["levels"]) == {"L1", "L2", "L3"}
        for entry in rec["levels"].values():
            assert 0.0 <= entry["predicted"] <= 1.0
            assert 0.0 <= entry["exact"] <= 1.0
            assert entry["abs_err_pct"] >= 0.0
        assert rec["t_pred_s"] > 0 and rec["t_exact_rates_s"] > 0
    agg = summary["aggregates"]["overall"]
    assert agg["cells"] == cells
    assert agg["hit_rate_err_pct"]["paper"] == PAPER_OVERALL.hit_rate_err_pct
    assert set(summary["aggregates"]["per_arch"]) == set(TINY.targets)
    assert summary["reference"]["overall"]["runtime_err_pct"] == 9.08


def test_smoke_matrix_matches_the_reference(tiny):
    first, second, ref, _ = tiny
    assert_aggregates_close(first["aggregates"], ref["aggregates"])
    assert first["matrix_id"] == ref["matrix_id"]
    assert [(r["workload"], r["target"], r["cores"], r["strategy"])
            for r in first["records"]] == \
        [(r["workload"], r["target"], r["cores"], r["strategy"])
         for r in ref["records"]]


def test_second_run_zero_profile_recomputation(tiny):
    first, second, _, _ = tiny
    assert first["session_stats"]["profile_builds"] > 0
    assert second["session_stats"]["profile_builds"] == 0
    assert second["session_stats"]["rd_builds"] == 0
    assert second["session_stats"]["mimic_builds"] == 0
    assert second["session_stats"]["store_hits"] > 0
    assert second["aggregates"]["overall"] == first["aggregates"]["overall"]


def test_binned_and_sampled_checks_hold(tiny):
    summary = tiny[0]
    bp = summary["aggregates"]["binned_profile"]
    assert bp["cells"] > 0
    assert bp["max_abs_dev"] <= bp["tolerance"] == 1e-3
    assert bp["within_tolerance"]
    sp = summary["aggregates"]["sampled_profile"]
    assert sp["cells"] > 0
    assert sp["rate"] == TINY.sampled_rate == 0.5
    assert sp["max_declared_bound"] > 0.0
    assert sp["bound_exceedances"] == 0 and sp["within_bound"]
    for rec in summary["records"]:
        assert set(rec["binned_abs_dev"]) == set(rec["levels"])
        assert set(rec["sampled_abs_dev"]) == set(rec["levels"])
        assert set(rec["sampled_bound"]) == set(rec["levels"])
        for lvl, dev in rec["sampled_abs_dev"].items():
            assert dev < rec["sampled_bound"][lvl], (rec["workload"], lvl)
    passed, msg = check_sampling_gate(summary["aggregates"])
    assert passed, msg


@pytest.mark.parametrize("check", ["binned", "sampled"])
def test_checks_can_be_disabled(tmp_path, check):
    spec = MatrixSpec(workloads=("atx",), core_counts=(1,),
                      strategies=("round_robin",), sizes="smoke",
                      **{f"{check}_check": False})
    summary = run_validation(spec, artifact_dir=tmp_path, processes=1,
                             device="cpu")
    agg = summary["aggregates"][f"{check}_profile"]
    assert agg["cells"] == 0
    if check == "sampled":
        assert agg["rate"] is None
    assert all(f"{check}_abs_dev" not in r for r in summary["records"])


def test_sampling_gate_checker():
    good = {"sampled_profile": {
        "cells": 12, "rate": 0.5, "max_abs_dev": 1e-3,
        "max_declared_bound": 5e-2, "bound_exceedances": 0,
        "within_bound": True,
    }}
    ok, msg = check_sampling_gate(good)
    assert ok and msg.startswith("OK")
    bad = {"sampled_profile": {
        "cells": 12, "rate": 0.5, "max_abs_dev": 9e-2,
        "max_declared_bound": 5e-2, "bound_exceedances": 3,
        "within_bound": False,
    }}
    ok, msg = check_sampling_gate(bad)
    assert not ok and "3 cell(s)" in msg
    ok, msg = check_sampling_gate({})
    assert not ok and "no sampled cells" in msg
    ok, msg = check_sampling_gate({"sampled_profile": {"cells": 0}})
    assert not ok


# --- store keys (C6) ---------------------------------------------------------


def test_reference_store_gives_exact_baselines_but_no_validation_shard(
        tmp_path, monkeypatch):
    """A store the reference's runner warmed: the port's shard key is its
    own (no ``validation`` shard of the reference's is read), while every
    exact-LRU baseline comes from the reference's entries — the port
    never runs its ground truth."""
    from repro.validate.runner import MatrixSpec as RefSpec
    from repro.validate.runner import _shard_key as ref_shard_key
    from repro.validate.runner import run_validation as ref_run
    from repro_torch.api import Session

    ref_dir = tmp_path
    spec = MatrixSpec(workloads=("atx",), core_counts=(1, 2),
                      strategies=("round_robin",), sizes="smoke")
    ref_run(RefSpec(workloads=spec.workloads, core_counts=spec.core_counts,
                    strategies=spec.strategies, sizes=spec.sizes),
            artifact_dir=ref_dir, processes=1)
    store = ArtifactStore(ref_dir)
    name = "polybench/atx"
    assert store.get_json("validation", ref_shard_key(spec, name))
    assert _shard_key(spec, name) != ref_shard_key(spec, name)
    assert SHARD_STAMP in _shard_key(spec, name)
    assert store.get_json("validation", _shard_key(spec, name)) is None

    def no_ground_truth(*args, **kwargs):
        raise AssertionError("the port recomputed an exact baseline")

    monkeypatch.setattr(Session, "ground_truth_hit_rates", no_ground_truth)
    payload = run_workload("atx", spec, ref_dir, device="cpu")
    assert len(payload["records"]) == 6
    assert ArtifactStore(ref_dir).get_json(
        "validation", _shard_key(spec, name)) == json.loads(
            json.dumps(payload, default=float))


# --- workers, defaults, report, CLI ------------------------------------------


def test_spawned_workers_give_the_serial_summary(tiny, tmp_path):
    """``processes=2`` spawns two workers on the CPU; their merged summary
    is the serial run's, and they leave the store warm."""
    summary = run_validation(TINY, artifact_dir=tmp_path, processes=2,
                             device="cpu")
    assert len(summary["records"]) == 12
    assert summary["aggregates"] == tiny[0]["aggregates"]
    rerun = run_validation(TINY, artifact_dir=tmp_path, processes=1,
                           device="cpu")
    assert rerun["session_stats"]["profile_builds"] == 0


def test_multiprocess_without_store_rejected():
    with pytest.raises(ValueError, match="artifact_dir"):
        run_validation(TINY, artifact_dir=None, processes=2, device="cpu")


def test_defaults(monkeypatch):
    """No store: in-process; no device: the card, which is absent here."""
    import torch

    spec = MatrixSpec(workloads=("atx",), core_counts=(1,),
                      strategies=("round_robin",), sizes="smoke")
    summary = run_validation(spec, device="cpu")
    assert len(summary["records"]) == 3      # 3 targets x 1 core
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_validation(spec)


def test_model_workload_is_not_ported_yet():
    spec = MatrixSpec(workloads=("model/llama3_8b/decode",),
                      targets=("tpu-v5e",), core_counts=(1,),
                      strategies=("round_robin",), sizes="smoke",
                      binned_check=False)
    with pytest.raises(NotImplementedError, match="A-11"):
        run_validation(spec, device="cpu")


def test_report_generation(tiny, tmp_path):
    json_path = save_results(tiny[0], tmp_path / "validation.json")
    md_path = generate_report(json_path, tmp_path / "validation.md")
    md = md_path.read_text()
    assert "GENERATED by repro_torch.validate.report" in md
    assert "Aggregate errors vs the paper" in md
    assert "1.23" in md and "9.08" in md
    for arch in TINY.targets:
        assert f"### {arch}" in md
    for section in ("Runtime-model comparison", "Sampled-profile deviation",
                    "Per-workload summary", "Incrementality"):
        assert f"## {section}" in md
    assert "ATAX" in md
    payload = json.loads(json_path.read_text())
    assert payload["reference"]["per_arch"].keys() == PAPER_ARCH_CLAIMS.keys()


def digest(path: Path) -> str:
    return hashlib.sha1(path.read_bytes()).hexdigest()


TRACKED = (ROOT / "docs" / "validation.md",
           ROOT / "experiments" / "results" / "validation_full.json")


@pytest.mark.parametrize("mode", ["smoke", "full"])
def test_cli_writes_only_the_port_s_paths(tmp_path, monkeypatch, mode):
    """Run from a scratch directory with the defaults: the results go to
    ``experiments/results/torch/``, the store to
    ``.validation-cache-torch/``, no report is written, and the
    reference's tracked outputs are untouched."""
    before = {p: digest(p) for p in TRACKED if p.exists()}
    monkeypatch.chdir(tmp_path)
    args = ["--device", "cpu", "--workloads", "atx", "--cores", "1"]
    if mode == "smoke":
        args += ["--smoke", "--runtime-gate", "--sampling-gate"]
    else:
        args += ["--sizes", "smoke"]
    assert main(args) == 0
    out = tmp_path / "experiments" / "results" / "torch" / \
        f"validation_{mode}.json"
    summary = json.loads(out.read_text())
    assert summary["aggregates"]["overall"]["cells"] == 6   # 3 CPUs x 2 strategies
    assert (tmp_path / ".validation-cache-torch").is_dir()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [".validation-cache-torch", "experiments"]
    assert {p: digest(p) for p in TRACKED if p.exists()} == before
