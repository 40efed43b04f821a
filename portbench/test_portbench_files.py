"""Every cell's files are there, found by name, and every name and unit
keeps to the benchmark's character rules."""
from __future__ import annotations

import importlib.util
import re

import pytest

from portbench import core

BENCH = core.load_json(core.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for key in ("end_to_end", "per_layer")
             for m in BENCH[key]]
    assert all(UNIT.match(u) for u in units), units
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[key]]
        assert len(got) == len(set(got)), key


def test_every_file_under_the_benchmark_is_named_by_the_rules():
    for path in core.HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(core.ROOT).as_posix()
        assert all(NAME.match(p) for p in rel.split("/")), rel


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_exist_and_load(workload):
    cell = core.find_cell(workload)
    assert cell.mix["kind"] in ("train", "prefill")
    for kind in ("reference", "program", "counts"):
        assert cell.module(kind) is not None
    importlib.import_module(f"portbench.loops.{cell.mix['kind']}")
    assert cell.limits["limits"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = core.load_json(core.ROOT / c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    path = core.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)


def test_layers_of_one_name_are_spelt_alike():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"model step", "train step", "kernels", "device"}
