"""The references against the program's plain CPU path at the reduced
configurations, in float32, through the whole of a run (its set-up,
window and comparison); the planted faults and the control fail the
cells' limits there.  The tests import both; the references import
nothing of the program (``test_portbench_imports.py``)."""
from __future__ import annotations

import pytest

from portbench import compare, control, core, run
from portbench.small import control_cell, small_cell

CELLS = [w["name"] for w in core.load_json(core.ROOT / "BENCHMARK.json")
         ["workloads"]]
SEED = 2 ** 31 + 77


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_plain_cpu_path(workload):
    cell, spec = small_cell(workload, "float32")
    out = run.run_cell(cell, SEED, 0.2, False, "cpu", spec=spec)
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        assert c["value"] < 1e-4, (name, c)
    assert out["attempted"] >= 1
    e2e = {m["name"] for m in cell.end_to_end}
    assert set(out["metrics"]) == e2e
    assert all(v["value"] > 0 for v in out["metrics"].values())


def faults(workload: str) -> tuple:
    """The faults a cell can have, from its files: a training step's
    state left unchanged and half its batch; a prefill's token altered,
    half its batch and one slot wrong where a request holds more than
    one prompt, and the window left out where the configuration has one
    and the mix's longest prompt passes it."""
    cell = core.find_cell(workload)
    mix, window = cell.mix, cell.config["sizes"].get("window")
    if mix["kind"] == "train":
        return ("unchanged", "half_batch")
    out = ("token",)
    if mix["batch"] > 1:
        out += ("half_batch", "slot")
    if window and mix["lengths"]["max"] > window:
        out += ("window",)
    return out


FAULTS = [(w, f) for w in CELLS for f in faults(w)]
#: The number that each fault, confined to some rows or positions, has
#: to fail by itself: the others may not see it.
CAUGHT_BY = {"window": "cache_err_far", "slot": "cache_err_slot"}


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_reads_incorrect(workload, fault):
    cell, spec = small_cell(workload, "float32")
    out = run.run_cell(cell, SEED, 0.2, False, "cpu", spec=spec, fault=fault)
    assert out["correct"] is False, out["checks"]
    if fault in CAUGHT_BY:
        c = out["checks"][CAUGHT_BY[fault]]
        assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [SEED, 5])
def test_the_control_fails_the_limits(workload, seed):
    cell = control_cell(workload)
    numbers = control.reading(cell, seed, "cpu")
    ok, checks = compare.verdict(numbers, cell.limits["limits"])
    assert not ok, checks


def test_half_the_batch_in_the_reference_fails_the_train_limits():
    cell = control_cell("zamba2-1.2b.train-4k")
    numbers = control.reading(cell, SEED, "cpu", fault="half_batch")
    ok, checks = compare.verdict(numbers, cell.limits["limits"])
    assert not ok, checks


def test_a_traced_run_reads_its_window():
    cell, spec = small_cell("zamba2-1.2b.prefill-long", "float32")
    out = run.run_cell(cell, SEED, 0.2, True, "cpu", spec=spec)
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "peak_mem_gib.prefill" not in out["metrics"]   # no card: nothing
