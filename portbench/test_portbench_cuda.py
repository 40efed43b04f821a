"""On the card: one short run of a cell through the benchmark's command,
correct and with every metric the cell reports.  Skips without a card
(the decision is made inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import core


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_a_cell_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "zamba2-1.2b.prefill-long", "--seed", "4242424242", "--seconds", "3",
         "--trace", str(trace)],
        cwd=core.ROOT, capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    cell = core.find_cell("zamba2-1.2b.prefill-long")
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} == set(res["metrics"])
