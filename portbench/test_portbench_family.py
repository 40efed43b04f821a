"""A configuration family that the harness has never seen comes in through
new files alone, as a PR that adds a configuration may bring it.

A copy of ``portbench/`` and ``BENCHMARK.json`` gains a family
``transformer_copy`` (its reference, program and counts modules
re-export the transformer family's, ``CONTROL_SIZES`` with them), a
configuration of it, the limits of one prefill cell, and that cell
appended to ``BENCHMARK.json``'s ``workloads`` and to the ``workloads``
of the metrics it reports.  In the copy, with the program's ``src/`` on
the path, the cell runs on the CPU and is correct, its control fails
its limits, and the checks of ``test_portbench_files.py`` pass.  No
file of the copy is edited but ``BENCHMARK.json``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import core

FAMILY = "transformer_copy"
#: The configuration and the cell that the new ones copy.
SOURCE, SOURCE_CELL = "mixtral-8x7b-16l", "mixtral-8x7b-16l.prefill-long"
CONFIG = "mixtral-copy-16l"
CELL = f"{CONFIG}.prefill-long"

RUN = f"""
from pathlib import Path
from portbench import compare, control, core, run
from portbench.small import control_cell, small_cell
assert core.ROOT == Path.cwd().resolve(), core.ROOT
cell, spec = small_cell({CELL!r}, "float32")
out = run.run_cell(cell, 2 ** 31 + 91, 0.2, False, "cpu", spec=spec)
assert out["correct"], out["checks"]
ctl = control_cell({CELL!r})
sizes = ctl.module("reference").CONTROL_SIZES
assert ctl.config["sizes"]["layers"] == sizes["layers"]
ok, checks = compare.verdict(control.reading(ctl, 5, "cpu"),
                             ctl.limits["limits"])
assert not ok, checks
"""


def _files(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _appended(bench: dict) -> dict:
    """``bench`` with the new configuration and cell appended, as a PR
    that adds them would append them."""
    bench = json.loads(json.dumps(bench))
    src = next(c for c in bench["configs"] if c["name"] == SOURCE)
    bench["configs"].append({**src, "name": CONFIG,
                             "file": f"portbench/configs/{CONFIG}.json"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "prefill-long",
        "chips": 1, "why": "the mixtral cell's prompts through a family "
        "that the harness has never seen"})
    for key in ("end_to_end", "per_layer"):
        for m in bench[key]:
            if SOURCE_CELL in m.get("workloads", ()):
                m["workloads"].append(CELL)
    return bench


def test_a_new_family_needs_only_new_files(tmp_path):
    bench = core.load_json(core.ROOT / "BENCHMARK.json")
    pb = tmp_path / "portbench"
    shutil.copytree(core.HERE, pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(pb)
    for kind in ("reference", "program", "counts"):
        (pb / kind / f"{FAMILY}.py").write_text(
            '"""The transformer family under a name of its own."""\n'
            f"from portbench.{kind}.transformer import *  # noqa: F403\n")
    cfg = core.load_json(core.HERE / "configs" / f"{SOURCE}.json")
    (pb / "configs" / f"{CONFIG}.json").write_text(
        json.dumps({**cfg, "name": CONFIG, "family": FAMILY}))
    shutil.copy(core.HERE / "limits" / f"{SOURCE_CELL}.json",
                pb / "limits" / f"{CELL}.json")
    new = _appended(bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    added = set(_files(pb)) - set(before)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST")}
    env.update(PYTHONDONTWRITEBYTECODE="1", PYTHONPATH=os.pathsep.join(
        [str(tmp_path), str(core.ROOT / "src")]))
    for argv in ([sys.executable, "-c", RUN],
                 [sys.executable, "-m", "pytest", "-v", "-p",
                  "no:cacheprovider", "portbench/test_portbench_files.py"]):
        out = subprocess.run(argv, cwd=tmp_path, env=env,
                             capture_output=True, text=True)
        assert out.returncode == 0, (argv[1:], out.stdout[-4000:],
                                     out.stderr[-4000:])
    assert f"test_cell_files_exist_and_load[{CELL}] PASSED" in out.stdout

    after = _files(pb)
    assert {k: after.get(k) for k in before} == before
    assert set(after) - set(before) == added
    assert len(added) == 5
    assert json.loads((tmp_path / "BENCHMARK.json").read_text()) == new
