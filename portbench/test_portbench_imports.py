"""No module a run loads has the top-level name ``jax``, ``jaxlib`` or
``repro`` (the JAX package; ``repro_torch`` begins with it, so names are
compared before the first dot, whole), and the references load nothing
of ``repro_torch``.  Each check runs in a fresh process."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench import core

BANNED = ("jax", "jaxlib", "flax", "repro")


def _loaded(code: str) -> list[str]:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=core.ROOT, env=env, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def _tops(mods):
    return {m.split(".")[0] for m in mods}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _loaded(
        "from portbench import run\n"
        "from portbench.small import small_cell\n"
        "cell, spec = small_cell('mixtral-8x7b-16l.prefill-chat')\n"
        "run.run_cell(cell, 3, 0.1, True, 'cpu', spec=spec)\n"
        "cell, spec = small_cell('zamba2-1.2b.train-4k')\n"
        "run.run_cell(cell, 3, 0.1, False, 'cpu', spec=spec)\n")
    assert "repro_torch" in _tops(mods)
    assert not _tops(mods) & set(BANNED)


def test_the_references_load_nothing_of_the_program():
    """The reference of each configuration's family at the family's
    ``CONTROL_SIZES`` (a prefill in float8), and each training cell's
    reference (a step), found by the cells' names alone."""
    mods = _loaded(
        "import numpy as np\n"
        "from portbench import core\n"
        "from portbench.reference.common import Precision\n"
        "bench = core.load_json(core.ROOT / 'BENCHMARK.json')\n"
        "tok = np.arange(24, dtype=np.int32).reshape(2, 12)\n"
        "seen = set()\n"
        "for w in bench['workloads']:\n"
        "    cell = core.find_cell(w['name'], bench)\n"
        "    ref = cell.module('reference')\n"
        "    sizes = {**cell.config['sizes'], **ref.CONTROL_SIZES}\n"
        "    if cell.mix['kind'] == 'train':\n"
        "        opt = {**cell.config['optimizer'], **cell.mix['schedule']}\n"
        "        ref.train(sizes, opt, 1, [(tok, tok)], 'cpu',\n"
        "                  Precision('f32'))\n"
        "    if w['config'] not in seen:\n"
        "        seen.add(w['config'])\n"
        "        heads = [0] if ref.state_heads(sizes) else []\n"
        "        pk = [{'positions': [0, 11], 'heads': heads}]\n"
        "        ref.prefill(sizes, 1, [tok], pk, 'cpu', Precision('fp8'))\n"
        "assert seen == {w['config'] for w in bench['workloads']}\n")
    assert not _tops(mods) & (set(BANNED) | {"repro_torch"})
