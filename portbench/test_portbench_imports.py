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
    mods = _loaded(
        "import numpy as np\n"
        "from portbench import control, core\n"
        "from portbench.reference import hybrid, transformer, common\n"
        "from portbench.reference.common import Precision\n"
        "sizes = {'layers': 3, 'd_model': 16, 'vocab': 64, 'heads': 2,\n"
        "         'kv_heads': 2, 'd_ff': 32, 'ssm_state': 8, 'head_dim': 8,\n"
        "         'expand': 2, 'conv_width': 4, 'attn_every': 2,\n"
        "         'rope_theta': 1e4, 'dtype': 'float32',\n"
        "         'vocab_pad_multiple': 32, 'norm_eps': 1e-6, 'zloss': 1e-4}\n"
        "tok = np.arange(24, dtype=np.int32).reshape(2, 12) % 64\n"
        "pk = [{'positions': [0, 11], 'heads': [1]}]\n"
        "hybrid.prefill(sizes, 1, [tok], pk, 'cpu', Precision('fp8'))\n"
        "opt = {'peak_lr': 3e-4, 'b1': 0.9, 'b2': 0.95, 'eps': 1e-8,\n"
        "       'weight_decay': 0.1, 'grad_clip': 1.0,\n"
        "       'final_fraction': 0.1, 'total_steps': 40, 'warmup': 5}\n"
        "hybrid.train(sizes, opt, 1, [(tok, tok)], 'cpu', Precision('f32'))\n"
        "t = dict(sizes, window=5, dense_ff=False,\n"
        "         moe={'num_experts': 4, 'top_k': 2})\n"
        "transformer.prefill(t, 1, [tok], pk, 'cpu', Precision('f32'))\n")
    assert not _tops(mods) & (set(BANNED) | {"repro_torch"})
