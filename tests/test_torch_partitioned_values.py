"""The values of a partitioned step, on the CPU: eight processes on a
real ``gloo`` group run one step of a reduced cell on a 2x4 ``("data",
"model")`` mesh, as the dry-run's DTensor path runs it (every ``shard``
site, B4 and B5 on local shards, the MoE layer's per-partition experts,
the vocab-parallel loss, microbatches gathered across partitions, the
gradients held to their parameters' placements), and every output,
gathered whole, is held against the same step on one device:

* serve cells: the logits and every cache leaf;
* train cells: the loss, the gradient norm, every new parameter and
  every optimizer-state leaf (AdamW's first moment is the gradient
  scaled by ``1 - b1``, its second the squared gradient; Adafactor's
  factors are the squared gradient's row and column means).

Weights, batch and caches come from seeds; the models run in f32, so
the only difference is the order of the partitions' sums:
``max |partitioned - one device| <= TOL * max |one device|`` per tensor
(a dropped or doubled partial sum, a wrong expert offset or a wrong
kv-head slice is off by the size of the tensor).  The dry-run's own
contracts hold bytes and costs (``test_torch_dryrun_partitioned.py``);
this file holds what the partitions compute.

``PYTHONPATH=src python tests/test_torch_partitioned_values.py`` prints
the errors.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 8
#: (arch, seq, kind, grad_accum): the reference's six 2x4 integration
#: cells, llama3-8b's train step with two microbatches, and zamba2-1.2b's
#: train step (B4's and B5's gradients on head-sharded shards).
CASES = [
    ("llama3-8b", 64, "train", 2),
    ("mixtral-8x7b", 64, "train", 1),
    ("mamba2-780m", 64, "train", 1),
    ("zamba2-1.2b", 64, "prefill", 1),
    ("zamba2-1.2b", 64, "train", 1),
    ("seamless-m4t-medium", 64, "train", 1),
    ("phi-3-vision-4.2b", 32, "decode", 1),
]
#: f32 sums in another order over a few hundred terms, through two
#: layers and one optimizer step
TOL = 1e-5

RANK_SCRIPT = r"""
import dataclasses, json, logging, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import Shape
from repro_torch.configs.reduced import reduced_arch
from repro_torch.dist.tree import leaves_with_path, keystr
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.steps import (
    _at_length, build_cell, build_train_cell, distribute_cell,
    make_optimizer, run_step,
)
from repro_torch.train.train_step import init_state

logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
rank, port = int(sys.argv[1]), int(sys.argv[2])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=WORLD)
dm = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
MESH = Mesh(("data", "model"), (2, 4))


def f32(spec):
    cfg = spec.config
    if hasattr(cfg, "backbone"):
        cfg = dataclasses.replace(cfg, backbone=dataclasses.replace(
            cfg.backbone, dtype=torch.float32))
    else:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return dataclasses.replace(spec, config=cfg, accum_dtype=torch.float32)


def real_args(spec, shape, cell):
    # the same values on every rank: seeded draws on the CPU
    fam, cfg = spec.family, spec.config
    gen = torch.Generator().manual_seed(1)
    model = fam.init(cfg, device="cpu", seed=0)
    batch = {}
    for name, (dims, dtype) in spec.input_shapes(shape).items():
        if dtype.is_floating_point:
            batch[name] = torch.randn(dims, generator=gen).to(dtype)
        else:
            batch[name] = torch.randint(0, spec.vocab, dims,
                                        generator=gen).to(dtype)
    if cell.kind == "train":
        return (init_state(model, make_optimizer(spec)), batch)
    caches = fam.init_caches(cfg, **spec.cache_kwargs(shape), device="cpu")
    for _, t in leaves_with_path(caches):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            t.copy_(0.5 * torch.randn(t.shape, generator=gen))
    if cell.kind == "prefill":
        return (model, batch, caches)
    length = cell.abstract_args[3]
    return (model, batch, _at_length(caches, length), length)


def outputs(result, kind):
    # {name: whole tensor} of a step's result (DTensors gathered)
    if kind == "train":
        state, metrics = result
        tree = {"metrics": metrics, "opt_state": state.opt_state,
                "params": dict(state.params.named_parameters())}
    else:
        logits, caches = result
        tree = {"logits": logits, "caches": caches}
    out = {}
    for path, t in leaves_with_path(tree):
        if isinstance(t, torch.Tensor):
            if isinstance(t, DTensor):
                t = t.full_tensor()
            out[keystr(path)] = t.detach().float()
    return out


report = {}
for arch, seq, kind, accum in CASES:
    spec = f32(reduced_arch(arch))
    shape = Shape("t", seq, 8, kind)
    cell = build_train_cell(spec, shape, MESH, grad_accum=accum) \
        if kind == "train" else build_cell(spec, shape, MESH)
    one, _ = run_step(cell, real_args(spec, shape, cell))
    want = outputs(one, kind)
    dcell = distribute_cell(dataclasses.replace(
        cell, abstract_args=real_args(spec, shape, cell)), dm)
    got_result, replicated = run_step(dcell)
    got = outputs(got_result, kind)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    errs = {}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        errs[name] = [err, scale]
    report[f"{arch}/{kind}"] = {"errs": errs, "replicated_ops": replicated}
if rank == 0:
    print("VALUES-JSON " + json.dumps(report))
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks() -> dict:
    """Run :data:`RANK_SCRIPT` on ``WORLD`` processes; rank 0's report."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", str(ROOT)),
           "OMP_NUM_THREADS": "1"}
    port = str(_free_port())
    code = f"WORLD = {WORLD}\nCASES = {CASES!r}\n" + RANK_SCRIPT
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), port], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    line = next(ln for ln in outs[0][0].splitlines()
                if ln.startswith("VALUES-JSON "))
    return json.loads(line[len("VALUES-JSON "):])


@pytest.fixture(scope="module")
def report() -> dict:
    return run_ranks()


@pytest.mark.parametrize("arch,seq,kind,accum", CASES,
                         ids=[f"{c[0]}-{c[2]}" for c in CASES])
def test_partitioned_step_equals_the_one_device_step(arch, seq, kind, accum,
                                                     report):
    errs = report[f"{arch}/{kind}"]["errs"]
    if kind == "train":
        assert any(n.startswith("['opt_state']") for n in errs)
        assert "['metrics']['loss']" in errs
    else:
        assert "['logits']" in errs
    bad = {n: e for n, e in errs.items() if not e[0] <= TOL * max(e[1],
                                                                  1e-30)}
    assert not bad, bad


def _main() -> int:
    got = run_ranks()
    for arch, r in got.items():
        worst = max(r["errs"].items(),
                    key=lambda kv: kv[1][0] / max(kv[1][1], 1e-30))
        print(f"{arch:22s} {len(r['errs'])} tensors, worst {worst[0]} "
              f"{worst[1][0]:.3e} of {worst[1][1]:.3e}; replicated "
              f"{r['replicated_ops']}")
    return 0


if __name__ == "__main__":
    sys.exit(_main())
