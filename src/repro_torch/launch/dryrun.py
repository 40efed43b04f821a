"""Dry-run: build every (arch x input-shape) cell on a mesh at full size
on the meta device, and record the roofline inputs and the memory plan.
Port of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh host
    python -m repro_torch.launch.dryrun --all --mesh host
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --jobs 8

The reference lowers and compiles SPMD programs over 256 and 512 fake
devices; XLA's partitioner then gives it each partition's cost, memory
and collectives.  The port records:

* ``--mesh host`` (the card: one device) — the whole step, recorded on
  the meta device (:func:`repro_torch.launch.steps.lower_cell`): nothing
  is allocated, B4 and B5 are one op each, counted at their kernels'
  own operations; ``cost`` and ``loop_aware_cost`` from the recording's
  census, and ``memory`` with ``temp_bytes`` the peak of the live
  intermediates (storage lifetimes, autograd's saved tensors included).
  No collective exists on one device (``ici_bytes`` 0), and the port
  legalizes nothing (``bf16_legalization_overhead_bytes`` 0, ROADMAP C8).
  ``device_bytes`` = arguments + temporaries is the predicted peak;
  ``fits`` holds it against the card's memory (``card_bytes``, its
  ``total_memory``; both ``null`` with ``--device cpu``).  A MoE layer's expert
  counts have no values on meta: every expert takes the uniform load
  (``moe_counts: "uniform"``, ``models/moe.py::uniform_counts``).
* ``--mesh pod`` / ``multipod`` — one partition's step of the SPMD
  program over 256 / 512 chips: the cell's arguments are DTensors on a
  ``DeviceMesh`` of the mesh's axes over a fake process group of that
  many ranks, opened in this process for the cell and closed after it
  (:func:`repro_torch.launch.mesh.fake_device_mesh`; the mesh is typed
  ``cuda``, so DTensor picks the collectives it would on cards, and the
  local shards are on the meta device, so nothing is allocated), each
  placed by its sharding (:func:`repro_torch.launch.steps.distribute_cell`);
  the step runs under the cell's rules, its ``shard`` sites placing the
  activations, and rank 0's local ops and functional collectives are
  recorded (``cost``, ``loop_aware_cost`` with ``ici_bytes``,
  ``collectives``, ``memory`` with ``temp_bytes``: the reference's keys,
  per partition).  ``partitioned: true``, ``devices``, the sharding
  ``plan``, and ``replicated_ops``: the operands gathered for an op that
  runs only on local shards (``dist/sharding.py::place_for``), by site
  and global shape, with their count.  ``device_bytes`` (arguments +
  temporaries) is held against the reference's target, 16 GB a chip of
  the TPU pod (:data:`TARGET_CHIP_BYTES`; a TPU figure, not the card's):
  ``fits``.  ``--all`` runs each pod cell in a spawned process of its
  own, so no process group outlives a cell.

Records go to ``experiments/results/torch/dryrun/`` (git-ignored), one
JSON file a cell, the reference's keys and these.  ``--jobs N`` records
cells in ``N`` processes.
"""
from __future__ import annotations

import argparse
import json
import logging
import sys
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchSpec, Shape
from repro_torch.dist.sharding import leaf_shape, pspec_for, spec_devices
from repro_torch.dist.tree import keystr, leaves_with_path
from repro_torch.launch.mesh import (
    Mesh, fake_device_mesh, make_device_mesh, make_production_mesh,
)
from repro_torch.launch.steps import (
    build_cell, distribute_cell, lower_cell, make_optimizer, stacked_params,
)
from repro_torch.models.layers import param_axes
from repro_torch.train.train_step import TrainState

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "results" \
    / "torch" / "dryrun"
MESHES = ("host", "pod", "multipod")
#: The reference's memory target for a partition: 16 GB a chip of the
#: TPU pod (``repro/launch/dryrun.py``'s docstring).  A TPU figure, not
#: the card's.
TARGET_CHIP_BYTES = 16 * 2**30


def make_mesh(mesh_name: str, device=None) -> Mesh:
    """``host``: the one device the step is recorded for; else a
    production mesh."""
    if mesh_name == "host":
        return make_device_mesh(device)
    return make_production_mesh(multi_pod=(mesh_name == "multipod"))


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0    # a length the port keeps as a Python int


def _sharding_form(cell, args) -> tuple:
    """The cell's arguments (or a train step's outputs) in the shape of
    its sharding trees: a model as its ``{leaf: stacked}``."""
    if cell.kind == "train":
        state, *rest = args
        return (TrainState(state.step, stacked_params(state.params),
                           state.opt_state), *rest)
    model, *rest = args
    return (stacked_params(model), *rest)


def _per_device(tree, shardings, mesh: Mesh) -> int:
    return int(sum(
        _nbytes(leaf) / spec_devices(sh.spec, mesh)
        for _, leaf, sh in leaves_with_path(tree, shardings)))


def _axes_trees(spec: ArchSpec, shape: Shape, cell) -> tuple:
    """Logical axes parallel to :func:`_sharding_form`'s arguments."""
    batch = spec.batch_axes(shape)
    if cell.kind == "train":
        paxes = param_axes(cell.abstract_args[0].params)
        oaxes = make_optimizer(spec).state_axes(paxes)
        return (TrainState((), paxes, oaxes), batch)
    out = (param_axes(cell.abstract_args[0]), batch,
           spec.family.cache_axes(spec.config))
    return out + ((),) if cell.kind == "decode" else out


def sharding_plan(spec: ArchSpec, shape: Shape, cell) -> dict:
    """Every argument leaf's PartitionSpec (by the reference's tree path,
    arguments numbered) and the replication fallbacks ``[leaf, logical
    axis, dim]``, resolved as the cell's shardings are (the optimizer
    state under ``opt_rules``)."""
    form = _sharding_form(cell, cell.abstract_args)
    axes = _axes_trees(spec, shape, cell)
    opt_rules = cell.rules.with_overrides(**spec.opt_rules) \
        if spec.opt_rules else cell.rules
    specs, fallbacks = {}, []
    for i, (arg, ax) in enumerate(zip(form, axes)):
        for path, leaf, a in leaves_with_path(arg, ax):
            name = f"[{i}]{keystr(path)}"
            rules = opt_rules if (cell.kind == "train" and i == 0 and path
                                  and path[0] == ("attr", "opt_state")) \
                else cell.rules
            fb: list = []
            specs[name] = list(pspec_for(leaf_shape(leaf), a, rules, fb))
            fallbacks += [[name, logical, dim] for logical, dim in fb]
    return {"specs": specs, "fallbacks": fallbacks}


def _abstract_outputs(spec: ArchSpec, shape: Shape, cell) -> tuple:
    """The step's outputs without running it: the donated state and its
    metrics (train), or the last position's logits and the caches."""
    meta = torch.device("meta")
    if cell.kind == "train":
        metrics = {k: torch.empty((), device=meta)
                   for k in ("loss", "grad_norm", "param_norm")}
        return cell.abstract_args[0], metrics
    cfg = getattr(spec.config, "backbone", spec.config)
    logits = torch.empty((shape.global_batch, cfg.padded_vocab),
                         dtype=cfg.dtype, device=meta)
    return logits, cell.abstract_args[2]


def _memory(cell, mesh: Mesh, rec, outputs) -> dict:
    args = _sharding_form(cell, cell.abstract_args)
    arg_bytes = _per_device(args, cell.in_shardings, mesh)
    alias = sum(_per_device(args[i], cell.in_shardings[i], mesh)
                for i in cell.donate_argnums)
    out = _sharding_form(cell, outputs) if cell.kind == "train" else outputs
    return {
        "argument_bytes": arg_bytes,
        "output_bytes": _per_device(out, cell.out_shardings, mesh),
        "temp_bytes": None if rec is None else int(rec.peak_bytes),
        "generated_code_bytes": 0,
        "alias_bytes": alias,
    }


def card_bytes(mesh: Mesh) -> int | None:
    """The memory of a device mesh's card; None off CUDA."""
    dev = mesh.devices[0]
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def dry_run(spec: ArchSpec, shape: Shape, mesh_name: str, *,
            device=None, mesh: Mesh | None = None) -> dict:
    """The record of one cell (not written).  ``mesh`` (default: the
    mesh named ``mesh_name``) partitions the step when it has more than
    one device."""
    from repro_torch.analysis.aten_trace import recording_cost

    mesh = mesh or make_mesh(mesh_name, device)
    t0 = time.perf_counter()
    cell = build_cell(spec, shape, mesh)
    plan = sharding_plan(spec, shape, cell)
    if mesh.size == 1:
        rec, result = lower_cell(cell)
        memory = _memory(cell, mesh, rec, result)
    else:
        memory = _memory(cell, mesh, None,
                         _abstract_outputs(spec, shape, cell))
        with fake_device_mesh(mesh, "cuda") as device_mesh:
            rec, _ = lower_cell(distribute_cell(cell, device_mesh))
        memory["temp_bytes"] = int(rec.peak_bytes)
    t_lower = time.perf_counter() - t0
    aware = recording_cost(rec)
    cost = {"flops": aware["flops"], "bytes accessed": aware["bytes"],
            "transcendentals": aware["transcendental"]}
    peak = memory["argument_bytes"] + memory["temp_bytes"]
    out = {
        "arch": spec.arch_id, "shape": shape.name, "mesh": mesh_name,
        "status": "ok",
        "kind": cell.kind,
        "lower_s": round(t_lower, 2),
        "compile_s": 0.0,
        "memory": memory,
        "bf16_legalization_overhead_bytes": 0,
        "cost": {k: v for k, v in cost.items() if abs(v) > 0},
        "loop_aware_cost": aware,
        "collectives": {
            "counts": {k: int(v) for k, v in
                       aware["collective_counts"].items()},
            "result_bytes": {k: int(v) for k, v in
                             aware["collective_bytes"].items()},
            "ici_bytes": int(aware["ici_bytes"]),
        },
        "param_count": spec.config.param_count,
        "active_param_count": spec.config.active_param_count,
        "partitioned": True,
        "devices": mesh.size,
        "plan": plan,
        "ops": len(rec.events),
        "device_bytes": peak,
    }
    if mesh.size == 1:
        card = card_bytes(mesh)
        out.update(card_bytes=card,
                   fits=None if card is None else peak <= card)
    else:
        out.update(replicated_ops=rec.replicated,
                   target_bytes=TARGET_CHIP_BYTES,
                   fits=peak <= TARGET_CHIP_BYTES)
    if getattr(getattr(spec.config, "backbone", spec.config), "moe",
               None) is not None:
        out["moe_counts"] = "uniform"
    return out


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             out_dir: Path = OUT_DIR, *, device=None) -> dict:
    spec = get_arch(arch_id)
    shape = SHAPES[shape_name]
    if shape_name in spec.skip:
        rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
               "status": "skipped", "reason": spec.skip[shape_name]}
        _write(rec, out_dir)
        return rec
    rec = dry_run(spec, shape, mesh_name, device=device)
    mem = rec["memory"]
    print(f"[{arch_id} x {shape_name} x {mesh_name}] lower "
          f"{rec['lower_s']:.1f}s  args {mem['argument_bytes']:.3e} B/device"
          + ("" if mem["temp_bytes"] is None else
             f"  temp {mem['temp_bytes']:.3e} B  fits {rec['fits']}"))
    if rec["cost"]:
        print("  cost: flops=%.3e bytes=%.3e" % (
            rec["cost"].get("flops", 0.0),
            rec["cost"].get("bytes accessed", 0.0)))
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    (out_dir / name).write_text(json.dumps(rec, indent=2))


def _run_one(job) -> tuple | None:
    arch_id, shape_name, mesh_name, out_dir, device = job
    # DTensor warns of every two-step redistribution; the census counts them
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    try:
        run_cell(arch_id, shape_name, mesh_name, out_dir, device=device)
    except Exception:
        traceback.print_exc()
        return (arch_id, shape_name, mesh_name)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=[*MESHES, "both"], default="pod",
                    help="host (the card), pod, multipod, or both pods")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) cell (of --shapes, if given)")
    ap.add_argument("--shapes", nargs="+", choices=sorted(SHAPES),
                    help="with --all: only these shapes")
    ap.add_argument("--out", type=Path, default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="the host mesh's device: cuda (default; raises "
                         "without a card) or cpu")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells recorded at once, one process each (pod "
                         "cells always run in a process of their own)")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES
                 if not args.shapes or s in args.shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape required unless --all")
        cells = [(args.arch, args.shape)]
    jobs = [(a, s, m, args.out, args.device) for a, s in cells
            for m in meshes]
    if args.jobs > 1 or args.mesh != "host":
        import multiprocessing

        # one spawned process a cell: a pod cell's process group and its
        # DTensor caches die with it
        with multiprocessing.get_context("spawn").Pool(
                args.jobs, maxtasksperchild=1) as pool:
            results = pool.map(_run_one, jobs, chunksize=1)
    else:
        results = [_run_one(j) for j in jobs]
    failures = [r for r in results if r is not None]
    if failures:
        print("FAILED cells:", failures)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
