"""The partitioned dry-run (DTensor over a fake process group) against
the reference's SPMD compile, on the CPU:

* **Against the reference at 2x4.**  The reference's own integration
  test compiles six reduced cells on a 2x4 ``("data", "model")`` mesh
  (``tests/launch/test_steps_integration.py``); the same six are
  compiled here in one subprocess, with ``memory_analysis()``,
  ``loop_aware_cost`` and ``collective_summary``, and the port records
  them partitioned over a fake group of 8 in one spawned process.

  - Per-partition argument, output and alias bytes are equal, once the
    reference's three layout facts are counted: it holds a cache's
    ``length`` as int32 arrays (and a decode step's ``length`` as an
    int32 scalar) where the port holds Python ints; its ``jit`` drops an
    argument the step never reads (phi-3-vision's ``patch_proj.w`` in
    decode); and XLA's output size counts the output tuple's table, 8
    bytes a leaf.
  - Matmul FLOPs, bytes accessed, ``ici_bytes`` and ``temp_bytes`` lie
    in a ratio range (port / reference) per class and kind, each from
    the measurement below with a 5 % margin, each with its measured
    cause (:data:`RANGES`).
  - No work is lost: a partition's matmul FLOPs times the 8 partitions
    are at least the port's own one-device record of the cell.

* **Deterministic.**  Two recordings of a cell in one process, and in
  two spawned processes, give equal records.
* **No process group leaks.**  After a partitioned ``dry_run`` in this
  process, ``torch.distributed`` is not initialised.
* **Full size.**  ``--all --mesh both`` over the serving shapes writes
  every partitioned record and every skip with 0 failures,
  ``analysis/roofline.py::from_record`` reads each, and each serving
  cell's partition times its devices does at least the matmul FLOPs of
  its one-device record.  One full-size train cell runs here too; the
  whole ``--all --mesh both`` (66 records; zamba2-1.2b's train cell
  takes ~10 minutes a mesh) runs by hand: ``PYTHONPATH=src python
  tests/test_torch_dryrun_partitioned.py --all``.

``PYTHONPATH=src python tests/test_torch_dryrun_partitioned.py`` prints
the 2x4 ratios the ranges come from, and each cell's ``ici_bytes`` by
collective kind on both sides (the reference's inside its loops, the
port's in its backward and at f32 width), which the causes read.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("llama3-8b", 64, "train"),
    ("mixtral-8x7b", 64, "train"),
    ("mamba2-780m", 64, "train"),
    ("zamba2-1.2b", 64, "prefill"),
    ("seamless-m4t-medium", 64, "train"),
    ("phi-3-vision-4.2b", 32, "decode"),
]
CLASS = {"llama3-8b": "dense", "seamless-m4t-medium": "dense",
         "phi-3-vision-4.2b": "dense", "mixtral-8x7b": "moe",
         "mamba2-780m": "ssd", "zamba2-1.2b": "ssd"}
#: Arguments the reference's ``jit`` drops because the step never reads
#: them (their per-partition bytes are in the port's record).
PRUNED = {"phi-3-vision-4.2b": ("[0]['patch_proj.w']",)}
MARGIN = 0.05

#: (class, kind) -> quantity -> (low, high, cause), port / reference per
#: partition at 2x4; each bound is the measurement (``__main__``) widened
#: by MARGIN.
_CAUSE_DOT_DENSE = (
    "k and v are projected whole on every 'model' partition, as the rules "
    "replicate the kv heads there (llama3: 2 kv heads over the 4-way axis, "
    "pspec_for's fallback; seamless: C10's kv_heads 'tp' resolves to ()), "
    "in the forward, the remat recompute and the backward: 96-97 % of the "
    "forward's FLOPs beyond the one-device step (partition x 8 / one "
    "device: llama3 1.389, seamless 1.848); B4's backward is one op of "
    "10 D operations per visible pair, 2.5 times its forward (C9)")
_CAUSE_TEMP = (
    "xla:cpu legalizes bf16 to f32 and keeps the f32 copies (C8); the "
    "port frees a storage at its last use, XLA's buffer assignment does "
    "not")
_CAUSE_ICI = (
    "xla:cpu legalizes bf16 to f32 (C8), so the reference's collectives "
    "move f32 where the port's move bf16: with the port's bf16 collectives "
    "counted at f32 width, port / reference is 1.198 llama3, 1.057 "
    "seamless, 1.030 mixtral, 1.000 zamba2 prefill and phi-3 decode "
    "(__main__'s breakdown by kind); above 1 are DTensor's all-gathers "
    "in the backward (llama3: 331,776 B at f32 width against the "
    "reference's 65,536 B); the kinds differ (an all-reduce where XLA "
    "reduce-scatters) but under the ring model an all-reduce moves what "
    "a reduce-scatter and an all-gather move together")
RANGES = {
    ("dense", "train"): {
        "dot": (1.046, 1.338, _CAUSE_DOT_DENSE),
        "bytes": (0.782, 1.005, "ATen's unfused ops read and write every "
                  "intermediate; XLA fuses them but reads each stacked "
                  "weight whole in every layer (C8); B4's backward is one "
                  "op that reads its operands and writes its gradients "
                  "once"),
        "ici": (0.529, 0.600, _CAUSE_ICI),
        "temp": (0.674, 0.743, _CAUSE_TEMP),
    },
    ("dense", "decode"): {
        "dot": (1.000, 1.000, "the decode step's matmuls are the same "
                "products, split the same way"),
        "bytes": (0.529, 0.529, "the reference reads each stacked weight "
                  "whole and writes and reads an f32 copy (C8)"),
        "ici": (0.500, 0.500, _CAUSE_ICI),
        "temp": (0.139, 0.139, _CAUSE_TEMP),
    },
    ("moe", "train"): {
        "dot": (0.798, 0.798, "the port routes the kept (token, choice) "
                "pairs only, the reference's one-hot dispatch and combine "
                "einsums touch every expert slot (C8), against the kv "
                "projections repeated as in the dense class"),
        "bytes": (0.946, 0.946, "as the dense class"),
        "ici": (0.629, 0.629, _CAUSE_ICI),
        "temp": (0.708, 0.708, _CAUSE_TEMP),
    },
    ("ssd", "train"): {
        "dot": (1.156, 1.156, "B5 counts its chunk of 64 (the reference "
                "scans in its config's chunk) and its backward as one op of "
                "twice its forward's operations (C9); the whole model is "
                "replicated over the mesh in both (C10)"),
        "bytes": (0.551, 0.551, "B5's backward is one op that reads its "
                  "operands and writes its gradients once; the reference's "
                  "differentiated scan writes and reads its chunk "
                  "intermediates"),
        "ici": (0.0, 0.0, "no collective in either: mamba2-780m's rules "
                "replicate every operand (C10)"),
        "temp": (0.612, 0.612, "B5's backward is one op and holds no "
                 "chunk intermediates; " + _CAUSE_TEMP),
    },
    ("ssd", "prefill"): {
        "dot": (1.570, 1.570, "B5 counts its chunk of 64 against the "
                "reference's chunk (C8: 1.66-1.81 on the traces)"),
        "bytes": (0.681, 0.681, "as the dense class"),
        "ici": (0.504, 0.504, _CAUSE_ICI),
        "temp": (0.496, 0.496, _CAUSE_TEMP),
    },
}

REFERENCE_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, math
import jax
import jax.numpy as jnp
from repro.analysis.hlo import collective_summary
from repro.analysis.hlo_cost import loop_aware_cost
from repro.configs.base import Shape
from repro.configs.reduced import reduced_arch
from repro.launch.mesh import make_mesh_compat
from repro.launch.steps import build_cell, lower_cell

def per_device(leaf, sh):
    return math.prod(sh.shard_shape(leaf.shape)) * leaf.dtype.itemsize

mesh = make_mesh_compat((2, 4), ("data", "model"))
out = {}
for arch, seq, kind in CASES:
    cell = build_cell(reduced_arch(arch), Shape("t", seq, 8, kind), mesh)
    lowered = lower_cell(cell)
    compiled = lowered.compile()
    mem = compiled.memory_analysis()
    txt = compiled.as_text()
    args = jax.tree_util.tree_leaves(cell.abstract_args)
    shs = jax.tree_util.tree_leaves(
        cell.in_shardings, is_leaf=lambda x: hasattr(x, "shard_shape"))
    ints = 0
    if kind != "train":
        ints = sum(per_device(x, s) for x, s in zip(
            jax.tree_util.tree_leaves(cell.abstract_args[2]),
            jax.tree_util.tree_leaves(
                cell.in_shardings[2],
                is_leaf=lambda x: hasattr(x, "shard_shape")))
            if x.dtype == jnp.int32)
    out[arch] = {
        "memory": {"argument_bytes": int(mem.argument_size_in_bytes),
                   "output_bytes": int(mem.output_size_in_bytes),
                   "temp_bytes": int(mem.temp_size_in_bytes),
                   "alias_bytes": int(mem.alias_size_in_bytes)},
        "loop_aware_cost": loop_aware_cost(txt),
        "collectives": collective_summary(txt),
        "all_argument_bytes": sum(per_device(x, s)
                                  for x, s in zip(args, shs)),
        "cache_int_bytes": ints,
        "scalar_int_bytes": 4 if kind == "decode" else 0,
        "output_leaves": len(jax.tree_util.tree_leaves(lowered.out_info)),
    }
    if BREAKDOWN:
        out[arch]["ici_split"] = ici_split(txt)
print("REF-JSON " + json.dumps(out))
"""

#: ``ici_bytes`` of the reference's loop-aware cost by collective kind,
#: and the part of each inside a ``while`` body (its trips counted), by
#: recounting with every other kind's traffic, then every loop's trips,
#: set to 0 (``__main__`` only).
REFERENCE_SPLIT = r"""
import re
import repro.analysis.hlo_cost as hc

def ici_split(txt):
    traffic, trip_re, trips = hc._traffic, hc._TRIP_RE, \
        hc.HloCostModel._trip_count
    out = {}
    try:
        for kind in ("all-reduce", "all-gather", "reduce-scatter",
                     "all-to-all", "collective-permute"):
            hc._traffic = lambda op, rb, n, k=kind: \
                traffic(op, rb, n) if op == k else 0.0
            total = hc.loop_aware_cost(txt)["ici_bytes"]
            hc._TRIP_RE = re.compile(r"(?!)")
            hc.HloCostModel._trip_count = lambda self, cond: 0.0
            outside = hc.loop_aware_cost(txt)["ici_bytes"]
            hc._TRIP_RE, hc.HloCostModel._trip_count = trip_re, trips
            if total:
                out[kind] = {"ici": total, "in_loop": total - outside}
    finally:
        hc._traffic, hc._TRIP_RE, hc.HloCostModel._trip_count = \
            traffic, trip_re, trips
    out["trips"] = sorted({int(t) for t in trip_re.findall(txt)})
    return out
"""


def port_ici_split(arch: str, seq: int, kind: str) -> dict:
    """The port's partition at 2x4: ``ici_bytes`` by collective kind, the
    part of each that the backward pass issues (an op recorded while
    autograd runs a graph task), and the part that moves bf16 (which
    xla:cpu legalizes to f32: ``at_f32`` counts it at f32 width)."""
    import logging

    import torch

    from repro_torch.analysis import aten_trace
    from repro_torch.analysis.hlo import _traffic
    from repro_torch.configs.base import Shape
    from repro_torch.configs.reduced import reduced_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    backward, recs = [], []
    group_size, lower = aten_trace._group_size, dryrun.lower_cell

    def tagged(args):
        backward.append((torch._C._current_graph_task_id() != -1,
                         4 / args[0].element_size()))
        return group_size(args)

    def keep(cell):
        rec, result = lower(cell)
        recs.append(rec)
        return rec, result
    aten_trace._group_size, dryrun.lower_cell = tagged, keep
    try:
        dryrun.dry_run(reduced_arch(arch), Shape("t", seq, 8, kind), "pod",
                       mesh=Mesh(("data", "model"), (2, 4)))
    finally:
        aten_trace._group_size, dryrun.lower_cell = group_size, lower
    out: dict = {}
    events = [ev for ev in recs[-1].events if ev.kind == "collective"]
    for ev, (bwd, widen) in zip(events,
                                backward[-len(events):] if events else []):
        name = aten_trace.COLLECTIVES[ev.op]
        ici = _traffic(name, sum(r.nbytes for r in ev.results), ev.group)
        row = out.setdefault(name, {"ici": 0.0, "backward": 0.0,
                                    "at_f32": 0.0})
        row["ici"] += ici
        row["backward"] += ici if bwd else 0.0
        row["at_f32"] += ici * widen
    return out

PORT_SCRIPT = r"""
import json, logging, sys
logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
from repro_torch.configs.base import Shape
from repro_torch.configs.reduced import reduced_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

host = sys.argv[1] == "host"
out = {}
for arch, seq, kind in CASES:
    spec, shape = reduced_arch(arch), Shape("t", seq, 8, kind)
    rec = dryrun.dry_run(spec, shape, "pod",
                         mesh=Mesh(("data", "model"), (2, 4)))
    rec.pop("lower_s")
    out[arch] = {"pod": rec}
    if host:
        one = dryrun.dry_run(spec, shape, "host", device="cpu")
        one.pop("lower_s")
        out[arch]["host"] = one
print("PORT-JSON " + json.dumps(out))
"""


def _run(script: str, tag: str, *args, jax: bool = False,
         breakdown: bool = False) -> dict:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", str(ROOT))}
    if jax:
        # without this jax probes accelerator plugins for minutes
        env["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS", "cpu")
    head = f"CASES = {CASES!r}\nBREAKDOWN = {breakdown}\n"
    if breakdown:
        head += REFERENCE_SPLIT
    proc = subprocess.run(
        [sys.executable, "-c", head + script, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith(tag + " "))
    return json.loads(line[len(tag) + 1:])


@pytest.fixture(scope="module")
def reference() -> dict:
    return _run(REFERENCE_SCRIPT, "REF-JSON", jax=True)


@pytest.fixture(scope="module")
def port() -> dict:
    return _run(PORT_SCRIPT, "PORT-JSON", "host")


def _dot(rec: dict) -> float:
    return rec["loop_aware_cost"]["dominant_flop_ops"].get("dot", 0.0)


def ratios(ref: dict, rec: dict) -> dict:
    """Port / reference of each ranged quantity (0 where both are 0)."""
    def r(a, b):
        return 0.0 if a == b == 0 else a / b
    rc, pc = ref["loop_aware_cost"], rec["loop_aware_cost"]
    return {
        "dot": r(_dot(rec), rc["dominant_flop_ops"].get("dot", 0.0)),
        "bytes": r(pc["bytes"], rc["bytes"]),
        "ici": r(pc["ici_bytes"], rc["ici_bytes"]),
        "temp": r(rec["memory"]["temp_bytes"], ref["memory"]["temp_bytes"]),
    }


def _leaf_bytes(rec: dict, name: str, arch: str) -> int:
    """Per-partition bytes of an argument leaf of the reduced cell."""
    from repro_torch.configs.reduced import reduced_arch
    from repro_torch.launch.steps import abstract_params, stacked_params

    spec = rec["plan"]["specs"][name]
    leaf = stacked_params(abstract_params(reduced_arch(arch))[0])[
        name.split("'")[1]]
    shards = math.prod({"data": 2, "model": 4}[a] for e in spec if e
                       for a in ([e] if isinstance(e, str) else e))
    return leaf.numel() * leaf.element_size() // shards


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_bytes_equal_the_references(arch, reference, port):
    ref, rec = reference[arch], port[arch]["pod"]
    mem, rmem = rec["memory"], ref["memory"]
    pruned = sum(_leaf_bytes(rec, n, arch) for n in PRUNED.get(arch, ()))
    ints = ref["cache_int_bytes"]
    # the reference counts every argument it keeps, the port every one
    assert ref["all_argument_bytes"] - rmem["argument_bytes"] == pruned
    assert mem["argument_bytes"] + ints + ref["scalar_int_bytes"] - \
        pruned == rmem["argument_bytes"]
    assert mem["output_bytes"] + ints + 8 * ref["output_leaves"] == \
        rmem["output_bytes"]
    assert mem["alias_bytes"] + ints == rmem["alias_bytes"]
    assert rec["partitioned"] and rec["devices"] == 8


@pytest.mark.parametrize("arch,seq,kind", CASES, ids=[c[0] for c in CASES])
def test_cost_within_class_ranges(arch, seq, kind, reference, port):
    got = ratios(reference[arch], port[arch]["pod"])
    for name, (lo, hi, cause) in RANGES[(CLASS[arch], kind)].items():
        assert lo * (1 - MARGIN) <= got[name] <= hi * (1 + MARGIN), \
            (name, got[name], cause)


@pytest.mark.parametrize("arch", [c[0] for c in CASES])
def test_no_work_lost_at_2x4(arch, port):
    pod, host = port[arch]["pod"], port[arch]["host"]
    assert _dot(pod) * pod["devices"] >= _dot(host) * (1 - 1e-9)
    assert pod["cost"]["flops"] > 0 and pod["memory"]["temp_bytes"] > 0


def test_records_are_deterministic(port):
    """Two spawned processes, and two recordings in one, give one
    record."""
    again = _run(PORT_SCRIPT, "PORT-JSON", "pod")
    assert {a: r["pod"] for a, r in again.items()} == \
        {a: r["pod"] for a, r in port.items()}

    from repro_torch.configs.base import Shape
    from repro_torch.configs.reduced import reduced_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    def once():
        rec = dryrun.dry_run(reduced_arch("mixtral-8x7b"),
                             Shape("t", 64, 8, "train"), "pod",
                             mesh=Mesh(("data", "model"), (2, 4)))
        rec.pop("lower_s")
        return rec
    first = once()
    assert once() == first == port["mixtral-8x7b"]["pod"]


def test_no_process_group_outlives_a_dry_run(monkeypatch):
    import torch.distributed as dist

    from repro_torch.configs.reduced import SMOKE_SHAPE, reduced_arch
    from repro_torch.launch import dryrun

    rec = dryrun.dry_run(reduced_arch("llama3-8b"), SMOKE_SHAPE, "pod")
    assert rec["partitioned"] and rec["devices"] == 256
    assert not dist.is_initialized()

    def broken(cell):
        raise RuntimeError("the step failed")
    monkeypatch.setattr(dryrun, "lower_cell", broken)
    with pytest.raises(RuntimeError, match="step failed"):
        dryrun.dry_run(reduced_arch("llama3-8b"), SMOKE_SHAPE, "multipod")
    assert not dist.is_initialized()


SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")


def _check_full_records(recs: list, host: dict,
                        roofline_reads: bool = True) -> None:
    """Each partitioned record's keys; ``from_record`` reads it (a named
    shape's); no work lost against ``host``'s record of its cell."""
    from repro_torch.analysis import roofline

    for r in recs:
        assert r["partitioned"] and r["devices"] == (
            512 if r["mesh"] == "multipod" else 256)
        assert r["cost"]["flops"] > 0 and r["memory"]["temp_bytes"] > 0
        assert r["collectives"]["counts"] is not None
        assert isinstance(r["fits"], bool)
        assert r["device_bytes"] == r["memory"]["argument_bytes"] + \
            r["memory"]["temp_bytes"]
        if roofline_reads:
            row = roofline.from_record(r)
            assert row.chips == r["devices"] and row.t_step_bound_s > 0
        one = host.get((r["arch"], r["shape"]))
        if one is not None:     # no work lost
            assert _dot(r) * r["devices"] >= _dot(one) * (1 - 1e-9), (
                r["arch"], r["shape"], r["mesh"])


def test_full_size_serving_cells_on_both_pod_meshes(tmp_path):
    """``--all --mesh both`` over the serving shapes: 46 partitioned
    records and the 14 skips of those shapes, 0 failures; each read by
    ``from_record``; each partition x devices at least the one-device
    record's matmul FLOPs."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import REGISTRY
    from repro_torch.launch import dryrun

    jobs = str(min(4, os.cpu_count() or 1))
    pods, hosts = tmp_path / "pods", tmp_path / "host"
    assert dryrun.main(["--all", "--mesh", "both", "--shapes",
                        *SERVE_SHAPES, "--jobs", jobs, "--out",
                        str(pods)]) == 0
    assert dryrun.main(["--all", "--mesh", "host", "--device", "cpu",
                        "--shapes", *SERVE_SHAPES, "--jobs", jobs, "--out",
                        str(hosts)]) == 0
    recs = [json.loads(p.read_text()) for p in pods.glob("*.json")]
    skipped = [r for r in recs if r["status"] == "skipped"]
    ok = [r for r in recs if r["status"] == "ok"]
    assert len(ok) == 46 and len(skipped) == 14
    for r in skipped:
        assert r["reason"] == REGISTRY[r["arch"]].skip[r["shape"]]
    host = {(r["arch"], r["shape"]): r for r in (
        json.loads(p.read_text()) for p in hosts.glob("*.json"))
        if r["status"] == "ok"}
    assert len(host) == 23
    _check_full_records(ok, host)
    rows = [roofline.from_record(r) for r in ok]
    assert roofline.format_table(rows).count("multipod") == 23
    mamba = next(r for r in ok if r["arch"] == "mamba2-780m"
                 and r["shape"] == "decode_32k" and r["mesh"] == "pod")
    assert mamba["plan"]["specs"]["[1]['token']"] == []     # C10
    assert mamba["collectives"]["counts"] == {}     # everything replicated


#: One reduced train cell of each family on the 16x16 pod (256 ranks):
#: 32 sequences, so that the reduced spec's two microbatches each keep
#: 16 rows, one a "data" partition.
POD_TRAIN = ("llama3-8b", "mixtral-8x7b", "arctic-480b", "mamba2-780m",
             "zamba2-1.2b", "seamless-m4t-medium", "phi-3-vision-4.2b")


@pytest.mark.parametrize("arch", POD_TRAIN)
def test_each_familys_train_cell_on_the_pod(arch):
    from repro_torch.configs.base import Shape
    from repro_torch.configs.reduced import reduced_arch
    from repro_torch.launch import dryrun

    spec, shape = reduced_arch(arch), Shape("smoke", 64, 32, "train")
    rec = dryrun.dry_run(spec, shape, "pod")
    host = dryrun.dry_run(spec, shape, "host", device="cpu")
    _check_full_records([rec], {(rec["arch"], rec["shape"]): host},
                        roofline_reads=False)
    # a microbatch cuts across the partitions' rows: gathered and counted
    # (mamba2-780m's rules replicate its batch, C10: nothing to gather)
    gathered = [k for k in rec["replicated_ops"]
                if k.startswith("train_step.microbatch: [32, ")]
    assert bool(gathered) == (arch != "mamba2-780m"), rec["replicated_ops"]


def test_a_full_size_train_cell_on_the_pod():
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun

    rec = dryrun.dry_run(get_arch("llama3-8b"), SHAPES["train_4k"], "pod")
    _check_full_records([rec], {})
    # every microbatch cuts across the partitions' rows: the gather is
    # recorded, and nothing else is replicated for lack of a strategy
    assert set(rec["replicated_ops"]) == {
        "train_step.microbatch: [256, 4096]"}
    assert rec["collectives"]["counts"]["all-reduce"] > 0


def _main(argv) -> int:
    """Print the 2x4 ratios (and with ``--all``, run every cell on both
    pod meshes and on the host mesh and check the full-size contract)."""
    ref = _run(REFERENCE_SCRIPT, "REF-JSON", jax=True, breakdown=True)
    got = _run(PORT_SCRIPT, "PORT-JSON", "host")
    for arch, seq, kind in CASES:
        r = ratios(ref[arch], got[arch]["pod"])
        pod, host = got[arch]["pod"], got[arch]["host"]
        print(f"{arch:22s} {kind:8s} " + "  ".join(
            f"{k} {v:.3f}" for k, v in r.items())
            + f"  part*8/host dot {_dot(pod) * 8 / _dot(host):.4f}"
            + f"  port {pod['collectives']['counts']}"
            + f"  ref {ref[arch]['collectives']['counts']}")
        print(f"    ici by kind, reference (in loop bodies, trips "
              f"{ref[arch]['ici_split'].pop('trips')}): "
              + json.dumps(ref[arch]["ici_split"]))
        split = port_ici_split(arch, seq, kind)
        ref_ici = ref[arch]["loop_aware_cost"]["ici_bytes"]
        print("    ici by kind, port (in the backward; bf16 counted at f32 "
              "width): " + json.dumps(split))
        if ref_ici:
            print("    port ici at f32 width / reference: "
                  f"{sum(r['at_f32'] for r in split.values()) / ref_ici:.3f}")
    if "--all" in argv:
        import tempfile
        import time

        from repro_torch.launch import dryrun

        jobs = str(os.cpu_count() or 1)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            assert dryrun.main(["--all", "--mesh", "both", "--jobs", jobs,
                                "--out", f"{tmp}/pods"]) == 0
            t1 = time.perf_counter()
            assert dryrun.main(["--all", "--mesh", "host", "--device",
                                "cpu", "--jobs", jobs, "--out",
                                f"{tmp}/host"]) == 0
            recs = [json.loads(p.read_text())
                    for p in Path(tmp, "pods").glob("*.json")]
            ok = [r for r in recs if r["status"] == "ok"]
            host = {(r["arch"], r["shape"]): r for r in (
                json.loads(p.read_text())
                for p in Path(tmp, "host").glob("*.json"))
                if r["status"] == "ok"}
            _check_full_records(ok, host)
            print(f"--all --mesh both: {len(ok)} partitioned, "
                  f"{len(recs) - len(ok)} skipped, 0 failures, "
                  f"{t1 - t0:.1f} s at --jobs {jobs}; every partition x "
                  "devices >= its host record's matmul FLOPs")
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
