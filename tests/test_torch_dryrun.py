"""The dry-run on the meta device, on the CPU (no card, nothing
allocated):

* the meta recording of a model step is the CPU recording of the model
  graph source op for op, except the kernels: on the CPU B4's and B5's
  forwards and backwards run their plain versions, on meta each is one
  op (``repro_torch::flash_attention`` / ``ssd_scan`` and their
  ``_bwd`` ops) whose FLOPs are the kernel's own count, checked here
  against closed forms (a backward's: 2.5 and 2 times its forward's), and
  whose outputs have the kernel's layout.  The CPU side runs the plain
  versions out of the recorder's sight, into tensors of the kernels'
  layouts, so the rest of the step is the same program; the meta side also copies
  RoPE's host frequencies to the device, which on the CPU is no op.
  MoE archs route by values, which meta has not (uniform counts):
  their dense FLOPs are compared instead;
* ``run_cell`` on a full-size cell of every family on the host mesh
  completes in a fresh process whose RSS grows by less than 1 GB;
* the records: the reference's keys, skipped cells as the reference
  writes them, ``--all --mesh pod`` over the decode shapes writes every
  partitioned record and skip (each pod cell a partition's recording:
  the train cells take minutes, so the full sweep runs by hand,
  ``tests/test_torch_dryrun_partitioned.py``), and
  ``analysis/roofline.py::from_record`` reads a host record as one chip
  and a pod record as 256, and refuses one marked unpartitioned.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.analysis import aten_trace, roofline
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.configs.reduced import reduced_arch
from repro_torch.kernels.ssd_scan import CHUNK
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
FA = importlib.import_module("repro_torch.kernels.flash_attention."
                             "flash_attention")
SC = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
DENSE = ("llama3-8b", "yi-34b", "deepseek-67b", "codeqwen1.5-7b",
         "phi-3-vision-4.2b", "seamless-m4t-medium", "mamba2-780m",
         "zamba2-1.2b")
MOE = ("mixtral-8x7b", "arctic-480b")
STEPS = ("prefill", "decode", "train")
KERNEL_OPS = ("flash_attention", "ssd_scan", "flash_attention_bwd",
              "ssd_scan_bwd")
REF_KEYS = {"arch", "shape", "mesh", "status", "kind", "lower_s",
            "compile_s", "memory", "bf16_legalization_overhead_bytes",
            "cost", "loop_aware_cost", "collectives", "param_count",
            "active_param_count"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes", "alias_bytes"}


@pytest.fixture
def plain_forwards_unseen(monkeypatch):
    """B4's and B5's CPU forwards and backwards (their plain versions)
    run out of the recorder's sight, into outputs of the kernels'
    layouts."""
    def hidden(fn, layout, first=lambda a: a[0]):
        def wrapped(*args, **kw):
            if first(args).device.type != "cpu":
                return fn(*args, **kw)
            with _disable_current_modes():
                return layout(args, fn(*args, **kw))
        return wrapped

    def contiguous(outs):   # the backward kernels' gradients
        return tuple(None if o is None else o.contiguous() for o in outs)

    monkeypatch.setattr(FA, "_forward", hidden(
        FA._forward, lambda a, o: torch.empty_like(a[0]).copy_(o)))
    monkeypatch.setattr(SC, "_forward", hidden(
        SC._forward, lambda a, o: (torch.empty(
            a[0].shape, dtype=a[0].dtype).copy_(o[0]), o[1])))
    monkeypatch.setattr(FA, "flash_attention_bwd", hidden(
        FA.flash_attention_bwd, lambda a, o: contiguous(o)))
    monkeypatch.setattr(SC, "_autograd_backward", hidden(
        SC._autograd_backward, lambda a, o: contiguous(o),
        first=lambda a: a[0][0]))


def _sig(ev) -> tuple:
    return (ev.op, ev.kind, ev.flops, tuple(r.nbytes for r in ev.operands),
            tuple(r.nbytes for r in ev.results))


def _host_copy(rec, ev) -> bool:
    """RoPE's frequencies copied from the host: a real copy on a device,
    no op on the CPU."""
    return ev.op == "_to_copy" and rec.devices[ev.operands[0].storage] == \
        "cpu"


def _attention_ops(q_shape, causal, q_offset, kv_len, window) -> float:
    """4·D per visible (row, column) pair, counted pair by pair."""
    b, h, sq, d = q_shape
    pairs = 0
    for i in range(sq):
        for j in range(kv_len):
            if causal and j > q_offset + i:
                continue
            if window and j <= q_offset + i - window:
                continue
            pairs += 1
    return 4.0 * d * pairs * b * h


def _scan_ops(b, s, h, p, n) -> float:
    """The chunked scan's multiply-adds, chunk by chunk, two each."""
    total = 0.0
    for c0 in range(0, s, CHUNK):
        lc = min(CHUNK, s - c0)
        pairs = lc * (lc + 1) // 2
        total += 2 * (pairs * n + h * pairs * p + 2 * h * lc * n * p)
    return total * b


def _check_kernel_op(ev, args) -> None:
    if ev.op.startswith("flash_attention"):
        q, *_, causal, _, q_offset, kv_len, window = args
        ops = _attention_ops(tuple(q.shape), causal, q_offset, kv_len,
                             window)
        assert ev.flops == (2.5 * ops if ev.op.endswith("_bwd") else ops)
    else:
        x, _, bb = args[:3]
        ops = _scan_ops(*x.shape, bb.shape[-1])
        assert ev.flops == (2 * ops if ev.op.endswith("_bwd") else ops)
    assert ev.kind == "dot"


@pytest.fixture
def kernel_args(monkeypatch):
    """The arguments of every meta kernel op, in order."""
    seen = []
    for mod, name in ((FA, "_meta_op"), (SC, "_meta_op"),
                      (FA, "_meta_bwd_op"), (SC, "_meta_bwd_op")):
        op = getattr(mod, name)

        def wrapped(*args, _op=op):
            seen.append(args)
            return _op(*args)
        monkeypatch.setattr(mod, name, wrapped)
    return seen


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", DENSE)
def test_meta_census_is_the_cpu_census(arch, step, plain_forwards_unseen,
                                       kernel_args):
    cpu = aten_trace.record_model_step(arch, step)
    meta = aten_trace.record_model_step(arch, step, "meta")
    kernels = [ev for ev in meta.events if ev.op in KERNEL_OPS]
    rest = [_sig(ev) for ev in meta.events
            if ev.op not in KERNEL_OPS and not _host_copy(meta, ev)]
    assert rest == [_sig(ev) for ev in cpu.events]
    assert len(kernels) == len(kernel_args)
    assert kernels or (arch, step) == ("mamba2-780m", "decode")
    for ev, args in zip(kernels, kernel_args):
        _check_kernel_op(ev, args)
        assert sum(r.nbytes for r in ev.operands) == sum(
            t.numel() * t.element_size() for t in args
            if isinstance(t, torch.Tensor))
    assert meta.peak_bytes > 0 and all(
        d in ("cpu", "meta") for d in meta.devices)


@pytest.mark.parametrize("step", ("prefill", "decode"))
@pytest.mark.parametrize("arch", MOE)
def test_moe_meta_routes_the_uniform_load(arch, step, plain_forwards_unseen):
    """Serving routes every (token, choice) pair, so the experts' rows
    sum to tokens * top_k however the router chose: the dense FLOPs of
    the meta step equal the CPU step's."""
    cpu = aten_trace.record_model_step(arch, step)
    meta = aten_trace.record_model_step(arch, step, "meta")

    def dots(rec):
        return sum(ev.flops for ev in rec.events if ev.kind == "dot"
                   and ev.op not in KERNEL_OPS)
    assert dots(meta) == dots(cpu)


def test_uniform_counts():
    from repro_torch.models.moe import MoEConfig, _capacity, uniform_counts

    cfg = MoEConfig(num_experts=8, top_k=2, tokens_per_group=32)
    assert uniform_counts(100, cfg, drop=False) == [25] * 8
    assert sum(uniform_counts(7, cfg, drop=False)) == 14
    capped = uniform_counts(128, MoEConfig(num_experts=2, top_k=2,
                                           capacity_factor=0.5,
                                           tokens_per_group=32), drop=True)
    assert capped == [_capacity(32, MoEConfig(
        num_experts=2, top_k=2, capacity_factor=0.5)) * 4] * 2


FULL_CELLS = [("llama3-8b", "decode_32k"), ("mamba2-780m", "long_500k"),
              ("zamba2-1.2b", "decode_32k"), ("seamless-m4t-medium",
                                              "decode_32k"),
              ("phi-3-vision-4.2b", "decode_32k"),
              ("mixtral-8x7b", "decode_32k")]

RSS_PROBE = """
import json, resource, sys
from pathlib import Path
from repro_torch.launch import dryrun
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
rec = dryrun.run_cell(sys.argv[1], sys.argv[2], "host", Path(sys.argv[3]),
                      device="cpu")
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"grew_kib": after - before, "rec": rec}))
"""


@pytest.mark.parametrize("arch,shape", FULL_CELLS,
                         ids=[a for a, _ in FULL_CELLS])
def test_full_size_cell_allocates_nothing(arch, shape, tmp_path):
    out = subprocess.run(
        [sys.executable, "-c", RSS_PROBE, arch, shape, str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, check=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["grew_kib"] < 2**20, res["grew_kib"]      # < 1 GB
    rec = res["rec"]
    spec = REGISTRY[arch]
    assert rec["partitioned"] and rec["devices"] == 1
    assert rec["param_count"] == spec.config.param_count
    assert rec["memory"]["argument_bytes"] > 2 * spec.config.param_count
    assert rec["cost"]["flops"] > 2 * spec.config.active_param_count * \
        SHAPES[shape].global_batch
    assert (rec.get("moe_counts") == "uniform") == (arch in MOE)
    assert json.loads((tmp_path / f"{arch}__{shape}__host.json")
                      .read_text()) == rec


def test_records_have_the_references_keys_and_roofline_reads_them():
    spec = reduced_arch("llama3-8b")
    from repro_torch.configs.reduced import SMOKE_SHAPE

    host = dryrun.dry_run(spec, SMOKE_SHAPE, "host", device="cpu")
    assert REF_KEYS <= set(host) and set(host["memory"]) == MEM_KEYS
    assert host["collectives"]["ici_bytes"] == 0
    assert host["bf16_legalization_overhead_bytes"] == 0
    assert host["device_bytes"] == host["memory"]["argument_bytes"] + \
        host["memory"]["temp_bytes"]
    assert host["fits"] is None and host["card_bytes"] is None  # no card
    assert host["memory"]["alias_bytes"] <= host["memory"]["argument_bytes"]
    pod = dryrun.dry_run(spec, SMOKE_SHAPE, "pod")
    assert REF_KEYS <= set(pod) and pod["partitioned"]
    assert pod["devices"] == 256 and pod["memory"]["temp_bytes"] > 0
    assert pod["collectives"]["ici_bytes"] > 0
    assert pod["cost"]["flops"] < host["cost"]["flops"]
    assert pod["memory"]["argument_bytes"] < host["memory"]["argument_bytes"]
    rec = dict(host, shape="train_4k")
    r = roofline.from_record(rec)
    assert r.chips == 1 and r.hlo_flops_chip == host["cost"]["flops"]
    r = roofline.from_record(dict(pod, shape="train_4k"))
    assert r.chips == 256 and r.hlo_flops_chip == pod["cost"]["flops"]
    with pytest.raises(ValueError, match="C12"):
        roofline.from_record(dict(pod, shape="train_4k", partitioned=False))


def test_fits_holds_the_peak_against_the_cards_memory(monkeypatch):
    """``fits`` reads the card's ``total_memory`` off the host mesh's
    device: no constant, and no card off CUDA."""
    from types import SimpleNamespace

    from repro_torch.configs.reduced import SMOKE_SHAPE
    from repro_torch.launch.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: SimpleNamespace(total_memory=85 << 30))
    cuda = Mesh(("data",), (1,), (torch.device("cuda", 0),))
    assert dryrun.card_bytes(cuda) == 85 << 30
    assert dryrun.card_bytes(dryrun.make_mesh("host", "cpu")) is None
    spec = reduced_arch("llama3-8b")
    peak = dryrun.dry_run(spec, SMOKE_SHAPE, "host",
                          device="cpu")["device_bytes"]
    for card in (peak, peak - 1):
        monkeypatch.setattr(dryrun, "card_bytes", lambda mesh, c=card: c)
        rec = dryrun.dry_run(spec, SMOKE_SHAPE, "host", device="cpu")
        assert rec["card_bytes"] == card
        assert rec["fits"] is (card == peak)


def test_all_cells_on_the_pod_mesh(tmp_path, capsys):
    """``--all --mesh pod`` over the decode shapes: 13 partitioned records
    and the 7 skipped cells, the skips as the reference writes them."""
    assert dryrun.main(["--all", "--mesh", "pod", "--shapes", "decode_32k",
                        "long_500k", "--jobs", "2", "--out",
                        str(tmp_path)]) == 0
    recs = [json.loads(p.read_text()) for p in tmp_path.glob("*.json")]
    assert len(recs) == 20
    skipped = [r for r in recs if r["status"] == "skipped"]
    assert len(skipped) == 7
    for r in skipped:
        assert set(r) == {"arch", "shape", "mesh", "status", "reason"}
        assert r["reason"] == REGISTRY[r["arch"]].skip[r["shape"]]
    plans = [r for r in recs if r["status"] == "ok"]
    assert all(r["partitioned"] and r["devices"] == 256
               and r["plan"]["specs"] for r in plans)
    mamba = next(r for r in plans if r["arch"] == "mamba2-780m"
                 and r["shape"] == "decode_32k")
    assert mamba["plan"]["specs"]["[1]['token']"] == []     # C10
    assert np.isfinite([r["memory"]["argument_bytes"] + r["memory"][
        "temp_bytes"] + r["cost"]["flops"] for r in plans]).all()
