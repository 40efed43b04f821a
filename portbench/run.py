"""Run one cell once and print its result as the last line of output.

    python3 -m portbench.run --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start): the
program's model with the benchmark's seeded weights, and the cell's
warm-up.  Then the window: ``--seconds`` of the mix's traffic, traced
by ``torch.profiler`` with ``--trace 1``.  Then the comparison with the
plain reference that decides ``correct``, whose numbers, each beside
its limit, are the last lines on standard error and the last key of the
result.  With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read
by ``metrics/<name>.py``.

The run stops with an error and prints no result when no CUDA device
is there, when fewer are there than the cell asks for, or when a
module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

from portbench import compare, core

#: The device kinds the rooflines know: the published dense peaks.
PEAKS = core.HERE / "peaks.json"


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader (``metrics/<name>.py``'s
    ``read(ctx) -> float | None``) gets."""

    cell: core.Cell
    trace: object              # trace.Trace
    work: list                 # (rows, tokens a row) of each step/request
    window_peak_bytes: int
    peak: dict | None          # peaks.json's entry for the device


def read_metric(name: str, ctx: Context):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", core.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def device_peak(kind: str) -> dict | None:
    for name, peak in core.load_json(PEAKS).items():
        if name in kind:
            return peak
    return None


def run_cell(cell: core.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", *, spec=None, fault=None, info=None) -> dict:
    """The result object of one run (the printed line's content).
    ``info``, a dict, receives every number the comparison read and the
    run's seconds by part."""
    import torch

    loop = importlib.import_module(f"portbench.loops.{cell.mix['kind']}")
    res = loop.run(cell, seed, seconds, trace, device, spec=spec, fault=fault)
    if info is not None:
        info.update(numbers=res["numbers"], seconds=res["seconds"])
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"correct": None, "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {}, "device": dev}
    if trace:
        tr = res["trace"]
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        ctx = Context(cell, tr, res["work"], res["window_peak_bytes"],
                      device_peak(kind))
        for m in cell.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        out["breakdown"] = tr.breakdown
    else:
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {
                "value": res["end_to_end"][m["name"]], "unit": m["unit"]}
    ok, checks = compare.verdict(res["numbers"], cell.limits["limits"])
    out["correct"] = ok and res["failed"] == 0
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")

    import torch

    cell = core.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 3
    chips = next(w["chips"] for w in core.load_json(
        core.ROOT / "BENCHMARK.json")["workloads"] if w["name"] == cell.name)
    if torch.cuda.device_count() < chips:
        print(f"{cell.name} needs {chips} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    info: dict = {}
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   info=info)
    banned = core.banned_modules()
    if banned:
        print(f"modules of JAX or of the JAX package were loaded: {banned}",
              file=sys.stderr)
        return 4
    print("seconds " + " ".join(f"{k} {v!r}" for k, v in
                                info["seconds"].items()), file=sys.stderr)
    print("readings " + " ".join(f"{k} {v!r}" for k, v in
                                 info["numbers"].items()), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
