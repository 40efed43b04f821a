"""The control of a cell's comparison, and its planted faults: what the
comparison reads when the reference itself, in the precision below the
configuration's (float8 e4m3 for bfloat16: ``Precision("fp8")``), or
with a fault planted in it, takes the program's place.  Each must fail
the cell's limits; their readings set the limits' upper ends (PERF.md).

    python3 -m portbench.control --workload <name> --seeds 1 2 3 \\
        [--faults fp8 window]

Prefill cells: the requests that a run's check compares, served by the
float32 reference and by the control (``fp8``), or by the float32
reference without the configuration's sliding window (``window``); the
served token is the control's greedy pick.  Training cells: the checked
steps from the seeded weights, by the float32 reference and by the
control (``fp8``), or by the float32 reference over the first half of
each batch's rows, the mean taken over them (``half_batch``).  One JSON
line a seed and fault.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from portbench import compare, core, traffic
from portbench.loops.prefill import picks, sample
from portbench.reference.common import Precision, strict_f32


def prefill_readings(cell: core.Cell, seed: int, device,
                     faults=("fp8",)) -> dict:
    """``{fault: numbers}``, the float32 reference served once."""
    sizes, mix = cell.config["sizes"], cell.mix
    ref = cell.module("reference")
    vocab, heads = sizes["vocab"], ref.state_heads(sizes)
    chosen = sample(mix, seed)
    prompts = [traffic.prompt(mix, seed, i, vocab) for i in chosen]
    pk = [picks(mix, seed, i, traffic.request_length(mix, seed, i), heads)
          for i in chosen]
    want = ref.prefill(sizes, seed, prompts, pk, device, Precision("f32"))
    out = {}
    for fault in faults:
        if fault == "fp8":
            have = ref.prefill(sizes, seed, prompts, pk, device,
                               Precision("fp8"))
        elif fault == "window":
            have = ref.prefill({**sizes, "window": None}, seed, prompts, pk,
                               device, Precision("f32"))
        else:
            raise ValueError(f"no fault {fault!r} for a prefill cell")
        for h in have:
            h["token"] = h["logits"].argmax(dim=-1, keepdim=True)
        out[fault] = compare.prefill_numbers(
            have, want, [p["positions"] for p in pk], sizes.get("window"))
    return out


def train_reading(cell: core.Cell, seed: int, device,
                  fault: str | None = None) -> dict:
    sizes, mix = cell.config["sizes"], cell.mix
    opt = {**cell.config["optimizer"], **mix["schedule"]}
    ref = cell.module("reference")
    batches = [traffic.train_batch(mix, seed, s, sizes["vocab"])
               for s in range(mix["checked_steps"])]
    want = ref.train(sizes, opt, seed, batches, device, Precision("f32"))
    if fault not in (None, "half_batch"):
        raise ValueError(f"no fault {fault!r} for a training cell")
    if fault == "half_batch":
        half = [(t[: len(t) // 2], lab[: len(lab) // 2])
                for t, lab in batches]
        have = ref.train(sizes, opt, seed, half, device, Precision("f32"))
    else:
        have = ref.train(sizes, opt, seed, batches, device, Precision("fp8"))
    return compare.train_numbers(have, want)


def readings(cell: core.Cell, seed: int, device, faults=("fp8",)) -> dict:
    """``{fault: numbers}`` of one seed."""
    strict_f32()
    if cell.mix["kind"] == "train":
        return {f: train_reading(cell, seed, device,
                                 None if f == "fp8" else f) for f in faults}
    return prefill_readings(cell, seed, device, faults)


def reading(cell: core.Cell, seed: int, device, *,
            fault: str | None = None) -> dict:
    """The numbers of the control (``fault`` None) or of one fault."""
    return readings(cell, seed, device, (fault or "fp8",))[fault or "fp8"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="+", default=["fp8"],
                    choices=("fp8", "half_batch", "window"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = core.find_cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, args.device, tuple(args.faults))
        for fault, numbers in got.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": fault, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
