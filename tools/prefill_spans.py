"""Check the port's spans and counters on one prefill cell of the
benchmark (``portbench``), on the card:

1. a traced window, as ``python3 -m portbench.run --trace 1`` runs it
   (``run.run_cell``): its result line, and from the same trace the spans
   a request (the program's and their device-side spans), the layers'
   device time against the busy time a request, and the idle time a
   request split by where the host was: in a layer, in ``model.prefill``
   outside the layers (the rest), or outside ``model.prefill`` (edges);
2. then one request, after a warm one, under
   ``torch.cuda.set_sync_debug_mode("warn")`` with a profiler on so that
   the counters record: every port line that made the host wait for the
   device, how often, and whether inside the family's ``prefill``; and
   the request's ``host_sync.*`` counters beside them.

    python3 tools/prefill_spans.py --workload mixtral-8x7b-16l.prefill-long \\
        --seed 7 --seconds 45 --out chiprun_out/spans_long.json

``--small`` runs the cell at its reduced CPU sizes (no sync debugger:
nothing on the CPU waits for a device).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from portbench import core, run, spans, traffic  # noqa: E402
from portbench.loops import prefill as prefill_loop  # noqa: E402

PORT = ROOT / "src" / "repro_torch"
API = PORT / "models" / "api.py"
LAYERS = ("layer.attention", "layer.moe", "layer.mamba2")
SYNC_WARNING = "called a synchronizing CUDA operation"


def sync_request(cell, seed: int, device, spec=None) -> dict:
    """Port lines that synchronised in one request, by site, and the
    ``host_sync.*`` counters the request recorded."""
    core.import_program()
    from repro_torch.launch import serve
    from repro_torch.runtime import tracing

    spec, pcfg = core.program_config(cell.config, spec)
    fam, sizes, mix = spec.family, cell.config["sizes"], cell.mix
    model = core.build_model(fam, pcfg, cell.module("reference").schema(
        sizes), seed, device)
    tokens = traffic.prompt(mix, seed, 0, sizes["vocab"])

    def request():
        caches = serve.new_caches(spec, pcfg, tokens.shape[0],
                                  tokens.shape[1] + mix["gen"], {},
                                  device=device)
        logits, caches = fam.prefill(
            model, serve.prefill_batch(pcfg, tokens, {}, device), pcfg,
            caches)
        tok = logits.argmax(dim=-1, keepdim=True)
        core.sync(device)
        return tok

    request()                                   # builds, loads, warms
    sites: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if Path(f.filename).is_relative_to(PORT)]
        site = (f"{Path(frames[-1].filename).relative_to(ROOT)}:"
                f"{frames[-1].lineno}" if frames else
                f"{Path(stack[-1].filename).name}:{stack[-1].lineno}")
        where = ("model.prefill" if any(Path(f.filename) == API
                                         for f in frames) else "edge")
        key = f"{site} ({where})"
        sites[key] = sites.get(key, 0) + 1

    tracing.take()
    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CPU]):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode(0)
    _, counts = tracing.take()
    counters: dict = {}
    for name, _, value, _ in counts:
        if name.startswith("host_sync."):
            counters[name] = counters.get(name, 0) + value
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return {"rows": int(tokens.shape[0]), "length": int(tokens.shape[1]),
            "sites": dict(sorted(sites.items())), "counters": counters,
            "counted": sum(counters.values()), "synced": sum(sites.values()),
            "in_prefill": sum(n for k, n in sites.items()
                              if k.endswith("(model.prefill)"))}


def traced_window(cell, seed: int, seconds: float, device,
                  spec=None) -> dict:
    """The traced run's result line and, from its trace, the spans a
    request and the split of its busy and idle time."""
    kept: dict = {}
    loop_run = prefill_loop.run

    def run_and_keep(*args, **kwargs):
        res = loop_run(*args, **kwargs)
        kept.update(res)
        return res

    prefill_loop.run = run_and_keep
    info: dict = {}
    try:
        line = run.run_cell(cell, seed, seconds, True, device, spec=spec,
                            info=info)
    finally:
        prefill_loop.run = loop_run
    tr, work = kept["trace"], kept["work"]
    n = len(work)
    ctx = run.Context(cell, tr, work, kept["window_peak_bytes"], None)
    w0, w1 = tr.window
    rec = spans.records() or {"spans": []}
    program = {}
    for name, s, e, _, _ in rec["spans"]:
        if w0 <= s and e <= w1:
            program[name] = program.get(name, 0) + 1
    names = ("model.prefill",) + LAYERS
    m = {k: v["value"] for k, v in line["metrics"].items()}
    busy = tr.busy_s * 1e3 / n
    idle = (tr.window_s - tr.busy_s) * 1e3 / n
    layer_busy = {k: m[k] for k in ("attention_ms.prefill", "moe_ms.prefill",
                                    "mamba2_ms.prefill") if k in m}
    layer_idle = {k: m[k] for k in ("attention_idle_ms.prefill",
                                    "moe_idle_ms.prefill",
                                    "mamba2_idle_ms.prefill") if k in m}
    in_prefill = spans.idle_ms(ctx, spans.PREFILL)
    edge = m.get("edge_idle_ms.prefill")
    return {
        "line": line, "seconds": info["seconds"], "requests": n,
        "program_spans_a_request": {k: program.get(k, 0) / n for k in names},
        "device_spans_a_request": {k: len(tr.spans.get(k, [])) / n
                                   for k in names},
        "busy_ms_a_request": busy, "layer_busy_ms": layer_busy,
        "layer_busy_sum_ms": sum(layer_busy.values()),
        "idle_ms_a_request": idle, "layer_idle_ms": layer_idle,
        "layer_idle_sum_ms": sum(layer_idle.values()),
        "idle_in_prefill_ms": in_prefill, "edge_idle_ms": edge,
        "rest_in_prefill_ms": (None if in_prefill is None else
                               in_prefill - sum(layer_idle.values())),
        "unaccounted_idle_ms": (None if in_prefill is None or edge is None
                                else idle - in_prefill - edge),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if args.small:
        from portbench.small import small_cell

        cell, spec = small_cell(args.workload)
        device = "cpu"
    else:
        cell, spec = core.find_cell(args.workload), None
        device = "cuda"
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 3
    out = {"workload": cell.name, "seed": args.seed,
           "device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu"),
           "torch": torch.__version__}
    out.update(traced_window(cell, args.seed, args.seconds, device, spec))
    out["syncs"] = sync_request(cell, args.seed, device, spec)
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    summary = {k: v for k, v in out.items() if k not in ("line",)}
    summary["metrics"] = out["line"]["metrics"]
    summary["correct"] = out["line"]["correct"]
    print(json.dumps(summary, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
