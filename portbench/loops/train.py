"""Closed loop of training steps, driven as ``launch/train.py::train``
drives them: the architecture's optimizer (``make_optimizer`` over the
mix's schedule length), ``build_train_step`` with no microbatching,
``init_state``, and per step the batch moved to the device, the step,
a synchronise and the host's read of the step's metrics.

Set-up builds the one training state and drives it through the mix's
``checked_steps`` first steps with the window's own call and feed; they
warm every shape up.  Their losses, the first gradient as the optimizer
holds it (AdamW's first moment after one step, over ``1 - b1``) and
each leaf's change over them are kept; the window then goes on from
that same state.  After the window, the reference follows those first
steps from the same seeded weights and batches
(``compare.train_numbers``).
"""
from __future__ import annotations

import gc
import time

import torch

from portbench import compare, core, traffic, weights
from portbench.reference.common import Precision, leaf, strict_f32
from portbench.trace import traced


def _first_gradient(opt_state: dict, b1: float) -> dict:
    """``{leaf: norm}`` of the gradient the optimizer got at its first
    step: its first moment over ``1 - b1``."""
    return {k: float(s["m"].double().norm()) / (1 - b1)
            for k, s in opt_state.items()}


def _change(model, schema: dict, seed: int, device) -> dict:
    """``{leaf: norm}`` of each leaf's change from the seeded weights,
    drawn again one parameter at a time."""
    sq: dict = {}
    with torch.no_grad():
        for n, p in model.named_parameters():
            d = p.double() - weights.make(schema, n, seed, device).double()
            sq[leaf(n)] = sq.get(leaf(n), 0.0) + float(d.pow(2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        *, spec=None, fault: str | None = None) -> dict:
    core.import_program()
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train.train_step import build_train_step, init_state

    spec, pcfg = core.program_config(cell.config, spec)
    fam, sizes, mix = spec.family, cell.config["sizes"], cell.mix
    opt = {**cell.config["optimizer"], **mix["schedule"]}
    ref = cell.module("reference")
    schema = ref.schema(sizes)
    vocab, rows, seq = sizes["vocab"], mix["batch"], mix["seq"]

    optimizer = make_optimizer(spec, total_steps=opt["total_steps"])
    step_fn = build_train_step(lambda m, b: fam.loss_fn(m, b, pcfg),
                               optimizer, grad_accum=1,
                               accum_dtype=spec.accum_dtype)
    model = core.build_model(fam, pcfg, schema, seed, device)
    state = init_state(model, optimizer)
    if fault == "unchanged":
        def step_fn(st, b):
            zero = torch.zeros((), device=device)
            return st, {"loss": fam.loss_fn(st.params, b, pcfg).detach(),
                        "grad_norm": zero, "param_norm": zero}
    elif fault == "half_batch":
        whole = step_fn

        def step_fn(st, b):
            return whole(st, {k: v[: len(v) // 2] for k, v in b.items()})

    def one(step: int) -> dict:
        nonlocal state
        tokens, labels = traffic.train_batch(mix, seed, step, vocab)
        batch = {"tokens": torch.from_numpy(tokens).long().to(device),
                 "labels": torch.from_numpy(labels).long().to(device)}
        core.sync(device)
        state, metrics = step_fn(state, batch)
        core.sync(device)
        return {k: float(v) for k, v in metrics.items()}

    checked = mix["checked_steps"]
    prog = {"losses": []}
    for step in range(checked):
        m = one(step)
        prog["losses"].append(m["loss"])
        if step == 0:
            prog["grad_norm"] = m["grad_norm"]
            prog["grad_leaves"] = _first_gradient(state.opt_state, opt["b1"])
    prog["change_leaves"] = _change(model, schema, seed, device)
    core.sync(device)
    setup_s = core.process_age()

    cuda = torch.device(device).type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    steps = 0
    with traced(trace) as tr:
        t0 = time.perf_counter()
        while True:
            one(checked + steps)
            steps += 1
            te = time.perf_counter()
            if te - t0 >= seconds:
                break
        t_read = time.perf_counter()
    window_s = te - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = {
        "end_to_end": {"train_tokens_per_s": steps * rows * seq / window_s,
                       "setup_s": setup_s},
        "attempted": steps, "failed": 0, "trace": tr[0],
        "work": [(rows, seq)] * steps,
        "window_peak_bytes": peak,
        "memory_peak_bytes": max(setup_peak, peak),
    }
    del model, state, step_fn, optimizer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    strict_f32()
    t1 = time.perf_counter()
    batches = [traffic.train_batch(mix, seed, s, vocab)
               for s in range(checked)]
    want = ref.train(sizes, opt, seed, batches, device, Precision("f32"))
    out["numbers"] = compare.train_numbers(prog, want)
    out["seconds"] = {"setup": setup_s, "window": window_s,
                      "trace_read": t1 - t_read, "reference":
                      time.perf_counter() - t1}
    return out
