"""End-to-end training driver on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --reduced --steps 20 --batch 8 --seq 128 --device cpu
    python -m repro_torch.launch.train --arch zamba2-1.2b --steps 10 \\
        --batch 4 --seq 2048

Mirrors ``repro/launch/train.py``'s loop, logging and exit codes: the
replayable data stream (a pure function of ``(seed, step)``), the train
step (``repro_torch.train``) with the architecture's optimizer
(``launch/steps.py::make_optimizer``), no microbatching and the spec's
accumulator dtype, and the straggler monitor with the reference's
deadline prior.  There is no mesh: the model lives on one device, the
card unless ``--device cpu`` is asked for (the kernels' plain versions).
``--reduced`` swaps in the smoke-scale config of ``configs/reduced.py``.
Weights are random, from ``--seed``.

Checkpoints (``runtime/checkpoint.py``, the reference's format):
``--checkpoint-dir D`` saves ``step + 1`` after every step whose index
is a positive multiple of ``--checkpoint-every``, and ``--steps`` at
the end (async; the run waits for the last write), keeping the 3
newest; ``--resume`` restarts from the latest checkpoint in ``D``,
restored in place into the freshly built state on the run's one device
(``launch/mesh.py::make_device_mesh``).  The data
stream is a pure function of ``(seed, step)``, so a resumed run with
the same ``--steps`` is bit-identical to an uninterrupted one.  A
checkpoint already at ``--steps`` leaves nothing to do: the run says so
and exits 0 (the reference's loop then raises ``IndexError``: ROADMAP
C11).
"""
from __future__ import annotations

import argparse
import math
import time
from pathlib import Path

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import Shape
from repro_torch.configs.reduced import reduced as reduce_spec
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import ShardingRules
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.serve import _sync
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.layers import param_axes
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train.data import SyntheticStream
from repro_torch.train.train_step import (
    TrainState, build_train_step, init_state,
)

DEFAULT_ARCH = "llama3-8b"


def train_spec(arch: str, *, reduced: bool = False):
    """The architecture's spec, reduced if asked."""
    spec = get_arch(arch)
    return reduce_spec(spec) if reduced else spec


def train(arch: str = DEFAULT_ARCH, *, reduced: bool = False,
          steps: int = 200, batch: int = 8, seq: int = 128, seed: int = 0,
          device=None, model=None, checkpoint_dir=None,
          checkpoint_every: int = 50, resume: bool = False,
          log_every: int = 10, callback=None, log=print) -> dict:
    """Train steps ``start_step .. steps - 1`` (``start_step`` 0, or the
    latest checkpoint's step with ``resume``); returns the logged losses,
    every step's metrics (floats) and seconds (each step ends in a
    device synchronise), tokens a step, ``start_step`` and the final
    state.  ``model`` replaces the seeded init;
    ``callback(step, state, metrics)`` runs after each step (and its
    checkpoint).  With ``checkpoint_dir``, checkpoints as the module
    says; a pending write is waited for however the loop ends."""
    if steps < 1 or batch < 1 or seq < 1:
        raise ValueError("steps, batch and seq must be >= 1")
    device = resolve_device(device)
    spec = train_spec(arch, reduced=reduced)
    fam, cfg = spec.family, spec.config
    stream = SyntheticStream(
        spec.input_shapes(Shape("cli", seq, batch, "train")), spec.vocab,
        seed=seed)
    optimizer = make_optimizer(spec, total_steps=steps)
    step_fn = build_train_step(lambda m, b: fam.loss_fn(m, b, cfg),
                               optimizer, grad_accum=1,
                               accum_dtype=spec.accum_dtype)
    if model is None:
        model = fam.init(cfg, device=device, seed=seed)
    state = init_state(model, optimizer)
    monitor = StragglerMonitor(num_workers=1, predicted_step_s=10.0,
                               slack=5.0)

    mgr, axes, start_step = None, None, 0
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir)
        paxes = param_axes(model)
        axes = TrainState((), paxes, optimizer.state_axes(paxes))
        if resume:
            rules = ShardingRules(make_device_mesh(device),
                                  spec.rules_for("train"))
            got, restored = mgr.restore_latest(state, rules)
            if got is not None:
                start_step, state = got, restored
                log(f"resumed from step {start_step}")

    losses, history, step_s = [], [], []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            batch_t = {k: (v if v.is_floating_point() else v.long())
                       .to(device) for k, v in stream.batch(step).items()}
            _sync(device)
            ts = time.perf_counter()
            state, metrics = step_fn(state, batch_t)
            _sync(device)
            step_s.append(time.perf_counter() - ts)
            history.append({k: float(v) for k, v in metrics.items()})
            monitor.heartbeat(0, step)
            if step % log_every == 0 or step == steps - 1:
                losses.append(history[-1]["loss"])
                dec = monitor.check()
                log(f"step {step:5d}  loss {losses[-1]:.4f}  "
                    f"gnorm {history[-1]['grad_norm']:.3f}  "
                    f"({(time.time() - t0):.1f}s, deadline "
                    f"{dec.deadline_s:.1f}s, stragglers {dec.stragglers})")
            if mgr and step and step % checkpoint_every == 0:
                mgr.save(step + 1, state, axes)
            if callback is not None:
                callback(step, state, metrics)
        if mgr and start_step < steps:
            mgr.save(steps, state, axes)
    finally:
        if mgr:
            mgr.wait()
    if start_step >= steps:
        log(f"nothing to do: the checkpoint is at step {start_step}, "
            f"--steps is {steps}")
    return {"arch": spec.arch_id, "device": str(device),
            "dtype": str(cfg.backbone.dtype if hasattr(cfg, "backbone")
                         else cfg.dtype),
            "optimizer": optimizer.name, "batch": batch, "seq": seq,
            "tokens_per_step": batch * seq, "start_step": start_step,
            "losses": losses, "history": history, "step_s": step_s,
            "state": state}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default=DEFAULT_ARCH)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (configs/reduced.py)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--checkpoint-dir", type=Path, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    res = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, seed=args.seed,
                device=args.device, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every, resume=args.resume,
                log_every=args.log_every)
    losses = res["losses"]
    if not losses:      # resumed at --steps (ROADMAP C11)
        return 0
    if not math.isfinite(losses[-1]):
        print("FAIL: non-finite final loss")
        return 1
    if len(losses) > 3 and losses[-1] >= losses[0]:
        print("WARN: loss did not decrease "
              f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
