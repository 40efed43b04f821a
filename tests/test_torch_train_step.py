"""One step of the port's ``build_train_step`` against the JAX package's,
for each of the 10 reduced architectures, on the CPU in f32, both
packages started from one state (the reference's ``init_state`` carried
across by ``interop.train_state_from_reference``):

* with ``grad_accum`` 1 and with the architecture's own value (2 for a
  reduced spec; arctic-480b accumulates in bf16 and steps with
  Adafactor, the rest with AdamW), each package's ``make_optimizer`` with
  ``total_steps=10``, so the first step's learning rate is 1.5e-4;
* the metrics: loss and grad norm within 2e-4 relative (the models'
  tolerance), param norm within 1e-5;
* every parameter within 1e-5 of the reference's, relative to its leaf's
  largest |p| (floored at 1e-2: a leaf that starts at zero, A_log, holds
  only updates of the learning rate's size, and 1e-5 of the floor is
  under a hundredth of one), except elements whose reference gradient lies within the
  gradient tolerance (2e-4 of the leaf's largest |g|) of zero: a first
  Adam or Adafactor step moves an element by the learning rate times
  about the sign of its gradient, and the sign of a gradient that small
  is rounding.  Those elements are counted, printed and bounded;
* the optimizer's moments within 5e-4 of their leaf's largest value
  (second moments are squares of gradients held to 2e-4);
* a second step from a non-zero reference state carried across, which
  the carry reproduces bit for bit.

The reference's step is compiled once per architecture and accumulation
for the module (a fixture).  Also the driver
(``python -m repro_torch.launch.train``) on the CPU, and its
checkpointing flags (which raised until A-11c).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.launch.steps import make_optimizer as ref_make_optimizer
from repro.models.layers import unzip_params
from repro.train.train_step import build_train_step as ref_build
from repro.train.train_step import init_state as ref_init_state
from repro_torch.configs.reduced import SMOKE_SHAPE
from repro_torch.interop import train_state_from_reference
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_optimizer
from repro_torch.train.optimizer import leaf_tensors
from repro_torch.train.train_step import build_train_step
from test_torch_train import (
    ARCHS, GRAD_TOL, f32_specs, ref_leaf, seeded_batch,
)

P_RTOL = 1e-5
LEAF_FLOOR = 1e-2
MOMENT_TOL = 5e-4
#: Share of a model's elements that may sit past P_RTOL with a reference
#: gradient within GRAD_TOL of zero (the sign of rounding; measured: at
#: most 1 of 60,216-303,936 elements a model).
SIGN_SHARE = 1e-4
TOTAL_STEPS = 10


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def reference_steps(arch):
    rspec, _ = f32_specs(arch)
    fam, cfg = rspec.family, rspec.config
    values, _ = unzip_params(fam.init(jax.random.key(2), cfg))
    batch = seeded_batch(rspec)
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b: fam.loss_fn(p, b, cfg)))(values, batch)
    opt = ref_make_optimizer(rspec, total_steps=TOTAL_STEPS)
    state0 = ref_init_state(values, opt)
    out = {"batch": batch, "grads": np_tree(grads),
           "state0": np_tree(state0)}
    for accum in (1, 2):
        # repro-lint: disable=JP120 -- one reference step per grad_accum value
        step = jax.jit(ref_build(lambda p, b: fam.loss_fn(p, b, cfg), opt,
                                 grad_accum=accum,
                                 accum_dtype=rspec.accum_dtype))
        state1, m1 = step(state0, batch)
        rec = {"state1": np_tree(state1), "metrics": np_tree(m1)}
        if accum == 1:
            state2, m2 = step(state1, batch)
            rec.update(state2=np_tree(state2), metrics2=np_tree(m2))
        out[accum] = rec
    return out


@pytest.fixture(scope="module")
def reference():
    return {arch: reference_steps(arch) for arch in ARCHS}


def port_step(arch, state, batch, accum):
    _, pspec = f32_specs(arch)
    fam, cfg = pspec.family, pspec.config
    step = build_train_step(lambda m, b: fam.loss_fn(m, b, cfg),
                            make_optimizer(pspec, total_steps=TOTAL_STEPS),
                            grad_accum=accum, accum_dtype=pspec.accum_dtype)
    return step(state, {k: torch.from_numpy(v) for k, v in batch.items()})


def carried(arch, ref_state):
    _, pspec = f32_specs(arch)
    return train_state_from_reference(pspec.family_name, pspec.config,
                                      ref_state, device="cpu")


def port_leaves(model) -> dict:
    return {k: v.detach().numpy() for k, v in leaf_tensors(model).items()}


def check_state(arch, got_state, want_state, grads) -> dict:
    """Parameters and moments of ``got_state`` against the reference's
    ``want_state``; returns the sign-of-rounding counts."""
    got = port_leaves(got_state.params)
    sign = total = 0
    for leaf, p in got.items():
        want = ref_leaf(want_state.params, leaf)
        g = np.abs(ref_leaf(grads, leaf))
        off = np.abs(p - want) > P_RTOL * max(np.abs(want).max(),
                                              LEAF_FLOOR)
        tiny = g <= GRAD_TOL * g.max()
        assert not (off & ~tiny).any(), (
            arch, leaf, float(np.abs(p - want).max()),
            float(np.abs(want).max()))
        sign += int((off & tiny).sum())
        total += p.size
        opt = want_state.opt_state
        for name, v in got_state.opt_state[leaf].items():
            w = (ref_leaf(opt[name], leaf) if set(opt) == {"m", "v"}
                 else ref_leaf(opt, leaf + "." + name))
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(v.numpy() - w).max()) <= MOMENT_TOL * scale, (
                arch, leaf, name)
    return {"sign_of_rounding": sign, "elements": total}


def check_metrics(got, want):
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=GRAD_TOL)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=GRAD_TOL)
    np.testing.assert_allclose(float(got["param_norm"]),
                               float(want["param_norm"]), rtol=P_RTOL)


@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "own_accum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_the_reference(reference, arch, accum):
    ref = reference[arch]
    _, pspec = f32_specs(arch)
    if accum == 2:
        assert pspec.grad_accum_for(SMOKE_SHAPE) == 2
    state = carried(arch, ref["state0"])
    assert int(state.step) == 0
    new, metrics = port_step(arch, state, ref["batch"], accum)
    assert int(new.step) == 1
    check_metrics(metrics, ref[accum]["metrics"])
    counts = check_state(arch, new, ref[accum]["state1"], ref["grads"])
    print(f"{arch} accum {accum}: {counts}")
    assert counts["sign_of_rounding"] <= SIGN_SHARE * counts["elements"]


@pytest.mark.parametrize("arch", ["arctic-480b", "llama3-8b",
                                  "zamba2-1.2b"])
def test_a_non_zero_state_carries_across_and_steps(reference, arch):
    """The reference's state after one step, carried across, is its
    parameters and moments bit for bit; one more step from it on both
    sides agrees as the first did."""
    ref = reference[arch][1]
    state = carried(arch, ref["state1"])
    assert int(state.step) == 1
    for leaf, p in port_leaves(state.params).items():
        assert np.array_equal(p, ref_leaf(ref["state1"].params, leaf))
    opt = ref["state1"].opt_state
    for leaf, own in state.opt_state.items():
        for name, v in own.items():
            w = (ref_leaf(opt[name], leaf) if set(opt) == {"m", "v"}
                 else ref_leaf(opt, leaf + "." + name))
            assert np.array_equal(v.numpy(), w), (leaf, name)
    new, metrics = port_step(arch, state, reference[arch]["batch"], 1)
    check_metrics(metrics, ref["metrics2"])
    counts = check_state(arch, new, ref["state2"], reference[arch]["grads"])
    assert counts["sign_of_rounding"] <= SIGN_SHARE * counts["elements"]


def test_the_driver_trains_on_the_cpu(capsys):
    rc = train_cli.main(["--arch", "mixtral-8x7b", "--reduced", "--steps",
                         "3", "--batch", "2", "--seq", "32", "--device",
                         "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.count("loss") >= 3 and "done: loss" in out
    res = train_cli.train("arctic-480b", reduced=True, steps=2, batch=2,
                          seq=16, device="cpu", log=lambda *a: None)
    assert res["optimizer"] == "adafactor" and len(res["step_s"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert int(res["state"].step) == 2


@pytest.mark.parametrize("flag", [["--checkpoint-dir", "ckpt"],
                                  ["--resume"]])
def test_checkpointing_waits_for_a11c(flag, tmp_path, capsys):
    """The checkpoint flags run since A-11c (``runtime/checkpoint.py``):
    ``--checkpoint-dir`` writes the final step's checkpoint, and
    ``--resume`` without a directory trains from step 0, as the
    reference's driver does (``tests/test_torch_checkpoint.py`` holds
    resume and the format to the reference's)."""
    flag = [str(tmp_path / f) if f == "ckpt" else f for f in flag]
    assert train_cli.main(["--reduced", "--steps", "1", "--device", "cpu",
                           "--batch", "2", "--seq", "16", *flag]) == 0
    assert "done: loss" in capsys.readouterr().out
    if "--checkpoint-dir" in flag:
        assert (tmp_path / "ckpt" / "step_00000001" /
                "manifest.json").exists()
