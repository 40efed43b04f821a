"""Checkpoint/restart and elastic re-meshing of the port against the JAX
package's, on the CPU.

* The cases of ``tests/runtime/test_checkpoint.py``, on the port:
  round trip, rolling ``keep``, async save then ``wait``, elastic
  restore onto the host mesh, ``plan_remesh`` and its fallbacks, a shape
  mismatch, concurrent same-step savers, and a publish failure that
  keeps the good checkpoint.
* The port's train step updates parameters in place: a state mutated
  right after ``save`` returns is saved as it was before.
* The on-disk format is the reference's: for reduced llama3-8b (AdamW),
  arctic-480b (Adafactor) and zamba2-1.2b, a state carried across by
  ``interop.train_state_from_reference`` gives the reference's
  ``manifest.json`` and bit-equal ``.npy`` files; each package restores
  the other's checkpoint, and the losses of the restored models agree
  within 2e-4 (f32); ``plan_remesh`` equals the reference's on the
  ``pod``, ``multipod`` and host meshes.
* Resume: 10 steps straight and 6 steps, a crash, then ``--resume`` to
  10 give bit-identical parameters and optimizer state; ROADMAP C11 —
  the reference's ``--resume`` at the last step raises ``IndexError``,
  the port's says there is nothing to do and returns 0.
"""
from __future__ import annotations

import errno
import filecmp
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch import train as ref_train_cli
from repro.launch.steps import make_optimizer as ref_make_optimizer
from repro.models.layers import unzip_params
from repro.runtime import checkpoint as ref_ckpt
from repro.runtime import elastic as ref_elastic
from repro.train.train_step import TrainState as RefTrainState
from repro.train.train_step import init_state as ref_init_state
from repro_torch.configs.reduced import reduced_arch
from repro_torch.dist.sharding import ShardingRules
from repro_torch.interop import train_state_from_reference
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (
    make_device_mesh, make_host_mesh, make_production_mesh,
)
from repro_torch.launch.steps import make_optimizer
from repro_torch.models.layers import param_axes
from repro_torch.runtime.checkpoint import (
    CheckpointManager, _publish, restore_checkpoint, save_checkpoint,
)
from repro_torch.runtime.elastic import fits, plan_remesh
from repro_torch.train.train_step import TrainState
from test_torch_train import f32_specs, seeded_batch

LOSS_TOL = 2e-4


def _state():
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {
            "w": torch.arange(32, dtype=torch.float32).reshape(4, 8),
            "b": torch.ones(8, dtype=torch.bfloat16),
        },
    }


def _axes():
    return {"step": (), "params": {"w": ("embed", "mlp"), "b": ("mlp",)}}


def _abstract(state):
    return {k: (torch.empty(v.shape, dtype=v.dtype, device="meta")
                if isinstance(v, torch.Tensor) else _abstract(v))
            for k, v in state.items()}


def _equal(a, b):
    assert a.dtype == b.dtype and torch.equal(a, b)


# --- the reference's cases -------------------------------------------------------


def test_save_restore_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 7, state, _axes())
    restored = restore_checkpoint(tmp_path / "step_00000007",
                                  _abstract(state))
    _equal(restored["step"], state["step"])
    for k in ("w", "b"):
        _equal(restored["params"][k], state["params"][k])
        assert restored["params"][k].device.type == "cpu"


def test_manager_rolling_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    state = _state()
    for step in (1, 2, 3):
        mgr.save(step, state, _axes())
    assert mgr.steps() == [2, 3]
    step, restored = mgr.restore_latest(_abstract(state))
    assert step == 3
    assert int(restored["step"]) == 7


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
    mgr.save(5, _state(), _axes())
    mgr.wait()
    assert mgr.latest_step() == 5


def test_elastic_restore_onto_mesh(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 1, state, _axes())
    rules = ShardingRules(make_host_mesh("cpu"))
    restored = restore_checkpoint(tmp_path / "step_00000001",
                                  _abstract(state), rules)
    _equal(restored["params"]["w"], state["params"]["w"])
    assert restored["params"]["w"].device == rules.mesh.devices[0]


def test_restore_refuses_a_split_leaf(tmp_path):
    """A leaf that the rules split over more than one device needs one
    process per device; an abstract mesh has no device at all."""
    state = _state()
    save_checkpoint(tmp_path, 1, state, _axes())
    two = ShardingRules(make_host_mesh("cpu").__class__(
        ("data", "model"), (1, 2), (torch.device("cpu"),) * 2))
    with pytest.raises(ValueError, match="split"):
        restore_checkpoint(tmp_path / "step_00000001", _abstract(state), two)
    with pytest.raises(ValueError, match="abstract mesh"):
        restore_checkpoint(tmp_path / "step_00000001", _abstract(state),
                           ShardingRules(make_production_mesh()))


def test_plan_remesh_reports_fallbacks(tmp_path):
    state = {"w": torch.zeros(6, 8)}
    save_checkpoint(tmp_path, 1, state, {"w": ("vocab", "mlp")})
    mesh = make_host_mesh("cpu")  # 1 device -> everything replicates
    plan = plan_remesh(tmp_path / "step_00000001", mesh)
    assert plan.bytes_per_device == 6 * 8 * 4
    assert fits(plan, hbm_bytes=16 * 2**30)
    assert "GiB/device" in plan.summary()
    pod = plan_remesh(tmp_path / "step_00000001", make_production_mesh())
    assert pod.fallbacks == [("w", "vocab", 0), ("w", "mlp", 1)]
    assert pod.shardings["w"] == ()


def test_shape_mismatch_rejected(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, 1, state, _axes())
    bad = _abstract(state)
    bad["params"]["w"] = torch.empty(5, 8, device="meta")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(tmp_path / "step_00000001", bad)


def test_concurrent_same_step_savers_never_interleave(tmp_path):
    state = _state()
    errors: list[BaseException] = []

    def save():
        try:
            save_checkpoint(tmp_path, 3, state)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=save) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    restored = restore_checkpoint(tmp_path / "step_00000003",
                                  _abstract(state))
    _equal(restored["params"]["w"], state["params"]["w"])


def test_publish_failure_does_not_destroy_existing_checkpoint(tmp_path):
    final = tmp_path / "step_00000001"
    save_checkpoint(tmp_path, 1, _state())
    assert (final / "manifest.json").exists()

    class BadTmp:
        def rename(self, target):
            raise OSError(errno.EACCES, "permission denied")

    with pytest.raises(OSError) as ei:
        _publish(BadTmp(), final)
    assert ei.value.errno == errno.EACCES
    assert (final / "manifest.json").exists(), "good checkpoint destroyed"


# --- in-place updates after save ---------------------------------------------------


@pytest.mark.parametrize("async_write", [True, False])
def test_state_mutated_after_save_is_saved_as_it_was(tmp_path, async_write):
    """The port's train step writes parameters in place: ``save`` must
    have copied the whole state before it returns."""
    spec = reduced_arch("llama3-8b")
    model = spec.family.init(spec.config, device="cpu", seed=0)
    opt = make_optimizer(spec, 10)
    from repro_torch.train.optimizer import leaf_tensors
    from repro_torch.train.train_step import init_state

    def tree(state):
        with torch.no_grad():
            return TrainState(state.step, leaf_tensors(state.params),
                              state.opt_state)

    state = init_state(model, opt)
    before = TrainState(state.step.clone(), {
        leaf: t.clone() for leaf, t in tree(state).params.items()}, {
        leaf: {k: t.clone() for k, t in s.items()}
        for leaf, s in state.opt_state.items()})
    mgr = CheckpointManager(tmp_path, async_write=async_write)
    mgr.save(1, state)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
        for leaf in state.opt_state.values():
            for t in leaf.values():
                t.add_(1.0)
    mgr.wait()
    fresh = init_state(spec.family.init(spec.config, device="cpu", seed=5),
                       opt)
    restored = restore_checkpoint(tmp_path / "step_00000001", fresh)
    after = tree(restored)
    for leaf, t in before.params.items():
        _equal(after.params[leaf], t)
    for leaf, s in before.opt_state.items():
        for k, t in s.items():
            _equal(after.opt_state[leaf][k], t)


def _llama_state(seed):
    from repro_torch.train.train_step import init_state

    spec = reduced_arch("llama3-8b")
    model = spec.family.init(spec.config, device="cpu", seed=seed)
    return init_state(model, make_optimizer(spec, 10))


def test_restore_into_a_train_state_is_in_place(tmp_path):
    """Resume needs no second copy of the state: the fresh state's own
    parameters, moments and step receive the checkpoint's values."""
    saved = _llama_state(0)
    with torch.no_grad():
        for leaf in saved.opt_state.values():
            for t in leaf.values():
                t.normal_()
        saved.step.fill_(4)
    save_checkpoint(tmp_path, 4, saved)
    fresh = _llama_state(5)
    ptrs = [t.data_ptr() for t in fresh.params.parameters()]
    restored = restore_checkpoint(
        tmp_path / "step_00000004", fresh,
        ShardingRules(make_device_mesh("cpu")))
    assert restored.params is fresh.params and restored.step is fresh.step
    assert [t.data_ptr() for t in restored.params.parameters()] == ptrs
    assert int(fresh.step) == 4
    for leaf, s in fresh.opt_state.items():
        for k, t in s.items():
            assert restored.opt_state[leaf][k] is t
            _equal(t, saved.opt_state[leaf][k])
    for p, q in zip(fresh.params.parameters(), saved.params.parameters()):
        _equal(p.detach(), q.detach())


def test_restore_in_place_refuses_another_device(tmp_path):
    """A mesh whose device is not the state's: the leaves would land
    where the model is not (a resume on ``cuda:1`` onto ``cuda:0``)."""
    save_checkpoint(tmp_path, 1, _llama_state(0))
    elsewhere = ShardingRules(make_production_mesh().__class__(
        ("data",), (1,), (torch.device("meta"),)))
    with pytest.raises(ValueError, match="the mesh places it on meta"):
        restore_checkpoint(tmp_path / "step_00000001", _llama_state(1),
                           elsewhere)


# --- the reference's format, both ways -------------------------------------------

FORMAT_ARCHS = ("llama3-8b", "arctic-480b", "zamba2-1.2b")


def reference_state(rspec, seed=1):
    """The reference's TrainState at step 3 with seeded moments (numpy
    leaves), its axes tree and its optimizer."""
    values, axes = unzip_params(rspec.family.init(jax.random.key(seed),
                                                  rspec.config))
    opt = ref_make_optimizer(rspec, 10)
    state = ref_init_state(values, opt)
    rng = np.random.default_rng(seed)
    state = RefTrainState(
        jnp.asarray(3, jnp.int32), state.params,
        jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape).astype(np.float32) ** 2),
            state.opt_state))
    return state, RefTrainState((), axes, opt.state_axes(axes))


def port_axes(model, spec):
    paxes = param_axes(model)
    return TrainState((), paxes, make_optimizer(spec, 10).state_axes(paxes))


@pytest.mark.parametrize("arch", FORMAT_ARCHS)
def test_checkpoint_files_equal_the_references(arch, tmp_path):
    from repro.configs.reduced import reduced_arch as ref_reduced_arch

    rspec, pspec = ref_reduced_arch(arch), reduced_arch(arch)
    rstate, raxes = reference_state(rspec)
    ref_ckpt.save_checkpoint(tmp_path / "ref", 3, rstate, raxes)
    pstate = train_state_from_reference(
        pspec.family_name, pspec.config, jax.tree.map(np.asarray, rstate),
        device="cpu")
    save_checkpoint(tmp_path / "port", 3, pstate,
                    port_axes(pstate.params, pspec))
    a, b = tmp_path / "ref" / "step_00000003", tmp_path / "port" / \
        "step_00000003"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    manifest = json.loads((a / "manifest.json").read_text())
    assert {e["dtype"] for e in manifest["leaves"]} >= {"bfloat16",
                                                        "float32"}
    assert ".step.npy" in names and ".params_embed_table.npy" in names
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


@pytest.mark.parametrize("arch", FORMAT_ARCHS)
def test_each_package_restores_the_others_checkpoint(arch, tmp_path):
    """f32 configs: the port restores the reference's checkpoint into a
    fresh model, the reference the port's, and the restored states'
    losses on one batch agree within 2e-4; every leaf equal."""
    rspec, pspec = f32_specs(arch)
    rstate, raxes = reference_state(rspec, seed=4)
    ref_ckpt.save_checkpoint(tmp_path / "ref", 3, rstate, raxes)
    carried = train_state_from_reference(
        pspec.family_name, pspec.config, jax.tree.map(np.asarray, rstate),
        device="cpu")
    fresh = TrainState(
        torch.zeros((), dtype=torch.int32),
        pspec.family.init(pspec.config, device="cpu", seed=9),
        {k: {n: torch.zeros_like(t) for n, t in s.items()}
         for k, s in carried.opt_state.items()})
    port = restore_checkpoint(tmp_path / "ref" / "step_00000003", fresh)
    assert int(port.step) == 3
    for (n, p), q in zip(port.params.named_parameters(),
                         carried.params.parameters()):
        _equal(p.detach(), q.detach())
    for leaf, s in carried.opt_state.items():
        for k, t in s.items():
            _equal(port.opt_state[leaf][k], t)

    save_checkpoint(tmp_path / "port", 3, carried,
                    port_axes(carried.params, pspec))
    abstract = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                            rstate)
    back = ref_ckpt.restore_checkpoint(tmp_path / "port" / "step_00000003",
                                       abstract)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(rstate)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    batch = seeded_batch(rspec)
    ref_loss = float(jax.jit(lambda p, b: rspec.family.loss_fn(
        p, b, rspec.config))(back.params, batch))
    with torch.no_grad():
        port_loss = float(pspec.family.loss_fn(
            port.params, {k: torch.from_numpy(v) for k, v in batch.items()},
            pspec.config))
    assert abs(port_loss - ref_loss) <= LOSS_TOL * abs(ref_loss)


@pytest.mark.parametrize("mesh_name", ("pod", "multipod", "host"))
def test_plan_remesh_equals_the_references(mesh_name, tmp_path):
    from repro.configs.reduced import reduced_arch as ref_reduced_arch

    rstate, raxes = reference_state(ref_reduced_arch("arctic-480b"))
    ref_ckpt.save_checkpoint(tmp_path, 3, rstate, raxes)
    if mesh_name == "host":
        rmesh, pmesh = AbstractMesh((1,), ("data",)), make_host_mesh("cpu")
    else:
        multi = mesh_name == "multipod"
        rmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model")) if multi
                 else AbstractMesh((16, 16), ("data", "model")))
        pmesh = make_production_mesh(multi_pod=multi)
    overrides = {"embed": "data"}
    want = ref_elastic.plan_remesh(tmp_path / "step_00000003", rmesh,
                                   overrides)
    got = plan_remesh(tmp_path / "step_00000003", pmesh, overrides)
    assert got.shardings == {k: tuple(v) for k, v in want.shardings.items()}
    assert got.fallbacks == want.fallbacks
    assert got.bytes_per_device == want.bytes_per_device
    assert got.new_mesh_axes == dict(want.new_mesh_axes)
    assert got.summary() == want.summary()
    if mesh_name != "host":
        assert got.fallbacks


# --- resume -----------------------------------------------------------------------

RESUME = dict(arch="llama3-8b", reduced=True, steps=10, batch=4, seq=32,
              seed=0, device="cpu", checkpoint_every=5, log=lambda *a: None)


class Crash(Exception):
    pass


def test_resume_is_bit_identical(tmp_path):
    straight = train_cli.train(checkpoint_dir=tmp_path / "straight",
                               **RESUME)
    assert straight["start_step"] == 0

    def crash(step, state, metrics):
        if step == 5:
            raise Crash

    with pytest.raises(Crash):
        train_cli.train(checkpoint_dir=tmp_path / "resumed", callback=crash,
                        **RESUME)
    assert CheckpointManager(tmp_path / "resumed").latest_step() == 6
    resumed = train_cli.train(checkpoint_dir=tmp_path / "resumed",
                              resume=True, **RESUME)
    assert resumed["start_step"] == 6 and len(resumed["step_s"]) == 4
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"][6:]]
    a, b = tmp_path / "straight" / "step_00000010", \
        tmp_path / "resumed" / "step_00000010"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


ARGS = ["--arch", "llama3-8b", "--reduced", "--steps", "2", "--batch", "2",
        "--seq", "16", "--log-every", "1"]


def test_c11_resume_at_the_last_step(tmp_path, capsys):
    """Both packages' drivers, a checkpoint already at ``--steps``: the
    reference's loop does not run and ``losses[-1]`` raises; the port
    says so and returns 0 (and writes nothing more)."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    assert ref_train_cli.main(ARGS + ["--checkpoint-dir", str(ref_dir)]) == 0
    with pytest.raises(IndexError):
        ref_train_cli.main(ARGS + ["--checkpoint-dir", str(ref_dir),
                                   "--resume"])
    port = ARGS + ["--device", "cpu", "--checkpoint-dir", str(port_dir)]
    assert train_cli.main(port) == 0
    steps = CheckpointManager(port_dir).steps()
    capsys.readouterr()
    assert train_cli.main(port + ["--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "nothing to do" in out
    assert CheckpointManager(port_dir).steps() == steps
