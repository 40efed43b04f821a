"""Checkpoint/restart with elastic re-sharding (port of
``repro/runtime/checkpoint.py``), on the reference's on-disk format.

Layout: one ``.npy`` per leaf + ``manifest.json`` holding the step and
each leaf's name, dtype, shape and *logical* sharding axes.  Leaves are
named and ordered as the reference's ``jax.tree_util`` flattening names
them (``.step``, ``.params_blocks_attn_wq``, ``.opt_state_m_embed_table``,
Adafactor's ``.opt_state_unembed_w_vr``): a port :class:`TrainState`
is written as the reference's ``TrainState(step, params, opt_state)``
tree, its model's parameters as the reference's stacked leaves
(``train/optimizer.py::param_leaves``) and AdamW's state as ``{"m":
tree, "v": tree}``.  bfloat16 is stored as float32 (exact), the dtype
kept in the manifest.  Either package restores the other's checkpoints.
Restore maps logical axes onto any mesh — the mesh is a property of the
run, not of the checkpoint.

Writes are atomic (a unique staging directory, then a rename) and
optionally async (a background thread); ``keep`` bounds disk usage.  The
port's train step updates the parameters in place, so
:meth:`CheckpointManager.save` copies the whole state to the host
before it returns (synchronous device-to-host copies); the writer thread
only ever sees that copy, never the live state.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import re
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.dist.sharding import ShardingRules, pspec_for, spec_devices
from repro_torch.dist.tree import (
    is_axes, keystr, leaves_with_path, nest, tree_map,
)
from repro_torch.train.optimizer import param_leaves, stack_leaf
from repro_torch.train.train_step import TrainState


def _sanitize(keystr_: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", keystr_).strip("_") or "leaf"


def _is_adamw(opt) -> bool:
    """The port's optimizer state (or its axes) is AdamW's: ``{leaf:
    {"m", "v"}}``."""
    return isinstance(opt, dict) and bool(opt) and all(
        isinstance(s, dict) and set(s) == {"m", "v"} for s in opt.values())


def _nest_opt(opt: dict) -> dict:
    """The port's ``{leaf: {name: x}}`` optimizer state (or axes) as the
    reference's tree: AdamW's ``{"m": tree, "v": tree}``, else (Adafactor)
    the parameter tree with each leaf's ``{name: x}`` at its place."""
    if _is_adamw(opt):
        return {k: nest({leaf: s[k] for leaf, s in opt.items()})
                for k in ("m", "v")}
    return nest(opt)


def _is_port_state(state) -> bool:
    return isinstance(state, TrainState) and isinstance(
        state.params, (nn.Module, dict))


def _as_tree(state, leaf_fn=None):
    """``state`` as the reference's tree, each leaf through ``leaf_fn``
    if given: a :class:`TrainState` whose ``params`` is a model (or a
    ``{leaf: x}`` dict, e.g. its axes) becomes ``TrainState(step, nested
    params, nested opt_state)``, the model's leaves stacked one at a time
    (a host snapshot holds one stacked leaf on the device at a time);
    any other tree as it is."""
    fn = leaf_fn or (lambda x: x)
    if not _is_port_state(state):
        return state if leaf_fn is None else tree_map(fn, state,
                                                      is_leaf=is_axes)
    params = state.params
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        with torch.no_grad():
            params = {leaf: fn(stack_leaf([named[n] for n in info.names],
                                          info.lead))
                      for leaf, info in param_leaves(params).items()}
    else:
        params = tree_map(fn, params, is_leaf=is_axes)
    step = state.step if is_axes(state.step) else fn(state.step)
    return TrainState(step, nest(params),
                      _nest_opt(tree_map(fn, state.opt_state,
                                         is_leaf=is_axes)))


def _flatten_with_names(tree) -> tuple[list, list]:
    """``(names, leaves)`` in the reference's order and names (a repeated
    name gets ``__1``, ``__2``, ...)."""
    names, leaves = [], []
    seen: dict[str, int] = {}
    for path, leaf in leaves_with_path(tree, is_leaf=is_axes):
        name = _sanitize(keystr(path))
        if name in seen:
            seen[name] += 1
            name = f"{name}__{seen[name]}"
        else:
            seen[name] = 0
        names.append(name)
        leaves.append(leaf)
    return names, leaves


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _host_array(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference writes: bfloat16 (no
    numpy dtype) widened to float32, which is exact."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _snapshot(leaf):
    """A host copy of a leaf that no later in-place update can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save_checkpoint(directory: str | Path, step: int, state: Any,
                    axes_tree: Any = None) -> Path:
    """Write ``state`` under ``directory/step_<n>`` atomically.

    The staging directory name is unique per writer (a fixed name would
    let two concurrent savers of the same step interleave partial
    files); whichever writer renames into place first wins, the loser
    discards its staging copy."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = Path(tempfile.mkdtemp(
        dir=directory, prefix=f".tmp_step_{step:08d}."
    ))

    tree = _as_tree(state)
    names, leaves = _flatten_with_names(tree)
    if axes_tree is not None:
        # up to the state's structure: axes leaves are tuples of names
        axes_leaves = [a for _, _, a in leaves_with_path(
            tree, _as_tree(axes_tree), is_leaf=is_axes)]
    else:
        axes_leaves = [None] * len(leaves)

    manifest = {"step": int(step), "leaves": []}
    for name, leaf, axes in zip(names, leaves, axes_leaves):
        dtype_str = _dtype_name(leaf)
        arr = _host_array(leaf)
        np.save(tmp / f"{name}.npy", arr, allow_pickle=False)
        manifest["leaves"].append({
            "name": name,
            "dtype": dtype_str,
            "shape": list(arr.shape),
            "axes": list(axes) if axes is not None else None,
        })
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if not _publish(tmp, final):
        # contended away by concurrent same-step writers; whichever
        # won left a complete checkpoint in place — ours is redundant
        shutil.rmtree(tmp, ignore_errors=True)
    return final


def _publish(tmp: Path, final: Path, attempts: int = 8) -> bool:
    """Swap a fully-staged checkpoint into place.

    ``rename`` only succeeds onto a non-existent target; an occupied
    target (EEXIST/ENOTEMPTY — the previous checkpoint of this step,
    or a concurrent writer's) is cleared and the rename retried.  Any
    other rename error propagates untouched — it must never trigger
    the clear, or a persistent failure (EACCES, EXDEV, …) would
    destroy the existing good checkpoint and then publish nothing.
    Every rename moves a *complete* staging dir, so the final
    directory is always some writer's whole checkpoint, never a
    mixture."""
    for _ in range(attempts):
        try:
            tmp.rename(final)
            return True
        except OSError as exc:
            if exc.errno not in (errno.EEXIST, errno.ENOTEMPTY):
                raise
            shutil.rmtree(final, ignore_errors=True)
    # attempts exhausted under contention: acceptable only if some
    # concurrent writer left a complete checkpoint behind
    if (final / "manifest.json").exists():
        return False
    raise OSError(
        f"could not publish checkpoint to {final}: rename contended "
        f"{attempts} times and no complete checkpoint is in place"
    )


def load_manifest(ckpt_dir: str | Path) -> dict:
    return json.loads((Path(ckpt_dir) / "manifest.json").read_text())


@dataclasses.dataclass(frozen=True, eq=False)
class _Like:
    """What a restored leaf must be: its shape, dtype and device (None:
    a Python number).  ``into``: the tensors it is copied into in place
    (a model leaf's per-layer ``Parameter``s, an optimizer tensor or the
    step of a port :class:`TrainState`), else empty: a new tensor."""

    shape: tuple
    dtype: torch.dtype | None
    device: torch.device | None
    into: tuple = ()


def _like(x, into: bool = False) -> _Like:
    if isinstance(x, torch.Tensor):
        keep = into and x.device.type != "meta"
        return _Like(tuple(x.shape), x.dtype, x.device, (x,) if keep else ())
    return _Like((), None, None)


def _template(state):
    """The reference-form tree of ``state`` with a :class:`_Like` per
    leaf.  A port :class:`TrainState` of a model is restored in place:
    each parameter leaf into the model's per-layer ``Parameter``s
    (without stacking them), the step and each optimizer tensor into the
    state's own (one on meta is made anew)."""
    if not (isinstance(state, TrainState)
            and isinstance(state.params, nn.Module)):
        return _as_tree(state, _like)
    named = dict(state.params.named_parameters())
    params = {}
    for leaf, info in param_leaves(state.params).items():
        ps = tuple(named[n] for n in info.names)
        if ps[0].device.type == "meta":
            raise ValueError("restore into a model on the meta device: "
                             "it holds no values")
        params[leaf] = _Like(info.lead + tuple(ps[0].shape), ps[0].dtype,
                             ps[0].device, ps)
    return _as_tree(TrainState(state.step, params, state.opt_state),
                    lambda x: x if isinstance(x, _Like) else _like(x, True))


def _place(rules: ShardingRules | None, shape: tuple, axes,
           like: _Like) -> torch.device:
    """The device of a restored leaf: the mesh's one device (a spec that
    splits the leaf over more devices raises), else the template leaf's
    own (the CPU for a meta or host-number template)."""
    if rules is not None:
        if rules.mesh.devices is None:
            raise ValueError("restore onto an abstract mesh: it has no "
                             "devices (use plan_remesh for a plan)")
        spec = pspec_for(shape, tuple(axes or ()), rules)
        if spec_devices(spec, rules.mesh) > 1:
            raise ValueError(
                f"leaf of shape {shape} would be split as {spec} over "
                f"{spec_devices(spec, rules.mesh)} devices: restoring a "
                "sharded leaf needs one process per device")
        return rules.mesh.devices[0]
    if like.device is None or like.device.type == "meta":
        return torch.device("cpu")
    return like.device


def restore_checkpoint(ckpt_dir: str | Path, abstract_state: Any,
                       rules: ShardingRules | None = None) -> Any:
    """Restore ``ckpt_dir`` into the structure of ``abstract_state``, a
    tree of tensors (any device, meta included) or a port
    :class:`TrainState`.  Each leaf comes back with the template's dtype
    (float32 files of bfloat16 leaves narrowed, exactly), on the mesh's
    device with ``rules`` (elastic restore; a leaf whose logical axes
    would split it over more than one device raises), else on the
    template leaf's device (the CPU for a meta template).  A
    ``TrainState`` of a model is restored in place, a leaf at a time:
    its model's per-layer ``Parameter``s, step and optimizer tensors
    receive the values (so a restore needs no second copy of the state
    on the device), and the mesh's device must be theirs; the result is
    a ``TrainState`` of that model, step and optimizer state."""
    ckpt_dir = Path(ckpt_dir)
    manifest = load_manifest(ckpt_dir)
    template = _template(abstract_state)
    names, likes = _flatten_with_names(template)
    by_name = {e["name"]: e for e in manifest["leaves"]}
    restored = []
    for name, like in zip(names, likes):
        arr = np.load(ckpt_dir / f"{name}.npy", allow_pickle=False)
        if tuple(arr.shape) != like.shape:
            raise ValueError(
                f"checkpoint leaf {name}: shape {arr.shape} != expected "
                f"{like.shape}"
            )
        if like.dtype is None:
            restored.append(arr.item())
            continue
        dev = _place(rules, like.shape, by_name[name]["axes"], like)
        t = torch.from_numpy(np.array(arr))
        if not like.into:
            restored.append(t.to(device=dev, dtype=like.dtype))  # repro-lint: disable=TS103 -- a restore copies each leaf from disk to its device once
            continue
        if dev != like.device:
            raise ValueError(
                f"checkpoint leaf {name}: the mesh places it on {dev}, the "
                f"state restored into it is on {like.device}")
        with torch.no_grad():
            for dst, src in zip(like.into, t.reshape(
                    (-1,) + tuple(like.into[0].shape))):
                dst.copy_(src)
        # a stacked parameter leaf lives in the model's layers
        restored.append(like.into[0] if len(like.into) == 1 else None)
    leaves = iter(restored)
    tree = tree_map(lambda _: next(leaves), template)
    if isinstance(abstract_state, TrainState) and isinstance(
            abstract_state.params, nn.Module):
        return _into_state(abstract_state, tree)
    return tree


def _into_state(state: TrainState, tree: TrainState) -> TrainState:
    """A :class:`TrainState` of ``state``'s model (restored in place)
    with ``tree``'s step and optimizer state in the port's ``{leaf:
    ...}`` form."""
    adamw = _is_adamw(state.opt_state)
    opt = {}
    for leaf in param_leaves(state.params):
        path = tuple(leaf.split("."))
        opt[leaf] = ({k: _at(tree.opt_state[k], path) for k in ("m", "v")}
                     if adamw else _at(tree.opt_state, path))
    return TrainState(tree.step, state.params, opt)


def _at(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


class CheckpointManager:
    """Rolling async checkpointer.

    save() copies the state to the host (complete when it returns), then
    hands the write to a background thread; wait() joins.  Retains the
    ``keep`` newest steps."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.directory.mkdir(parents=True, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.directory.glob("step_*")
            if p.is_dir()
        )

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, state: Any, axes_tree: Any = None) -> None:
        self.wait()
        # the port's step updates parameters in place: copy everything
        # to the host now, synchronously, one stacked leaf at a time
        host_state = _as_tree(state, _snapshot)

        def write():
            try:
                save_checkpoint(self.directory, step, host_state, axes_tree)
                self._gc()
            except BaseException as exc:  # noqa: BLE001 — raised by wait()
                self._error = exc

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise()

    def _raise(self) -> None:
        if self._error is not None:
            exc, self._error = self._error, None
            raise exc

    def restore_latest(self, abstract_state: Any,
                       rules: ShardingRules | None = None):
        self.wait()
        step = self.latest_step()
        if step is None:
            return None, None
        state = restore_checkpoint(
            self.directory / f"step_{step:08d}", abstract_state, rules
        )
        return step, state

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
