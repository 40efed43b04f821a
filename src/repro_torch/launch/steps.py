"""Assemble an (arch x shape x mesh) cell's step, its shardings and its
abstract arguments; and the optimizer an architecture trains with.
Port of ``repro/launch/steps.py``, shared by the dry-run and the trainer.

Everything here works on tensors on the meta device (the reference's
``ShapeDtypeStruct`` stand-ins): a model built there, its optimizer
state, caches and batch have shapes and dtypes and allocate nothing.
The reference jits and lowers a cell; the port's counterpart of that
lowering is :func:`lower_cell`, which records the cell's step on those
arguments (every ATen op, and one op per kernel launch:
:mod:`repro_torch.analysis.aten_trace`).  On a production mesh,
:func:`distribute_cell` makes the arguments DTensors on a
``DeviceMesh`` (:func:`repro_torch.launch.mesh.fake_device_mesh`),
each placed by its sharding, and :func:`lower_cell` records one
partition's step: the reference's SPMD lowering, partition by
partition.  Shardings are
:class:`~repro_torch.dist.sharding.NamedSharding` trees parallel to the
arguments: a model's parameters by their ``{leaf: ...}``
(``train/optimizer.py::param_leaves``), a cache length the port holds
as a Python int replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchSpec, Shape
from repro_torch.dist.sharding import (
    NamedSharding, ShardingRules, distribute, param_shardings,
    placements, pspec_for, replicated_ops, use_sharding,
)
from repro_torch.dist.tree import tree_map
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers import param_axes
from repro_torch.train.optimizer import (
    Optimizer, adafactor, adamw, leaf_tensors,
)
from repro_torch.train.schedule import warmup_cosine
from repro_torch.train.train_step import (
    TrainState, build_train_step, init_state,
)

META = torch.device("meta")


def build_rules(mesh: Mesh, spec: ArchSpec, kind: str) -> ShardingRules:
    return ShardingRules(mesh, spec.rules_for(kind))


def make_optimizer(spec: ArchSpec, total_steps: int = 10000) -> Optimizer:
    sched = warmup_cosine(spec.peak_lr, min(500, total_steps // 10 + 1),
                          total_steps)
    if spec.optimizer_name == "adafactor":
        return adafactor(sched)
    return adamw(sched)


def abstract_params(spec: ArchSpec):
    """(the model on the meta device, ``{leaf: logical axes}``) — no
    allocation, no random draw."""
    model = spec.family.init(spec.config, device=META)
    return model, param_axes(model)


def abstract_inputs(spec: ArchSpec, shape: Shape) -> dict:
    """The step's batch as meta tensors of ``input_shapes``."""
    return {name: torch.empty(dims, dtype=dtype, device=META)
            for name, (dims, dtype) in spec.input_shapes(shape).items()}


def _tree_shardings(abstract, axes, rules):
    shardings, _ = param_shardings(abstract, axes, rules)
    return shardings


def stacked_params(model) -> dict:
    """``{leaf: tensor}``: the model's parameters as the reference's
    stacked leaves (on the meta device, shapes and dtypes only)."""
    with torch.no_grad():
        return leaf_tensors(model)


def batch_shardings(spec: ArchSpec, shape: Shape, rules: ShardingRules):
    axes = spec.batch_axes(shape)
    return {
        name: NamedSharding(rules.mesh, pspec_for(dims, axes[name], rules))
        for name, (dims, _) in spec.input_shapes(shape).items()
    }


@dataclasses.dataclass
class CellArtifacts:
    """Everything needed to record (lower) one cell."""
    kind: str
    fn: Callable                 # the step function
    in_shardings: Any
    out_shardings: Any
    abstract_args: tuple         # meta tensors, a meta model and its state
    donate_argnums: tuple
    rules: ShardingRules
    #: The ``DeviceMesh`` the arguments are DTensors on (None: one
    #: device, plain tensors).
    device_mesh: Any = None


# --- train --------------------------------------------------------------------


def build_train_cell(spec: ArchSpec, shape: Shape, mesh: Mesh,
                     *, grad_accum: int | None = None) -> CellArtifacts:
    rules = build_rules(mesh, spec, "train")
    cfg = spec.config
    fam = spec.family
    optimizer = make_optimizer(spec)
    accum = spec.grad_accum_for(shape) if grad_accum is None else grad_accum
    # the microbatch batch dim must stay divisible by the DP extent (the
    # reference's clamp: otherwise its partitioner replicates activations)
    dp = rules.axis_size(rules.dp_axes)
    while accum > 1 and (shape.global_batch % accum
                         or (shape.global_batch // accum) % dp):
        accum -= 1

    step_fn = build_train_step(
        lambda m, b: fam.loss_fn(m, b, cfg), optimizer, grad_accum=accum,
        accum_dtype=spec.accum_dtype)

    model, paxes = abstract_params(spec)
    astate = init_state(model, optimizer)
    oaxes = optimizer.state_axes(paxes)
    opt_rules = rules.with_overrides(**spec.opt_rules) if spec.opt_rules \
        else rules
    state_sh = TrainState(
        NamedSharding(mesh, ()),
        _tree_shardings(stacked_params(model), paxes, rules),
        _tree_shardings(astate.opt_state, oaxes, opt_rules),
    )
    batch_sh = batch_shardings(spec, shape, rules)
    metrics_sh = {k: NamedSharding(mesh, ())
                  for k in ("loss", "grad_norm", "param_norm")}

    return CellArtifacts(
        kind="train",
        fn=step_fn,
        in_shardings=(state_sh, batch_sh),
        out_shardings=(state_sh, metrics_sh),
        abstract_args=(astate, abstract_inputs(spec, shape)),
        donate_argnums=(0,),
        rules=rules,
    )


# --- serve --------------------------------------------------------------------


def abstract_caches(spec: ArchSpec, shape: Shape):
    """(the caches on the meta device, their logical-axes tree)."""
    fam = spec.family
    acaches = fam.init_caches(spec.config, **spec.cache_kwargs(shape),
                              device=META)
    return acaches, fam.cache_axes(spec.config)


def _at_length(caches, length: int):
    """``caches`` with every ``length`` field (nested tuples too) set."""
    if not hasattr(caches, "_fields"):
        return caches
    return caches._replace(**{
        f: (length if f == "length" else _at_length(v, length))
        for f, v in zip(caches._fields, caches)})


def _serve_parts(spec: ArchSpec, shape: Shape, mesh: Mesh, kind: str):
    rules = build_rules(mesh, spec, kind)
    acaches, caxes = abstract_caches(spec, shape)
    model, paxes = abstract_params(spec)
    logits_sh = NamedSharding(
        mesh, pspec_for((shape.global_batch, _padded_vocab(spec)),
                        ("act_batch", "act_vocab"), rules))
    return (rules, model, acaches, _tree_shardings(acaches, caxes, rules),
            _tree_shardings(stacked_params(model), paxes, rules),
            batch_shardings(spec, shape, rules), logits_sh)


def _padded_vocab(spec: ArchSpec) -> int:
    cfg = spec.config
    return getattr(cfg, "backbone", cfg).padded_vocab


def build_prefill_cell(spec: ArchSpec, shape: Shape,
                       mesh: Mesh) -> CellArtifacts:
    cfg, fam = spec.config, spec.family
    rules, model, acaches, cache_sh, param_sh, batch_sh, logits_sh = \
        _serve_parts(spec, shape, mesh, "prefill")

    return CellArtifacts(
        kind="prefill",
        fn=lambda params, batch, caches: fam.prefill(params, batch, cfg,
                                                     caches),
        in_shardings=(param_sh, batch_sh, cache_sh),
        out_shardings=(logits_sh, cache_sh),
        abstract_args=(model, abstract_inputs(spec, shape), acaches),
        donate_argnums=(2,),
        rules=rules,
    )


def build_decode_cell(spec: ArchSpec, shape: Shape,
                      mesh: Mesh) -> CellArtifacts:
    """One decode step at the caches' last position (``length`` =
    ``max_len - 1``): attention reads the whole cache, the cost the
    reference's masked decode has at any position."""
    cfg, fam = spec.config, spec.family
    rules, model, acaches, cache_sh, param_sh, batch_sh, logits_sh = \
        _serve_parts(spec, shape, mesh, "decode")
    length = spec.cache_kwargs(shape)["max_len"] - 1
    repl = NamedSharding(mesh, ())

    return CellArtifacts(
        kind="decode",
        fn=lambda params, batch, caches, length: fam.decode_step(
            params, batch, cfg, caches, length),
        in_shardings=(param_sh, batch_sh, cache_sh, repl),
        out_shardings=(logits_sh, cache_sh),
        abstract_args=(model, abstract_inputs(spec, shape),
                       _at_length(acaches, length), length),
        donate_argnums=(2,),
        rules=rules,
    )


def build_cell(spec: ArchSpec, shape: Shape, mesh: Mesh) -> CellArtifacts:
    if shape.kind == "train":
        return build_train_cell(spec, shape, mesh)
    if shape.kind == "prefill":
        return build_prefill_cell(spec, shape, mesh)
    return build_decode_cell(spec, shape, mesh)


def cell_inputs(cell: CellArtifacts) -> dict[str, torch.Tensor]:
    """Every argument tensor of the cell by name (``params.*``,
    ``opt_state.*``, ``step``, ``batch.*``, ``caches.*``): the step's
    inputs, which a recording names and does not count as temporaries."""
    from repro_torch.analysis.aten_trace import _named_tensors

    if cell.kind == "train":
        state, batch = cell.abstract_args
        out = {f"params.{n}": t for n, t in state.params.named_parameters()}
        out.update(_named_tensors("opt_state", state.opt_state))
        out["step"] = state.step
        out.update(_named_tensors("batch", batch))
        return out
    model, batch, caches = cell.abstract_args[:3]
    out = {f"params.{n}": t for n, t in model.named_parameters()}
    out.update(_named_tensors("batch", batch))
    out.update(_named_tensors("caches", caches))
    return out


def _place(tree, shardings, device_mesh):
    """``tree`` with every tensor leaf a DTensor placed by its sharding."""
    return tree_map(
        lambda leaf, sh: distribute(leaf, sh.spec, device_mesh)
        if isinstance(leaf, torch.Tensor) else leaf, tree, shardings)


def _place_params(model, rules: ShardingRules, device_mesh) -> None:
    """Every parameter of ``model`` made, in place, a DTensor Parameter
    placed by its logical axes (its stacked leaf's PartitionSpec without
    the unsharded layer dims)."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is None:
                continue
            spec = pspec_for(tuple(p.shape), p.axes, rules)
            new = torch.nn.Parameter(
                distribute(p.detach(), spec, device_mesh),
                requires_grad=p.requires_grad)
            new.axes = p.axes
            module._parameters[name] = new


def distribute_cell(cell: CellArtifacts, device_mesh) -> CellArtifacts:
    """The cell with its abstract arguments as DTensors on
    ``device_mesh`` (a ``DeviceMesh`` of the cell's mesh axes), each
    placed by ``cell.in_shardings`` (the model's parameters by their
    own axes; a length the port keeps as an int stays one).  Their local
    shards are on the meta device.  The model is converted in place."""
    args, shs = cell.abstract_args, cell.in_shardings
    if cell.kind == "train":
        state, batch = args
        _place_params(state.params, cell.rules, device_mesh)
        state = TrainState(
            distribute(state.step, (), device_mesh), state.params,
            _place(state.opt_state, shs[0].opt_state, device_mesh))
        new = (state, _place(batch, shs[1], device_mesh))
    else:
        model, batch, caches = args[:3]
        _place_params(model, cell.rules, device_mesh)
        new = (model, _place(batch, shs[1], device_mesh),
               _place(caches, shs[2], device_mesh), *args[3:])
    return dataclasses.replace(cell, abstract_args=new,
                               device_mesh=device_mesh)


def run_step(cell: CellArtifacts, args: tuple | None = None):
    """One call of the cell's step on ``args`` (its abstract arguments by
    default): ``(result, replicated_ops)``.  A distributed cell's step
    runs under its rules on its device mesh (its ``shard`` sites placing
    DTensors), plain tensors taken as replicated, and the logits leave
    as ``out_shardings`` places them (the train step holds its state to
    its inputs' shardings itself); ``replicated_ops`` are the sites that
    gathered an operand (:func:`~repro_torch.dist.sharding.place_for`),
    ``{}`` on one device.  The dry-run records this call, and a
    partition that runs on the card makes it."""
    args = cell.abstract_args if args is None else args
    if cell.device_mesh is None:
        return cell.fn(*args), {}
    from torch.distributed.tensor.experimental import implicit_replication

    with use_sharding(cell.rules, cell.device_mesh), \
            implicit_replication():
        result = cell.fn(*args)
        if cell.kind != "train":
            logits, caches = result
            pl = placements(cell.out_shardings[0].spec, cell.device_mesh)
            if tuple(logits.placements) != pl:
                logits = logits.redistribute(cell.device_mesh, pl)
            result = (logits, caches)
        return result, replicated_ops()


def lower_cell(cell: CellArtifacts):
    """Record one call of the cell's step on its abstract arguments (the
    port's lowering, :func:`run_step`): an
    :class:`~repro_torch.analysis.aten_trace.Recording` and the step's
    result.  A distributed cell's recording is one partition's."""
    from repro_torch.analysis.aten_trace import record

    out = {}

    def call():
        out["result"], out["replicated"] = run_step(cell)

    rec = record(call, cell_inputs(cell))
    if cell.device_mesh is not None:
        rec.replicated = out["replicated"]
    return rec, out["result"]
