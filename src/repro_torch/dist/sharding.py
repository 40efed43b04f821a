"""Logical-axes sharding: one rules table maps model-code axis names onto
whatever mesh the run has (port of ``repro/dist/sharding.py``), and the
work partitioning of the reference's sharded reuse engines.

Parameters, caches and batches carry *logical* axis names
(``"embed"``, ``"act_batch"``, ...: :func:`repro_torch.models.layers.param`,
``Family.cache_axes``, ``ArchSpec.batch_axes``); a
:class:`ShardingRules` table resolves them to mesh axes.  Resolution is
the reference's, mesh-aware and total:

* rules may name mesh axes the mesh does not have (a host mesh has no
  ``"model"`` axis, and some architectures' rules name ``"tp"``, ``"dp"``
  or ``"dp+tp"``, which no mesh has: ROADMAP C10) — those replicate;
* a dimension that a mapped mesh axis does not divide falls back to
  replication (recorded, so ``plan_remesh`` can report it);
* a mesh axis is never used twice within one PartitionSpec.

A PartitionSpec is a tuple with the reference's entries — ``None``, an
axis name, or a tuple of names — and no trailing ``None``.  On a
production mesh the port partitions with DTensor
(``torch.distributed.tensor``) over a ``DeviceMesh`` of the mesh's axes
(:func:`repro_torch.launch.mesh.fake_device_mesh`): :func:`placements`
turns a PartitionSpec into DTensor placements, and inside
:func:`use_sharding` :func:`shard` redistributes a DTensor to the
placements its logical axes resolve to, the reference's
``with_sharding_constraint``; outside it, and on one device, it returns
its input.  Where an operand must be replicated for an op that has no
sharded form (:func:`place_for`), the site is counted
(:func:`replicated_ops`), never silently.
The port's reuse engines run one pass on one device and take
``num_shards`` only for the reference's signatures, so nothing routes
work through :func:`partition_segments` until there are real
per-device shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.dist.tree import is_axes, leaves_with_path, tree_map
from repro_torch.launch.mesh import Mesh

# Default logical-axis -> mesh-axis table.  Tuples try the axes in
# order (DP runs over ("pod", "data") when both exist).  ``None``
# replicates.  Unknown logical names replicate.
DEFAULT_RULES: dict[str, Any] = {
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_kv_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    # parameters
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    # stacked leading axes are never sharded
    "layers": None,
    "groups": None,
}


def _as_tuple(v) -> tuple:
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """A mesh plus the logical->physical axis table for one run."""

    mesh: Mesh
    rules: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        merged = dict(DEFAULT_RULES)
        merged.update(self.rules or {})
        object.__setattr__(self, "rules", merged)

    def with_overrides(self, **overrides) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(self.mesh, merged)

    def mesh_axes_for(self, logical: str | None) -> tuple[str, ...]:
        """Mesh axes (present in this mesh) a logical axis maps onto."""
        if logical is None:
            return ()
        mapped = _as_tuple(self.rules.get(logical))
        return tuple(a for a in mapped if a in self.mesh.shape)

    def axis_size(self, axes) -> int:
        """Product of mesh-axis sizes (missing axes count as 1)."""
        return math.prod(
            self.mesh.shape.get(a, 1) for a in _as_tuple(axes)
        ) or 1

    @property
    def dp_axes(self) -> tuple[str, ...]:
        """Mesh axes the batch dimension shards over."""
        return self.mesh_axes_for("act_batch")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A PartitionSpec on a mesh (``jax.sharding.NamedSharding``); a leaf
    of a shardings tree."""

    mesh: Mesh
    spec: tuple


def pspec_for(shape, logical_axes, rules: ShardingRules,
              fallbacks: list | None = None) -> tuple:
    """PartitionSpec for an array of ``shape`` whose dims carry
    ``logical_axes`` names (None entries replicate).

    Mesh axes that don't divide the dimension, or that an earlier
    dimension already consumed, fall back to replication; each such
    event is appended to ``fallbacks`` as ``(logical_axis, dim)``.
    """
    axes = _as_tuple(logical_axes)
    if len(axes) < len(shape):
        axes = axes + (None,) * (len(shape) - len(axes))
    used: set[str] = set()
    entries: list = []
    for dim, logical in zip(range(len(shape)), axes):
        mapped = rules.mesh_axes_for(logical)
        avail = tuple(a for a in mapped if a not in used)
        extent = math.prod(rules.mesh.shape[a] for a in avail) if avail else 1
        if not avail:
            if mapped and fallbacks is not None:
                fallbacks.append((logical, dim))
            entries.append(None)
            continue
        if shape[dim] % extent != 0:
            if fallbacks is not None:
                fallbacks.append((logical, dim))
            entries.append(None)
            continue
        used.update(avail)
        entries.append(avail[0] if len(avail) == 1 else avail)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_devices(spec: tuple, mesh: Mesh) -> int:
    """How many shards a PartitionSpec splits a leaf into on ``mesh``."""
    return math.prod(mesh.shape[a] for p in spec if p is not None
                     for a in _as_tuple(p))


def leaf_shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or ``()`` for a Python number (the
    port's cache lengths, which the reference holds as int32 arrays)."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def param_shardings(abstract_tree, axes_tree, rules: ShardingRules):
    """(NamedSharding tree, fallback list) for a tree of tensors (any
    device, meta included) and a parallel tree of logical-axes tuples;
    fallbacks in the reference's flatten order."""
    fallbacks: list = []
    specs = {}
    for path, leaf, axes in leaves_with_path(abstract_tree, axes_tree):
        specs[path] = NamedSharding(
            rules.mesh, pspec_for(leaf_shape(leaf), axes, rules, fallbacks))
    return tree_map(lambda path, _: specs[path], abstract_tree,
                    with_path=True), fallbacks


# --- DTensor placements -------------------------------------------------------


def is_dtensor(x) -> bool:
    """``x`` is a ``torch.distributed.tensor.DTensor`` (checked without
    importing the distributed package on paths that have none)."""
    return type(x).__name__ == "DTensor" and hasattr(x, "device_mesh")


def placements(spec: tuple, device_mesh) -> tuple:
    """DTensor placements of a PartitionSpec on a ``DeviceMesh`` with the
    mesh's axis names: ``Shard(d)`` on each mesh dim that tensor dim
    ``d`` names (one dim over ``("pod", "data")`` is sharded on both,
    the first the major one, as the reference lays it out),
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard

    names = device_mesh.mesh_dim_names
    out = [Replicate()] * device_mesh.ndim
    for dim, entry in enumerate(spec):
        for axis in _as_tuple(entry):
            out[names.index(axis)] = Shard(dim)
    return tuple(out)


def local_shape(shape, pl, device_mesh) -> tuple:
    """The shape of one partition's shard of a tensor of ``shape``
    placed by ``pl`` (every sharded dim divides evenly: ``pspec_for``
    shards nothing else)."""
    out = list(shape)
    for mesh_dim, p in enumerate(pl):
        if p.is_shard():
            out[p.dim] //= device_mesh.size(mesh_dim)
    return tuple(out)


def distribute(t: torch.Tensor, spec: tuple, device_mesh):
    """A DTensor of ``t``'s global shape and dtype placed by ``spec``,
    ``requires_grad`` as ``t``.  On the meta device its local shard is an
    empty meta tensor (nothing allocated); else it is this partition's
    slice of ``t``, which every partition holds whole (no collective)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, device_mesh)
    if t.device.type == "meta":
        local = torch.empty(local_shape(t.shape, pl, device_mesh),
                            dtype=t.dtype, device=t.device)
        out = DTensor.from_local(local, device_mesh, pl, run_check=False)
    else:
        out = distribute_tensor(t.detach(), device_mesh, pl,
                                src_data_rank=None)
    return out.requires_grad_(t.requires_grad) if t.is_floating_point() \
        else out


# --- the shard() constraint ---------------------------------------------------


@dataclasses.dataclass
class _Scope:
    rules: ShardingRules
    device_mesh: Any
    replicated: dict


_ACTIVE: list[_Scope] = []


@contextlib.contextmanager
def use_sharding(rules: ShardingRules, device_mesh=None):
    """Activate ``rules`` for :func:`shard` calls in this block;
    ``device_mesh`` (a ``DeviceMesh`` of ``rules.mesh``'s axes) places
    the plain tensors that a :func:`shard` site meets."""
    _ACTIVE.append(_Scope(rules, device_mesh, {}))
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def current_rules() -> ShardingRules | None:
    return _ACTIVE[-1].rules if _ACTIVE else None


def replicated_ops() -> dict:
    """``{"site: op": count}`` of the operands that
    :func:`place_for` gathered in the innermost
    :func:`use_sharding` block."""
    return dict(_ACTIVE[-1].replicated) if _ACTIVE else {}


def shard(x, *logical_axes):
    """Constrain ``x``'s sharding by logical axis names (the reference's
    ``with_sharding_constraint``): ``x`` itself outside
    :func:`use_sharding` and on a one-device mesh; else ``x`` as a
    DTensor redistributed to the placements that ``pspec_for`` resolves
    for its shape (a plain tensor is taken as replicated on the block's
    device mesh).  A Partial operand is reduced there, as the
    reference's partitioner reduces it at the constraint."""
    rules = current_rules()
    if rules is None or rules.mesh.size == 1:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    if is_dtensor(x):
        mesh = x.device_mesh
    else:
        mesh = _ACTIVE[-1].device_mesh
        if mesh is None:
            raise RuntimeError(f"shard{logical_axes} of a plain tensor on "
                               f"a {rules.mesh.size}-device mesh needs the "
                               "block's device mesh")
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    pl = placements(pspec_for(tuple(x.shape), logical_axes, rules), mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def kept(x, dims) -> tuple:
    """``x``'s placements with every one but ``Shard(d)`` for ``d`` in
    ``dims`` made ``Replicate()``."""
    from torch.distributed.tensor import Replicate

    return tuple(p if p.is_shard() and p.dim in dims else Replicate()
                 for p in x.placements)


def place_for(x, pl, site: str):
    """``x`` (a DTensor) redistributed to placements ``pl`` for an op that
    runs on local shards (a kernel): a Partial sum is reduced, a
    replicated dim is split locally, and a sharded dim that ``pl``
    replicates is gathered and counted at ``site`` in
    :func:`replicated_ops`."""
    pl = tuple(pl)
    if pl == tuple(x.placements):
        return x
    if _ACTIVE and any(p.is_shard() and p != q
                       for p, q in zip(x.placements, pl)):
        key = f"{site}: {list(x.shape)}"
        scope = _ACTIVE[-1].replicated
        scope[key] = scope.get(key, 0) + 1
    return x.redistribute(x.device_mesh, pl)


def from_local(t: torch.Tensor, device_mesh, pl):
    """The DTensor whose partition's shard is ``t`` (differentiable);
    every partition's shard has ``t``'s shape and strides."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, device_mesh, pl, run_check=False)


def like(x, ref):
    """``x`` placed as ``ref`` when both are DTensors (a step's new state
    held to its input's sharding: the reference's ``out_shardings``, and
    a gradient reduced to its parameter's); else ``x``."""
    if not (is_dtensor(x) and is_dtensor(ref)) or \
            tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def microbatches(x, n: int) -> list:
    """``x`` ``[B, ...]`` cut into ``n`` microbatches of ``B/n`` rows in
    order (``x.reshape((n, B/n, ...))[i]``).  A DTensor sharded over its
    rows is gathered first, since a microbatch cuts across every
    partition's rows, and each microbatch is placed as ``x``: the
    gather is counted at ``"train_step.microbatch"``."""
    if not is_dtensor(x):
        return [x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
                for i in range(n)]
    from torch.distributed.tensor import Replicate

    pl = tuple(x.placements)
    whole = place_for(x, tuple(Replicate() if p.is_shard(0) else p
                               for p in pl), "train_step.microbatch")
    whole = whole.reshape((n, x.shape[0] // n) + x.shape[1:])
    return [whole[i].redistribute(x.device_mesh, pl) for i in range(n)]


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``.  A DTensor sharded over its last
    dim reduces each partition's slice, then across the slices: the
    max, and the sum of exponentials below it (the shift detached: the
    result does not depend on it), where DTensor's own logsumexp would
    gather the whole dim on every partition."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Partial, Replicate

    mesh, last = x.device_mesh, x.dim() - 1
    x = place_for(x, kept(x, tuple(range(x.dim()))), "logsumexp_last.x")
    if not any(p.is_shard(last) for p in x.placements):
        return torch.logsumexp(x, dim=-1)
    xl = x.to_local()
    rest = tuple(Replicate() if p.is_shard(last) else p
                 for p in x.placements)

    def across(t, op):
        return from_local(t, mesh, tuple(
            Partial(op) if p.is_shard(last) else p
            for p in x.placements)).redistribute(mesh, rest).to_local()

    top = across(xl.detach().amax(dim=-1), "max")
    total = across(torch.exp(xl - top[..., None]).sum(dim=-1), "sum")
    return from_local(top + torch.log(total), mesh, rest)


def unflatten_last(x, sizes: tuple):
    """``x.unflatten(-1, sizes)``.  A DTensor sharded over its last dim
    more ways than ``sizes[0]`` divides is gathered over that dim first
    (counted at ``"unflatten_last"``): DTensor views no uneven split,
    and the dims that come out could not take that sharding anyway."""
    if is_dtensor(x):
        last = x.dim() - 1
        mesh = x.device_mesh
        n = math.prod(mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard(last))
        if sizes[0] % n:
            x = place_for(x, kept(x, tuple(range(last))), "unflatten_last")
    return x.unflatten(-1, sizes)


def take_last(x, index):
    """``x.gather(-1, index[..., None])[..., 0]``.  A DTensor ``x`` sharded
    over its last dim (the vocabulary of a logits tensor) gathers on each
    partition's slice, an index outside it reading 0, and the slices'
    values are summed: the vocab-parallel gather that XLA's partitioner
    makes, whose gradient stays a scatter into the local slice (DTensor's
    own gather would make the whole global tensor on every partition)."""
    if not is_dtensor(x):
        return x.gather(-1, index[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    mesh, last = x.device_mesh, x.dim() - 1
    x = place_for(x, kept(x, tuple(range(x.dim()))), "take_last.x")
    index = place_for(index, tuple(
        p if p.is_shard() and p.dim < last else Replicate()
        for p in x.placements), "take_last.index")
    xl, il = x.to_local(), index.to_local()
    first = shard_index(mesh, x.placements, last)[0] * xl.shape[-1]
    local = il - first
    inside = (local >= 0) & (local < xl.shape[-1])
    got = xl.gather(-1, local.clamp(0, xl.shape[-1] - 1)[..., None])[..., 0]
    got = torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                               device=got.device))
    out = from_local(got, mesh, tuple(
        Partial() if p.is_shard(last) else p for p in x.placements))
    return out.redistribute(mesh, tuple(
        Replicate() if p.is_partial() else p for p in out.placements))  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values


def lookup_rows(table, index):
    """``table[index]``, rows of a ``[V, d]`` table.  A DTensor table
    sharded over its rows (a vocabulary) looks up each partition's rows,
    an index outside them reading zeros, and the partitions' rows are
    summed: the vocab-parallel gather that XLA's partitioner makes, where
    DTensor's indexing would gather the whole table on every partition.
    A mesh dim that shards the table's columns shards the result's last
    dim; one that shards the index (and not the table) shards the
    result as the index; an index sharded where the table is too is
    gathered (counted at ``"lookup_rows.index"``)."""
    if not is_dtensor(table):
        return table[index]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, last = table.device_mesh, index.dim()
    table = place_for(table, kept(table, (0, 1)), "lookup_rows.table")
    index = place_for(index, tuple(
        q if q.is_shard() and p.is_replicate() else Replicate()
        for p, q in zip(table.placements, index.placements)),
        "lookup_rows.index")
    out_pl = tuple(Partial() if p.is_shard(0) else Shard(last)
                   if p.is_shard(1) else q
                   for p, q in zip(table.placements, index.placements))
    tl = local_shard(table, tuple(not p.is_replicate() for p in out_pl))
    il = index.to_local()
    if any(p.is_shard(0) for p in table.placements):
        il = il - shard_index(mesh, table.placements, 0)[0] * tl.shape[0]
        inside = (il >= 0) & (il < tl.shape[0])
        rows = tl[il.clamp(0, tl.shape[0] - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
    else:
        rows = tl[il]
    out = from_local(rows, mesh, out_pl)
    return out.redistribute(mesh, tuple(
        Replicate() if p.is_partial() else p for p in out_pl))  # repro-lint: disable=TS110 -- branches on DTensor placements (host objects), not on device values


def shard_index(device_mesh, pl, dim: int) -> tuple[int, int]:
    """(index, count) of this partition's shard of a tensor's dim ``dim``
    placed by ``pl`` on ``device_mesh``, among the shards the mesh splits
    it into (the mesh dims sharding it, the first the major one)."""
    coord = device_mesh.get_coordinate()
    idx, count = 0, 1
    for mesh_dim, p in enumerate(pl):
        if p.is_shard(dim):
            n = device_mesh.size(mesh_dim)
            idx, count = idx * n + coord[mesh_dim], count * n
    return idx, count


def local_shard(x, split):
    """This partition's shard of DTensor ``x`` for a computation on local
    shards whose result differs across the mesh dims where ``split`` is
    true: over such a dim where ``x`` is replicated, each partition's
    gradient of its shard is a partial sum (``Partial()``), which
    DTensor reduces; elsewhere it is placed as ``x``."""
    from torch.distributed.tensor import Partial

    return x.to_local(grad_placements=tuple(
        Partial() if s and p.is_replicate() else p
        for p, s in zip(x.placements, split)))


def on_shards(fn, site: str, operands, out_placements):
    """``fn`` run on one partition's local shards: the kernels and the
    ops that DTensor has no sharded form for.  ``operands`` are ``(name,
    x, pl)``: a DTensor ``x`` is placed by ``pl`` (:func:`place_for`,
    counted at ``site.name``) and passed as its local shard, anything
    else as it is.  Each output of ``fn`` (one tensor or a tuple) becomes
    the DTensor on the operands' mesh placed by the matching entry of
    ``out_placements`` (one placement tuple, or one for each output).
    The outputs must agree on which mesh dims they are split over; an
    operand replicated over such a dim takes a partial gradient there
    (:func:`local_shard`)."""
    single = hasattr(out_placements[0], "is_shard")
    outs = (out_placements,) if single else tuple(out_placements)
    split = tuple(not p.is_replicate() for p in outs[0])
    if any(tuple(not p.is_replicate() for p in pl) != split for pl in outs):
        raise NotImplementedError(
            f"{site}: outputs split over different mesh dims {outs}")
    mesh, args = None, []
    for name, x, pl in operands:
        if is_dtensor(x):
            x = place_for(x, pl, f"{site}.{name}")
            mesh = x.device_mesh
            x = local_shard(x, split)
        args.append(x)
    out = fn(*args)
    if single:
        return from_local(out, mesh, outs[0])
    return tuple(from_local(o, mesh, pl) for o, pl in zip(out, outs))


# --- work partitioning for the sharded reuse engines -------------------------


def local_shard_count(device) -> int:
    """Natural shard count for device-parallel dispatch: the number of
    devices of ``device``'s type (1 on the CPU, the visible CUDA devices
    on the card)."""
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def partition_segments(lengths, num_shards: int) -> list[list[int]]:
    """Deterministic LPT partition of independent work items.

    Items (identified by index into ``lengths``) are assigned
    longest-first to the currently least-loaded shard; every tie breaks
    on the lower index, so the partition is a pure function of
    ``(lengths, num_shards)`` — reruns and resumptions shard
    identically.  Within each shard, indices come back sorted, and
    every shard list is present (possibly empty).
    """
    num_shards = max(int(num_shards), 1)
    order = sorted(range(len(lengths)),
                   key=lambda i: (-int(lengths[i]), i))
    loads = [0] * num_shards
    groups: list[list[int]] = [[] for _ in range(num_shards)]
    for i in order:
        s = min(range(num_shards), key=lambda j: (loads[j], j))
        loads[s] += int(lengths[i])
        groups[s].append(i)
    return [sorted(g) for g in groups]


__all__ = [
    "DEFAULT_RULES", "NamedSharding", "ShardingRules", "current_rules",
    "distribute", "from_local", "is_axes", "is_dtensor", "kept",
    "leaf_shape", "like", "local_shape", "local_shard", "local_shard_count",
    "logsumexp_last", "lookup_rows", "microbatches", "on_shards",
    "param_shardings", "partition_segments", "place_for", "placements",
    "pspec_for", "replicated_ops", "shard", "shard_index", "spec_devices",
    "take_last", "unflatten_last", "use_sharding",
]
