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
axis name, or a tuple of names — and no trailing ``None``.  On one
device nothing is partitioned: :func:`shard` returns its input, and the
model code does not call it (its 29 ``shard`` sites in the reference
only constrain a partitioner, which the port has not: ROADMAP C12).
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


# --- the shard() constraint ---------------------------------------------------

_ACTIVE: list[ShardingRules] = []


@contextlib.contextmanager
def use_sharding(rules: ShardingRules):
    """Activate ``rules`` for :func:`shard` calls in this block."""
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def current_rules() -> ShardingRules | None:
    return _ACTIVE[-1] if _ACTIVE else None


def shard(x, *logical_axes):
    """Constrain ``x``'s sharding by logical axis names: ``x`` itself
    outside :func:`use_sharding` and on a one-device mesh; a mesh of
    more devices needs a partitioner, which the port has not (ROADMAP
    A-11d), and raises."""
    rules = current_rules()
    if rules is None or rules.mesh.size == 1:
        return x
    raise NotImplementedError(
        f"shard{logical_axes} over a {rules.mesh.size}-device mesh needs a "
        "partitioner (ROADMAP A-11d)")


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
    "is_axes", "leaf_shape", "local_shard_count", "param_shardings",
    "partition_segments", "pspec_for", "shard", "spec_devices",
    "use_sharding",
]
