"""Elastic scaling: re-plan shardings when the device pool changes (port
of ``repro/runtime/elastic.py``).

A checkpoint stores *logical* axes, so scaling from 512 -> 256 chips or
down to one card is a restore with a new mesh.  ``plan_remesh`` reports
exactly which leaves change shardings and which logical mappings stop
dividing (fall back to replication) — the operator-facing diff before
committing to a restart — and the bytes each device would hold.
"""
from __future__ import annotations

import dataclasses

from repro_torch.dist.sharding import ShardingRules, pspec_for, spec_devices
from repro_torch.launch.mesh import Mesh
from repro_torch.runtime.checkpoint import load_manifest


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_mesh_axes: dict
    new_mesh_axes: dict
    shardings: dict              # leaf name -> PartitionSpec (new mesh)
    fallbacks: list              # (leaf, logical axis, dim) that replicate
    bytes_per_device: float

    def summary(self) -> str:
        lines = [
            f"remesh {self.old_mesh_axes} -> {self.new_mesh_axes}:"
            f" {len(self.shardings)} leaves,"
            f" {len(self.fallbacks)} replication fallbacks,"
            f" {self.bytes_per_device / 2**30:.2f} GiB/device"
        ]
        for leaf, axis, dim in self.fallbacks[:20]:
            lines.append(f"  fallback {leaf}: {axis!r} over dim {dim}")
        return "\n".join(lines)


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
                "int8": 1, "float64": 8, "int64": 8, "uint32": 4}


def plan_remesh(ckpt_dir, new_mesh: Mesh,
                rule_overrides: dict | None = None,
                old_mesh_axes: dict | None = None) -> RemeshPlan:
    manifest = load_manifest(ckpt_dir)
    rules = ShardingRules(new_mesh, rule_overrides or {})
    shardings, fallbacks = {}, []
    total_bytes = 0.0
    for entry in manifest["leaves"]:
        axes = entry["axes"]
        shape = tuple(entry["shape"])
        if axes is None:
            axes = (None,) * len(shape)
        fb: list = []
        spec = pspec_for(shape, tuple(axes), rules, fb)
        shardings[entry["name"]] = spec
        for axis, dim in fb:
            fallbacks.append((entry["name"], axis, dim))
        leaf_bytes = float(_DTYPE_BYTES.get(entry["dtype"], 4))
        for d in shape:
            leaf_bytes *= d
        total_bytes += leaf_bytes / spec_devices(spec, new_mesh)
    return RemeshPlan(
        old_mesh_axes=old_mesh_axes or {},
        new_mesh_axes=dict(new_mesh.shape),
        shardings=shardings,
        fallbacks=fallbacks,
        bytes_per_device=total_bytes,
    )


def fits(plan: RemeshPlan, hbm_bytes: int, headroom: float = 0.7) -> bool:
    """Would the checkpointed state fit the per-device memory budget?"""
    return plan.bytes_per_device <= hbm_bytes * headroom
