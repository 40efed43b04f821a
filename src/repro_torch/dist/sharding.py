"""Work partitioning of the reference's sharded reuse engines — port of
the numpy half of ``repro/dist/sharding.py`` (pure Python; the mesh and
logical-axis rules belong to the training path, not ported yet).  The
port's reuse engines run one pass on one device and take ``num_shards``
only for the reference's signatures, so nothing routes work through
these functions until there are real per-device shards."""
from __future__ import annotations

import torch


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
