"""Reuse (LRU stack) distances — port of ``repro/core/reuse/distance.py``
(paper §2.3 / §3.3.1).

Conventions
-----------
* A reuse distance of ``INF_RD`` (= -1 sentinel) marks a first-touch
  (compulsory) access, the paper's ``D = ∞``.
* Distances are measured in *distinct elements* (addresses or cache
  lines) accessed strictly between two uses of the same element
  (Table 1 of the paper).

The reference routes short traces through a jitted Fenwick
``lax.scan`` and long ones through its offline engine; the two are
bit-identical by the reference's own contract
(``tests/core/test_batched_rd.py``), so :func:`reuse_distances` here
always runs the offline engine (:mod:`.batched`) as torch ops on the
requested device.  The Fenwick scan, ``per_set_reuse_distances`` and
the streaming windows are not ported yet (ROADMAP queue A).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from .batched import INF_RD, reuse_distances_offline

#: Number of :func:`reuse_distances` passes per device type ("cuda",
#: "cpu") — lets a run show where its distances were computed.
PASSES: collections.Counter = collections.Counter()


def reuse_distances_ref(addresses) -> np.ndarray:
    """O(N·M) LRU-stack reuse distances.  Ground-truth oracle for tests.

    Reproduces Table 1 of the paper exactly (first touch -> INF_RD).
    """
    stack: list = []  # stack[0] is most-recently-used
    out = np.empty(len(addresses), dtype=np.int64)
    for t, a in enumerate(addresses):
        try:
            d = stack.index(a)
            out[t] = d
            stack.pop(d)
        except ValueError:
            out[t] = INF_RD
        stack.insert(0, a)
    return out


def reuse_distances(addresses, line_size: int = 1, *,
                    device) -> torch.Tensor:
    """Reuse distances of a trace as an int64 tensor on ``device``.

    ``line_size > 1`` maps addresses to lines first (cache prediction
    operates on line reuse, paper §3.3.2).  Bit-identical to every
    engine of the reference's ``reuse_distances``.
    """
    dev = torch.device(device)
    arr = torch.as_tensor(np.asarray(addresses, dtype=np.int64)).to(dev)
    PASSES[dev.type] += 1
    if line_size > 1:
        arr = arr // line_size
    return reuse_distances_offline(arr)
