"""Port of ``repro/workloads/tracegen.py`` (host numpy, bit-identical).

Synthetic-trace construction helpers — the ROSE/Byfl stand-in.

The paper instruments the ROSE-translated binary with a modified Byfl
to capture the BB-labeled trace of the ``OUT__*`` parallel functions.
Instead of an LLVM toolchain, each workload ships an *analytic* trace
generator that emits exactly the address stream its parallel section's
loop nest performs (same program order, same 8-byte element
granularity, one BB instance per parallelized-loop iteration).

Shared labeling: OpenMP shared variables (scalars AND shared arrays —
they are accessed through the translated ``shared_struct`` pointers)
keep their addresses across mimicked cores; everything else is
per-core-offset by Algorithm 1.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.trace.types import LabeledTrace, trace_from_blocks

ELEM = 8  # sizeof(double)


class ArrayHandle:
    def __init__(self, name: str, base: int, shape: tuple[int, ...], shared: bool):
        self.name = name
        self.base = base
        self.shape = shape
        self.shared = shared
        self.strides = np.array(
            [int(np.prod(shape[i + 1 :], dtype=np.int64)) for i in range(len(shape))],
            dtype=np.int64,
        )

    def addr(self, *idx) -> np.ndarray:
        """Vectorized address computation; idx components broadcast."""
        idx = [np.asarray(i, dtype=np.int64) for i in idx]
        assert len(idx) == len(self.shape), (self.name, len(idx), self.shape)
        off = np.zeros((), dtype=np.int64)
        for i, s in zip(idx, self.strides):
            off = off + i * s
        return self.base + off * ELEM

    @property
    def size_bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * ELEM


class AddressSpace:
    """Lays arrays out contiguously with page-aligned bases."""

    def __init__(self, align: int = 4096):
        self.align = align
        self._next = align
        self.arrays: dict[str, ArrayHandle] = {}

    def array(self, name: str, *shape: int, shared: bool = True) -> ArrayHandle:
        h = ArrayHandle(name, self._next, shape, shared)
        self.arrays[name] = h
        self._next += ((h.size_bytes + self.align - 1) // self.align) * self.align
        return h

    @property
    def total_bytes(self) -> int:
        return sum(h.size_bytes for h in self.arrays.values())


class TraceBuilder:
    """Collects (bb_name, addresses, shared_mask) instances."""

    def __init__(self):
        self.blocks: list[tuple[str, np.ndarray, np.ndarray]] = []

    def instance(self, name: str, refs: list[tuple[np.ndarray, bool]]) -> None:
        """One dynamic BB instance; refs = [(addresses, shared), ...] in
        program order (each addresses entry may be scalar or vector)."""
        addr_parts, shared_parts = [], []
        for addrs, shared in refs:
            a = np.atleast_1d(np.asarray(addrs, dtype=np.int64)).ravel()
            addr_parts.append(a)
            shared_parts.append(np.full(len(a), shared, dtype=bool))
        self.blocks.append(
            (name, np.concatenate(addr_parts), np.concatenate(shared_parts))
        )

    def interleaved_instance(
        self, name: str, ref_groups: list[tuple[np.ndarray, bool]]
    ) -> None:
        """Like ``instance`` but round-robins the groups element-wise —
        models ``for j: load A[i][j]; load x[j]`` inner-loop ordering."""
        arrays = [np.atleast_1d(np.asarray(a, np.int64)).ravel() for a, _ in ref_groups]
        shareds = [s for _, s in ref_groups]
        L = max(len(a) for a in arrays)
        addr_cols, shared_cols = [], []
        for a, s in zip(arrays, shareds):
            pad = np.full(L, -1, dtype=np.int64)
            pad[: len(a)] = a
            addr_cols.append(pad)
            shared_cols.append(np.full(L, s, dtype=bool))
        addrs = np.stack(addr_cols, axis=1).ravel()
        mask = np.stack(shared_cols, axis=1).ravel()
        keep = addrs >= 0
        self.blocks.append((name, addrs[keep], mask[keep]))

    def build(self) -> LabeledTrace:
        return trace_from_blocks(self.blocks)
