"""Exact multi-level set-associative LRU cache simulation — port of
``repro/core/cachesim.py``.

This is the framework's ground-truth stand-in for the paper's PAPI
hardware counters (§4.1): predicted hit rates are validated against an
*exact* LRU simulation of the same traces.

Metric convention follows the paper's Table 6: the level-L hit rate is
cumulative —  1 - (misses at L) / (total memory accesses)  — which is
what `1 - PAPI_L2_DCM/(PAPI_LD_INS+PAPI_SR_INS)` measures.  Lower levels
see only the miss-filtered trace (inclusive hierarchy).

Exactness: an access hits an A-way LRU set-associative cache iff the
number of distinct same-set lines touched since its line's last use is
< A; those per-set distances are computed exactly on the device
(``per_set_reuse_distances``).  The hit mask and the miss filter that
feeds the next level stay on the device; each level reads one integer,
its hit count, back to the host.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

from .levels import CacheLevelConfig, LevelResult
from .reuse.distance import as_device_lines, per_set_reuse_distances

__all__ = [
    "CacheLevelConfig",
    "LevelResult",
    "simulate_level",
    "simulate_hierarchy",
]


def simulate_level(addresses, cfg: CacheLevelConfig, *,
                   device=None) -> torch.Tensor:
    """Boolean hit mask for one level (exact LRU), on ``device``."""
    rds = per_set_reuse_distances(
        addresses, line_size=cfg.line_size, num_sets=cfg.num_sets,
        device=device,
    )
    return (rds >= 0) & (rds < cfg.effective_assoc)


def simulate_hierarchy(
    addresses, levels: list[CacheLevelConfig], *, device=None
) -> list[LevelResult]:
    """Exact LRU simulation of an inclusive multi-level hierarchy."""
    dev = resolve_device(device)
    current = as_device_lines(addresses, 1, dev)
    total = current.numel()
    results: list[LevelResult] = []
    for cfg in levels:
        hit_mask = simulate_level(current, cfg, device=dev)
        hits = int(hit_mask.sum())  # repro-lint: disable=TS102 -- exact-LRU ground truth: one hit count per cache level
        misses = current.numel() - hits
        results.append(
            LevelResult(
                name=cfg.name,
                accesses=current.numel(),
                hits=hits,
                cumulative_hit_rate=1.0 - misses / max(total, 1),
            )
        )
        current = current[~hit_mask]
    return results
