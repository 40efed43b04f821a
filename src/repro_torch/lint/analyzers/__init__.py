"""Analyzer registry: each family exposes ``analyze(ctx) -> [Finding]``."""
from __future__ import annotations

from repro_torch.lint.analyzers import (
    cache_keys,
    concurrency,
    donation,
    jax_purity,
    torch_sync,
)

ALL_ANALYZERS = (
    jax_purity.analyze,
    donation.analyze,
    concurrency.analyze,
    cache_keys.analyze,
    torch_sync.analyze,
)

__all__ = ["ALL_ANALYZERS", "jax_purity", "donation", "concurrency",
           "cache_keys", "torch_sync"]
