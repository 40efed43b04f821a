"""Deterministic synthetic data: every batch a pure function of (seed,
step), so a run replays bit for bit.  Port of ``repro/train/data.py``
(numpy draws, the reference's generator and order), returning tensors.

``specs`` maps each input's name to ``(shape, dtype)``
(``ArchSpec.input_shapes``).  Integer inputs are uniform token ids in
``[0, vocab)`` drawn as int32; float inputs are unit normals drawn in
float64 and rounded once to the input's dtype, which for float32 is
numpy's ``astype`` and for bfloat16 the reference's single rounding, so
a batch equals the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synthetic_batch(specs: dict, vocab: int, *, seed: int,
                    step: int) -> dict[str, torch.Tensor]:
    """A CPU batch matching ``specs``."""
    rng = _rng(seed, step)
    out = {}
    for name, (shape, dtype) in specs.items():
        if dtype.is_floating_point:
            arr = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
        else:
            arr = torch.from_numpy(rng.integers(
                0, vocab, size=shape, dtype=np.int32)).to(dtype)
        out[name] = arr
    return out


class SyntheticStream:
    """Replayable stream: ``stream.batch(step)`` for any step, any order."""

    def __init__(self, specs: dict, vocab: int, seed: int = 0):
        self.specs = specs
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        return synthetic_batch(self.specs, self.vocab, seed=self.seed,
                               step=step)
