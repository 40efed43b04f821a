"""Seeded weights, made by the benchmark and handed to both sides.

A family's reference declares its parameters in a schema: ``{name:
(shape, dtype, init)}``.  Each tensor is drawn in its own dtype, on the
device, by one in-place call with a generator seeded from the run's
seed and the parameter's name, so the reference can draw any layer again
after the window and get the same values bit for bit, without holding a
second copy of the weights.

``init`` is one of:

* ``("normal", std)``: ``N(0, std^2)``;
* ``("uniform", lo, hi)``;
* ``("log_uniform", lo, hi)``: ``log u`` for ``u`` uniform in ``[lo, hi]``
  (Mamba2's ``A_log``);
* ``("dt_bias", lo, hi)``: the inverse softplus of ``dt`` log-uniform in
  ``[lo, hi]`` (Mamba2's ``dt_bias``).
"""
from __future__ import annotations

import hashlib
import math

import torch


def name_seed(seed: int, name: str) -> int:
    """A 63-bit generator seed from the run's seed and a name."""
    digest = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def fill_(t: torch.Tensor, init: tuple, seed: int, name: str) -> torch.Tensor:
    """Draw ``t`` in place by ``init`` (module doc) from ``(seed, name)``."""
    gen = torch.Generator(device=t.device).manual_seed(name_seed(seed, name))
    kind = init[0]
    with torch.no_grad():
        if kind == "normal":
            t.normal_(0.0, float(init[1]), generator=gen)
        elif kind == "uniform":
            t.uniform_(float(init[1]), float(init[2]), generator=gen)
        elif kind == "log_uniform":
            t.uniform_(float(init[1]), float(init[2]), generator=gen).log_()
        elif kind == "dt_bias":
            t.uniform_(math.log(init[1]), math.log(init[2]), generator=gen)
            dt = t.exp()
            t.copy_(dt + torch.log(-torch.expm1(-dt)))
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
    return t


def make(schema: dict, name: str, seed: int, device) -> torch.Tensor:
    """The parameter ``name`` of ``schema``, drawn on ``device``."""
    shape, dtype, init = schema[name]
    t = torch.empty(shape, dtype=dtype, device=device)
    return fill_(t, init, seed, name)
