"""Uniform family API: the ported families expose the reference's
batch-dict interface, so serving code is family-agnostic.

    fam = get_family("transformer")
    model = fam.init(cfg, device=device, seed=0)
    caches = fam.init_caches(cfg, batch_size, max_len, device=device)
    logits, caches = fam.prefill(model, batch, cfg, caches)
    logits, caches = fam.decode_step(model, batch, cfg, caches, length)

Mirrors ``repro/models/api.py`` for the ``transformer``, ``ssm`` and
``hybrid`` families.
``loss_fn`` (training) and ``cache_axes`` (sharding) are not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import hybrid, ssm
from repro_torch.models import transformer as tfm


class Family(NamedTuple):
    name: str
    init: Callable
    init_caches: Callable
    prefill: Callable
    decode_step: Callable


TRANSFORMER = Family(
    name="transformer",
    init=tfm.init,
    init_caches=tfm.init_caches,
    prefill=lambda p, batch, cfg, caches: tfm.prefill(
        p, batch["tokens"], cfg, caches
    ),
    decode_step=lambda p, batch, cfg, caches, length: tfm.decode_step(
        p, batch["token"], cfg, caches, length
    ),
)

SSM = Family(
    name="ssm",
    init=ssm.init,
    init_caches=ssm.init_caches,
    prefill=lambda p, batch, cfg, caches: ssm.prefill(
        p, batch["tokens"], cfg, caches
    ),
    decode_step=lambda p, batch, cfg, caches, length: ssm.decode_step(
        p, batch["token"], cfg, caches, length
    ),
)

HYBRID = Family(
    name="hybrid",
    init=hybrid.init,
    init_caches=hybrid.init_caches,
    prefill=lambda p, batch, cfg, caches: hybrid.prefill(
        p, batch["tokens"], cfg, caches
    ),
    decode_step=lambda p, batch, cfg, caches, length: hybrid.decode_step(
        p, batch["token"], cfg, caches, length
    ),
)

FAMILIES = {f.name: f for f in (TRANSFORMER, SSM, HYBRID)}
UNPORTED = ("encdec", "vlm")


def get_family(name: str) -> Family:
    if name in UNPORTED:
        raise NotImplementedError(
            f"the {name} family is not ported yet (ROADMAP A-11)")
    return FAMILIES[name]
