"""Uniform family API: the ported families expose the reference's
batch-dict interface, so serving code is family-agnostic.

    fam = get_family("transformer")
    model = fam.init(cfg, device=device, seed=0)
    caches = fam.init_caches(cfg, batch_size, max_len, device=device)
    logits, caches = fam.prefill(model, batch, cfg, caches)
    logits, caches = fam.decode_step(model, batch, cfg, caches, length)

Mirrors ``repro/models/api.py`` for all five families, with the
reference's batch keys: ``tokens`` for prefill (plus ``frames`` for
``encdec``, ``patches`` for ``vlm``) and ``token`` for decode; the
encdec family's ``init_caches`` also takes ``src_len``, and a vlm's
``max_len`` counts its patch prefix.
``loss_fn`` (training) and ``cache_axes`` (sharding) are not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import encdec, hybrid, multimodal, ssm
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

ENCDEC = Family(
    name="encdec",
    init=encdec.init,
    init_caches=encdec.init_caches,
    prefill=lambda p, batch, cfg, caches: encdec.prefill(
        p, batch["frames"], batch["tokens"], cfg, caches
    ),
    decode_step=lambda p, batch, cfg, caches, length: encdec.decode_step(
        p, batch["token"], cfg, caches, length
    ),
)

VLM = Family(
    name="vlm",
    init=multimodal.init,
    init_caches=multimodal.init_caches,
    prefill=lambda p, batch, cfg, caches: multimodal.prefill(
        p, batch["patches"], batch["tokens"], cfg, caches
    ),
    decode_step=lambda p, batch, cfg, caches, length: multimodal.decode_step(
        p, batch["token"], cfg, caches, length
    ),
)

FAMILIES = {f.name: f for f in (TRANSFORMER, SSM, HYBRID, ENCDEC, VLM)}


def get_family(name: str) -> Family:
    return FAMILIES[name]
