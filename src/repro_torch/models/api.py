"""Uniform family API: the ported families expose the reference's
batch-dict interface, so serving code is family-agnostic.

    fam = get_family("transformer")
    model = fam.init(cfg, device=device, seed=0)
    caches = fam.init_caches(cfg, batch_size, max_len, device=device)
    logits, caches = fam.prefill(model, batch, cfg, caches)
    logits, caches = fam.decode_step(model, batch, cfg, caches, length)
    loss = fam.loss_fn(model, batch, cfg)

Mirrors ``repro/models/api.py`` for all five families, with the
reference's batch keys: ``tokens`` for prefill (plus ``frames`` for
``encdec``, ``patches`` for ``vlm``), ``token`` for decode, and the
prefill keys plus ``labels`` for ``loss_fn``; the encdec family's
``init_caches`` also takes ``src_len``, and a vlm's ``max_len`` counts
its patch prefix.  ``prefill`` and ``decode_step`` (serving) run
without grad; ``loss_fn`` (training, ``repro_torch.train``) returns a
scalar with its autograd graph when the parameters require grad.
``cache_axes`` (sharding) is not ported.
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
    loss_fn: Callable


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
    loss_fn=tfm.loss_fn,
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
    loss_fn=ssm.loss_fn,
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
    loss_fn=hybrid.loss_fn,
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
    loss_fn=encdec.loss_fn,
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
    loss_fn=multimodal.loss_fn,
)

FAMILIES = {f.name: f for f in (TRANSFORMER, SSM, HYBRID, ENCDEC, VLM)}


def get_family(name: str) -> Family:
    return FAMILIES[name]
