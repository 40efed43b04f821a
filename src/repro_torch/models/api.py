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

``cache_axes(cfg)`` returns a logical-axes tree parallel to the cache
tuple (tuples at leaf positions; the reference's, including its
``length`` entries, which the port holds as Python ints), for
:mod:`repro_torch.dist.sharding`.  A parameter's axes live on the
parameter itself: ``models/layers.py::param_axes(model)`` reads them
(from a model built on the meta device, which allocates nothing).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.models import attention as attn
from repro_torch.models import encdec, hybrid, multimodal, ssm
from repro_torch.models import transformer as tfm
from repro_torch.runtime.tracing import spanned

_prefill = spanned("model.prefill")     # every family's prefill


class Family(NamedTuple):
    name: str
    init: Callable
    init_caches: Callable
    prefill: Callable
    decode_step: Callable
    loss_fn: Callable
    cache_axes: Callable


_KV_AXES = ("layers", "act_batch", "act_kv_seq", "act_kv_heads", None)


def _kv_cache_axes(_cfg):
    return attn.KVCache(k=_KV_AXES, v=_KV_AXES, length=("layers",))


def _ssm_cache_axes(_cfg, lead=("layers",)):
    return ssm.SSMCache(
        conv_x=lead + ("act_batch", None, "act_mlp"),
        conv_b=lead + ("act_batch", None, None),
        conv_c=lead + ("act_batch", None, None),
        state=lead + ("act_batch", "act_heads", None, None),
        length=lead,
    )


def _hybrid_cache_axes(cfg: hybrid.Zamba2Config):
    ga = ("groups", "act_batch", "act_kv_seq", "act_kv_heads", None)
    return hybrid.HybridCache(
        groups=_ssm_cache_axes(None, lead=("groups", "layers")),
        trailing=_ssm_cache_axes(None) if cfg.trailing else None,
        attn=attn.KVCache(k=ga, v=ga, length=("groups",)),
        length=(),
    )


def _encdec_cache_axes(_cfg):
    return encdec.EncDecCache(
        self_kv=attn.KVCache(k=_KV_AXES, v=_KV_AXES, length=("layers",)),
        cross_k=_KV_AXES,
        cross_v=_KV_AXES,
        length=(),
    )


TRANSFORMER = Family(
    name="transformer",
    init=tfm.init,
    init_caches=tfm.init_caches,
    prefill=_prefill(lambda p, batch, cfg, caches: tfm.prefill(
        p, batch["tokens"], cfg, caches
    )),
    decode_step=lambda p, batch, cfg, caches, length: tfm.decode_step(
        p, batch["token"], cfg, caches, length
    ),
    loss_fn=tfm.loss_fn,
    cache_axes=_kv_cache_axes,
)

SSM = Family(
    name="ssm",
    init=ssm.init,
    init_caches=ssm.init_caches,
    prefill=_prefill(lambda p, batch, cfg, caches: ssm.prefill(
        p, batch["tokens"], cfg, caches
    )),
    decode_step=lambda p, batch, cfg, caches, length: ssm.decode_step(
        p, batch["token"], cfg, caches, length
    ),
    loss_fn=ssm.loss_fn,
    cache_axes=_ssm_cache_axes,
)

HYBRID = Family(
    name="hybrid",
    init=hybrid.init,
    init_caches=hybrid.init_caches,
    prefill=_prefill(lambda p, batch, cfg, caches: hybrid.prefill(
        p, batch["tokens"], cfg, caches
    )),
    decode_step=lambda p, batch, cfg, caches, length: hybrid.decode_step(
        p, batch["token"], cfg, caches, length
    ),
    loss_fn=hybrid.loss_fn,
    cache_axes=_hybrid_cache_axes,
)

ENCDEC = Family(
    name="encdec",
    init=encdec.init,
    init_caches=encdec.init_caches,
    prefill=_prefill(lambda p, batch, cfg, caches: encdec.prefill(
        p, batch["frames"], batch["tokens"], cfg, caches
    )),
    decode_step=lambda p, batch, cfg, caches, length: encdec.decode_step(
        p, batch["token"], cfg, caches, length
    ),
    loss_fn=encdec.loss_fn,
    cache_axes=_encdec_cache_axes,
)

VLM = Family(
    name="vlm",
    init=multimodal.init,
    init_caches=multimodal.init_caches,
    prefill=_prefill(lambda p, batch, cfg, caches: multimodal.prefill(
        p, batch["patches"], batch["tokens"], cfg, caches
    )),
    decode_step=lambda p, batch, cfg, caches, length: multimodal.decode_step(
        p, batch["token"], cfg, caches, length
    ),
    loss_fn=multimodal.loss_fn,
    cache_axes=lambda cfg: _kv_cache_axes(cfg.backbone),
)

FAMILIES = {f.name: f for f in (TRANSFORMER, SSM, HYBRID, ENCDEC, VLM)}


def get_family(name: str) -> Family:
    return FAMILIES[name]
