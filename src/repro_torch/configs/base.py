"""ArchSpec: binds a model family and its exact config to the shapes it
serves, the sharding-rule overrides (``rules``, ``serve_rules``,
``opt_rules``; :mod:`repro_torch.dist.sharding`), the skipped shapes and
the training knobs (grad accumulation, its dtype, the optimizer and its
peak learning rate).  Mirrors ``repro/configs/base.py`` field for field.
In place of the reference's abstract input specs (``ShapeDtypeStruct``)
:meth:`ArchSpec.input_shapes` gives ``(shape, dtype)`` pairs and
:meth:`ArchSpec.example_inputs` concrete tensors of them, drawn from a
seed.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.models.api import Family, get_family


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = Shape("train_4k", 4096, 256, "train")
PREFILL_32K = Shape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = Shape("decode_32k", 32768, 128, "decode")
LONG_500K = Shape("long_500k", 524288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

FULL_ATTN_SKIP = (
    "pure full attention — long_500k requires sub-quadratic attention "
    "(DESIGN.md §4); decode over a 512k KV cache would be O(S) per token "
    "with an O(S) resident cache"
)


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family_name: str
    config: Any
    rules: dict[str, str | None] = dataclasses.field(default_factory=dict)
    serve_rules: dict[str, str | None] = dataclasses.field(default_factory=dict)
    grad_accum: dict[str, int] = dataclasses.field(default_factory=dict)
    accum_dtype: torch.dtype = torch.float32
    optimizer_name: str = "adamw"
    peak_lr: float = 3e-4
    skip: dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""
    # MODEL_FLOPS accounting: fraction of shape.seq_len each parameter
    # actually processes (enc-dec splits seq_len into src/tgt halves)
    flops_token_factor: float = 1.0
    # optimizer-state sharding rules may differ from the parameter rules
    opt_rules: dict[str, str | None] = dataclasses.field(default_factory=dict)

    @property
    def family(self) -> Family:
        return get_family(self.family_name)

    @property
    def vocab(self) -> int:
        """The config's vocabulary, or its backbone's (a VLM)."""
        cfg = self.config
        return getattr(cfg, "vocab", None) or cfg.backbone.vocab

    def shapes(self) -> list[Shape]:
        return [s for s in SHAPES.values() if s.name not in self.skip]

    def rules_for(self, kind: str) -> dict[str, str | None]:
        """The rule overrides of a step kind: ``rules``, and for serving
        (``prefill``, ``decode``) ``serve_rules`` over them."""
        merged = dict(self.rules)
        if kind != "train":
            merged.update(self.serve_rules)
        return merged

    def input_shapes(self, shape: Shape) -> dict[str, tuple]:
        """``name -> (shape, dtype)`` of the step's batch: the reference's
        ``input_specs``.  An encoder-decoder takes ``S/2`` frames and
        ``S/2`` tokens, a VLM its patches and ``S - num_patches`` tokens;
        decode takes one token.  ``labels`` only for ``train``."""
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "decode":
            return {"token": ((b, 1), i32)}
        if self.family_name == "encdec":
            n = s // 2
            out = {"frames": ((b, n, self.config.d_model), self.config.dtype),
                   "tokens": ((b, n), i32)}
        elif self.family_name == "vlm":
            cfg = self.config
            n = s - cfg.num_patches
            out = {"patches": ((b, cfg.num_patches, cfg.clip_dim),
                               cfg.backbone.dtype),
                   "tokens": ((b, n), i32)}
        else:
            n = s
            out = {"tokens": ((b, n), i32)}
        if shape.kind == "train":
            out["labels"] = ((b, n), i32)
        return out

    def batch_axes(self, shape: Shape) -> dict[str, tuple]:
        """Logical axes of each batch input: ``act_batch`` on its first
        dimension, the rest replicated."""
        return {name: ("act_batch",) + (None,) * (len(dims) - 1)
                for name, (dims, _) in self.input_shapes(shape).items()}

    def example_inputs(self, shape: Shape, *,
                       seed: int = 0) -> dict[str, torch.Tensor]:
        """Concrete tensors of :meth:`input_shapes` on the CPU, drawn from
        ``seed``: ids uniform in the vocabulary, floats standard normal."""
        rng = np.random.default_rng(seed)
        out = {}
        for name, (dims, dtype) in self.input_shapes(shape).items():
            if dtype == torch.int32:
                arr = rng.integers(0, self.vocab, size=dims, dtype=np.int32)
            else:
                arr = rng.standard_normal(dims, dtype=np.float32)
            out[name] = torch.from_numpy(arr).to(dtype)
        return out

    def cache_kwargs(self, shape: Shape) -> dict[str, int]:
        """``init_caches`` keywords for the shape (the reference's): an
        encoder-decoder's caches hold ``S/2`` target and ``S/2`` source
        positions, every other family's ``S`` (a VLM's count its
        patches)."""
        b, s = shape.global_batch, shape.seq_len
        if self.family_name == "encdec":
            return {"batch": b, "max_len": s // 2, "src_len": s // 2}
        return {"batch": b, "max_len": s}

    def grad_accum_for(self, shape: Shape) -> int:
        return self.grad_accum.get(shape.name, 1)
