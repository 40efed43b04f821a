"""ArchSpec: binds a model family and its exact config to the shapes it
serves.  Mirrors ``repro/configs/base.py`` without the abstract input
specs (``ShapeDtypeStruct``) and the sharding rules: the port runs on
one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models.api import Family, get_family


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family_name: str
    config: Any
    notes: str = ""

    @property
    def family(self) -> Family:
        return get_family(self.family_name)

    @property
    def vocab(self) -> int:
        """The config's vocabulary, or its backbone's (a VLM)."""
        cfg = self.config
        return getattr(cfg, "vocab", None) or cfg.backbone.vocab
