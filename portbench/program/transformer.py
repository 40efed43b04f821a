"""Reading the transformer family's prefill caches (``KVCache``, ``k``
and ``v`` ``[layers, B, max_len, Hkv, D]``) at a request's picked
positions, in the layout of ``reference/transformer.py``'s digest."""
from __future__ import annotations

import torch


def digest(caches, picks: dict) -> dict:
    """Keys and values ``[layers, B, npos, Hkv, D]``."""
    pos = torch.as_tensor(picks["positions"], device=caches.k.device)
    return {"k": caches.k[:, :, pos], "v": caches.v[:, :, pos]}
