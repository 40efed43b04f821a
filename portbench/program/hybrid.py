"""Reading the hybrid family's prefill caches (``HybridCache``) at a
request's picked positions and heads, in the layout of
``reference/hybrid.py``'s digest."""
from __future__ import annotations

import torch


def digest(caches, picks: dict) -> dict:
    """Keys and values ``[G, B, npos, Hkv, D]``, the picked heads' SSD
    states ``[M, B, nheads, N, P]`` and conv tails ``[M, B, W - 1, C]``
    (of x only the picked heads' channels), M the Mamba2 layers: the
    groups' in order, then the trailing ones."""
    dev = caches.attn.k.device
    pos = torch.as_tensor(picks["positions"], device=dev)
    heads = torch.as_tensor(picks["heads"], device=dev)
    p = caches.groups.state.shape[-1]
    chans = (heads[:, None] * p + torch.arange(p, device=dev)).flatten()

    def layers(name):
        t = getattr(caches.groups, name).flatten(0, 1)
        if caches.trailing is not None:
            t = torch.cat([t, getattr(caches.trailing, name)])
        return t

    return {"k": caches.attn.k[:, :, pos], "v": caches.attn.v[:, :, pos],
            "state": layers("state")[:, :, heads],
            "conv_x": layers("conv_x")[..., chans],
            "conv_b": layers("conv_b").clone(),
            "conv_c": layers("conv_c").clone()}
