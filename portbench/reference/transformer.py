"""Plain float32 reference of the decoder-only transformer family, as
Mixtral configures it (arXiv:2401.04088): pre-norm blocks of grouped
query attention with RoPE and an optional sliding window, then a
mixture of experts (softmax router, top-k, gates renormalised over the
chosen experts, SwiGLU experts) and/or a dense SwiGLU MLP; an untied
logits head.

Plain torch operations, imports nothing of the program.  The router
runs on the float32 normed hidden state; no token is dropped (serving).
The configuration is the dict of ``configs/<config>.json``.
"""
from __future__ import annotations

import torch

from portbench.reference.common import (
    Precision, attention, params, rmsnorm, rope, swiglu,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: Sizes at which the control (``control.py``) runs on the CPU in
#: seconds, deep and wide enough that its rounding grows through the
#: layers as at the cells' own sizes (``small.control_cell``).
CONTROL_SIZES = dict(layers=8, d_model=256, heads=8, kv_heads=2,
                     head_dim=32, d_ff=512, vocab=2048, window=128)


def padded_vocab(cfg: dict) -> int:
    m = cfg["vocab_pad_multiple"]
    return -(-cfg["vocab"] // m) * m


def layer_names(cfg: dict, i: int) -> list[str]:
    return [n for n in schema(cfg) if n.startswith(f"blocks.{i}.")]


def schema(cfg: dict) -> dict:
    """``{name: (shape, dtype, init)}`` of every parameter."""
    d, f, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    h, kvh = cfg["heads"], cfg["kv_heads"]
    dt, f32 = _DTYPES[cfg["dtype"]], torch.float32

    def fan(*shape, fan_in, dtype=dt):
        return (shape, dtype, ("normal", fan_in ** -0.5))

    norm = ((d,), dt, ("uniform", 0.5, 1.5))
    out = {"embed.table": ((padded_vocab(cfg), d), dt, ("normal", 1.0))}
    for i in range(cfg["layers"]):
        b = f"blocks.{i}"
        out.update({
            f"{b}.ln_attn.scale": norm,
            f"{b}.attn.wq": fan(d, h, hd, fan_in=d),
            f"{b}.attn.wk": fan(d, kvh, hd, fan_in=d),
            f"{b}.attn.wv": fan(d, kvh, hd, fan_in=d),
            f"{b}.attn.wo": fan(h, hd, d, fan_in=h * hd),
            f"{b}.ln_mlp.scale": norm,
        })
        if cfg.get("dense_ff", True):
            out.update({f"{b}.mlp.wi": fan(d, f, fan_in=d),
                        f"{b}.mlp.wg": fan(d, f, fan_in=d),
                        f"{b}.mlp.wo": fan(f, d, fan_in=f)})
        if cfg.get("moe"):
            e = cfg["moe"]["num_experts"]
            out.update({f"{b}.moe.router": fan(d, e, fan_in=d, dtype=f32),
                        f"{b}.moe.wi": fan(e, d, f, fan_in=d),
                        f"{b}.moe.wg": fan(e, d, f, fan_in=d),
                        f"{b}.moe.wo": fan(e, f, d, fan_in=f)})
    out["final_norm.scale"] = norm
    out["unembed.w"] = fan(d, padded_vocab(cfg), fan_in=d)
    return out


def moe(P: dict, b: str, x, cfg: dict, prec: Precision):
    """x ``[T, d]`` through the top-k experts, each pair weighted by its
    renormalised gate."""
    k = cfg["moe"]["top_k"]
    probs = torch.softmax(prec.mm(x, P[f"{b}.moe.router"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(cfg["moe"]["num_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], P[f"{b}.moe.wi"][e], P[f"{b}.moe.wg"][e],
                     P[f"{b}.moe.wo"][e], prec)
        y.index_add_(0, tok, out * gate[tok, choice, None])
    return y


def block(P: dict, i: int, x, cfg: dict, prec: Precision, keep=None):
    """Block ``i`` on one sequence x ``[1, S, d]``; ``keep`` (a dict)
    receives its keys (after RoPE) and values ``[1, S, Hkv, D]``."""
    b, eps = f"blocks.{i}", cfg["norm_eps"]
    h = rmsnorm(x, P[f"{b}.ln_attn.scale"], eps)
    pos = torch.arange(x.shape[1], device=x.device)
    theta = cfg["rope_theta"]
    q = rope(prec.mm(h, P[f"{b}.attn.wq"]), pos, theta)
    kk = rope(prec.mm(h, P[f"{b}.attn.wk"]), pos, theta)
    v = prec.mm(h, P[f"{b}.attn.wv"])
    if keep is not None:
        keep.update(k=kk, v=v)
    a = attention(q, kk, v, prec, window=cfg.get("window"))
    x = x + prec.mm(a.flatten(2), P[f"{b}.attn.wo"].flatten(0, 1))
    h = rmsnorm(x, P[f"{b}.ln_mlp.scale"], eps)
    y = torch.zeros_like(x)
    if cfg.get("dense_ff", True):
        y = y + swiglu(h, P[f"{b}.mlp.wi"], P[f"{b}.mlp.wg"],
                       P[f"{b}.mlp.wo"], prec)
    if cfg.get("moe"):
        y = y + moe(P, b, h.reshape(-1, h.shape[-1]), cfg,
                    prec).reshape(h.shape)
    return x + y


def state_heads(cfg: dict) -> int:
    """No recurrent state: the digest samples no heads."""
    return 0


@torch.no_grad()
def prefill(cfg: dict, seed: int, prompts: list, picks: list, device,
            prec: Precision) -> list[dict]:
    """For each prompt (int ``[B, L]``): the logits at its last position
    ``[B, vocab]`` and the keys and values ``[layers, B, npos, Hkv, D]``
    at its picked positions.  Layer by layer: each layer's weights are
    drawn again and widened once, and every prompt's rows go through it
    one sequence at a time."""
    sch = schema(cfg)
    emb = params(sch, ["embed.table"], seed, device)["embed.table"]
    xs = [[emb[torch.as_tensor(row, device=device).long()][None]
           for row in tokens] for tokens in prompts]
    del emb
    kv: list = [{"k": [], "v": []} for _ in prompts]
    for i in range(cfg["layers"]):
        P = params(sch, layer_names(cfg, i), seed, device)
        for r, pk in enumerate(picks):
            ks, vs = [], []
            for j, x in enumerate(xs[r]):
                keep: dict = {}
                xs[r][j] = block(P, i, x, cfg, prec, keep=keep)
                ks.append(keep["k"][0, pk["positions"]])
                vs.append(keep["v"][0, pk["positions"]])
            kv[r]["k"].append(torch.stack(ks))
            kv[r]["v"].append(torch.stack(vs))
        del P
    head = params(sch, ["final_norm.scale", "unembed.w"], seed, device)
    out = []
    for r in range(len(prompts)):
        last = torch.cat([x[:, -1] for x in xs[r]])          # [B, d]
        last = rmsnorm(last, head["final_norm.scale"], cfg["norm_eps"])
        out.append({"logits": prec.mm(last, head["unembed.w"])
                    [:, :cfg["vocab"]],
                    "digest": {n: torch.stack(kv[r][n]) for n in ("k", "v")}})
    return out
