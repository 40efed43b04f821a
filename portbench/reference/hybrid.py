"""Plain float32 reference of the hybrid family (Zamba2): a Mamba2
backbone with one shared attention block, applied before every group of
``attn_every`` Mamba2 layers on ``concat(hidden, embedding)``; the
embedding is also the logits head.

Written from the published description (arXiv:2411.15242, and Mamba2's
state-space duality, arXiv:2405.21060) in plain torch operations.  It
imports nothing of the program.  Departures and choices, as the
configuration states them: RMSNorm everywhere with a learned scale;
RoPE by halves in the shared attention; one shared block without
per-site adapters; the SSD scan is the chunked form of the recurrence
``h_t = exp(la_t) h_{t-1} + b_t x_t^T``, ``y_t = c_t^T h_t``.

The configuration is the dict of ``configs/<config>.json``.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (
    Precision, adamw_step, attention, leaf_norms, params, rmsnorm, rope,
    swiglu, xent,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: Sizes at which the control (``control.py``) runs on the CPU in
#: seconds, deep and wide enough that its rounding grows through the
#: layers as at the cells' own sizes (``small.control_cell``).
CONTROL_SIZES = dict(layers=12, d_model=128, heads=4, kv_heads=4,
                     head_dim=32, d_ff=256, ssm_state=16, vocab=2048)


def _dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg["expand"] * d
    return dict(d=d, di=di, n=cfg["ssm_state"], p=cfg["head_dim"],
                h=di // cfg["head_dim"], w=cfg["conv_width"],
                groups=cfg["layers"] // cfg["attn_every"],
                trailing=cfg["layers"] % cfg["attn_every"],
                vp=-(-cfg["vocab"] // cfg["vocab_pad_multiple"])
                * cfg["vocab_pad_multiple"])


def mamba_layers(cfg: dict) -> list[str]:
    """The Mamba2 layers' name prefixes, in the order they run."""
    k = _dims(cfg)
    return ([f"groups.{g}.{i}" for g in range(k["groups"])
             for i in range(cfg["attn_every"])]
            + [f"trailing.{i}" for i in range(k["trailing"])])


def schema(cfg: dict) -> dict:
    """``{name: (shape, dtype, init)}`` of every parameter."""
    k = _dims(cfg)
    d, di, n, h, w = k["d"], k["di"], k["n"], k["h"], k["w"]
    dt, f32 = _DTYPES[cfg["dtype"]], torch.float32
    hd, heads, kvh = cfg["head_dim"], cfg["heads"], cfg["kv_heads"]

    def fan(*shape, fan_in, dtype=dt):
        return (shape, dtype, ("normal", fan_in ** -0.5))

    def norm(size):
        return ((size,), dt, ("uniform", 0.5, 1.5))

    out = {"embed.table": ((k["vp"], d), dt, ("normal", 1.0))}
    for pre in mamba_layers(cfg):
        out.update({
            f"{pre}.ln.scale": norm(d),
            f"{pre}.wz": fan(d, di, fan_in=d),
            f"{pre}.wx": fan(d, di, fan_in=d),
            f"{pre}.wB": fan(d, n, fan_in=d),
            f"{pre}.wC": fan(d, n, fan_in=d),
            f"{pre}.wdt": fan(d, h, fan_in=d, dtype=f32),
            f"{pre}.conv_x": fan(w, di, fan_in=w),
            f"{pre}.conv_b": fan(w, n, fan_in=w),
            f"{pre}.conv_c": fan(w, n, fan_in=w),
            f"{pre}.A_log": ((h,), f32, ("log_uniform", 1.0, 16.0)),
            f"{pre}.D": ((h,), f32, ("uniform", 0.5, 1.5)),
            f"{pre}.dt_bias": ((h,), f32, ("dt_bias", 1e-3, 1e-1)),
            f"{pre}.ln_gate.scale": norm(di),
            f"{pre}.wo": fan(di, d, fan_in=di),
        })
    out.update({
        "shared.w_cat": fan(2 * d, d, fan_in=2 * d),
        "shared.ln_attn.scale": norm(d),
        "shared.attn.wq": fan(d, heads, hd, fan_in=d),
        "shared.attn.wk": fan(d, kvh, hd, fan_in=d),
        "shared.attn.wv": fan(d, kvh, hd, fan_in=d),
        "shared.attn.wo": fan(heads, hd, d, fan_in=heads * hd),
        "shared.ln_mlp.scale": norm(d),
        "shared.mlp.wi": fan(d, cfg["d_ff"], fan_in=d),
        "shared.mlp.wg": fan(d, cfg["d_ff"], fan_in=d),
        "shared.mlp.wo": fan(cfg["d_ff"], d, fan_in=cfg["d_ff"]),
        "final_norm.scale": norm(d),
    })
    return out


def ssd(x, la, b, c, prec: Precision, chunk: int = 64):
    """The SSD recurrence from a zero state, in chunks: x ``[B, S, H, P]``,
    la ``[B, S, H]`` (log decays), b, c ``[B, S, N]``.  Returns y ``[B,
    S, H, P]`` and the final state ``[B, H, N, P]``."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    pad = -s % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    cs = torch.cumsum(la.reshape(bsz, nc, chunk, h), dim=2)   # [B,C,L,H]
    tril = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # [B,C,i,j,H]
    decay = seg.masked_fill(~tril[None, None, :, :, None],
                            float("-inf")).exp()
    scores = (prec.q(cc) @ prec.q(bc).transpose(-1, -2))[..., None] * decay
    y = torch.einsum("bcijh,bcjhp->bcihp", prec.q(scores), prec.q(xc))
    wlast = (cs[:, :, -1:, :] - cs).exp()                        # [B,C,L,H]
    st = torch.einsum("bcjn,bcjhp->bchnp", prec.q(bc),
                      prec.q(xc * wlast[..., None]))
    state = torch.zeros(bsz, h, n, p, dtype=x.dtype, device=x.device)
    entering = []
    for i in range(nc):
        entering.append(state)
        state = cs[:, i, -1, :, None, None].exp() * state + st[:, i]
    hin = torch.stack(entering, dim=1)                           # [B,C,H,N,P]
    y = y + torch.einsum("bcin,bchnp->bcihp", prec.q(cc),
                         prec.q(hin)) * cs.exp()[..., None]
    return y.reshape(bsz, s + pad, h, p)[:, :s], state


def _conv(x, kernel, prec: Precision):
    """Causal depthwise conv of x ``[B, S, C]`` by ``kernel [W, C]`` (the
    last tap on the current step); also the last ``W - 1`` inputs."""
    w = kernel.shape[0]
    xp = F.pad(x, (0, 0, w - 1, 0))
    s = x.shape[1]
    y = sum(prec.q(xp[:, i:i + s]) * prec.q(kernel[i]) for i in range(w))
    return y, xp[:, -(w - 1):]


def mamba_block(P: dict, pre: str, x, cfg: dict, prec: Precision,
                keep=None):
    """One pre-norm Mamba2 block; ``keep`` (a dict) receives the final
    state and the conv inputs' tails."""
    k = _dims(cfg)
    eps = cfg["norm_eps"]
    hin = rmsnorm(x, P[f"{pre}.ln.scale"], eps)
    z = prec.mm(hin, P[f"{pre}.wz"])
    xs, tx = _conv(prec.mm(hin, P[f"{pre}.wx"]), P[f"{pre}.conv_x"], prec)
    bb, tb = _conv(prec.mm(hin, P[f"{pre}.wB"]), P[f"{pre}.conv_b"], prec)
    cc, tc = _conv(prec.mm(hin, P[f"{pre}.wC"]), P[f"{pre}.conv_c"], prec)
    dt = F.softplus(prec.mm(hin, P[f"{pre}.wdt"]) + P[f"{pre}.dt_bias"])
    xs, bb, cc = F.silu(xs), F.silu(bb), F.silu(cc)
    bsz, s, _ = xs.shape
    xh = xs.reshape(bsz, s, k["h"], k["p"])
    la = -torch.exp(P[f"{pre}.A_log"]) * dt
    y, final = ssd(xh * dt[..., None], la, bb, cc, prec)
    y = y + P[f"{pre}.D"][:, None] * xh
    y = y.reshape(bsz, s, k["di"]) * F.silu(z)
    y = rmsnorm(y, P[f"{pre}.ln_gate.scale"], eps)
    if keep is not None:
        keep.update(state=final, conv_x=tx, conv_b=tb, conv_c=tc)
    return x + prec.mm(y, P[f"{pre}.wo"])


def shared_block(P: dict, x, x0, cfg: dict, prec: Precision, *,
                 remat: bool = False, keep=None):
    """The shared attention block at one site; ``keep`` receives its
    keys (after RoPE) and values ``[B, S, Hkv, D]``."""
    eps = cfg["norm_eps"]
    h = prec.mm(torch.cat([x, x0], dim=-1), P["shared.w_cat"])
    h = rmsnorm(h, P["shared.ln_attn.scale"], eps)
    pos = torch.arange(x.shape[1], device=x.device)
    theta = cfg["rope_theta"]
    q = rope(prec.mm(h, P["shared.attn.wq"]), pos, theta)
    kk = rope(prec.mm(h, P["shared.attn.wk"]), pos, theta)
    v = prec.mm(h, P["shared.attn.wv"])
    if keep is not None:
        keep.update(k=kk, v=v)
    a = attention(q, kk, v, prec, remat=remat)
    x = x + prec.mm(a.flatten(2), P["shared.attn.wo"].flatten(0, 1))
    m = rmsnorm(x, P["shared.ln_mlp.scale"], eps)
    return x + swiglu(m, P["shared.mlp.wi"], P["shared.mlp.wg"],
                      P["shared.mlp.wo"], prec)


def hidden(P: dict, tokens, cfg: dict, prec: Precision, *,
           remat: bool = False, keep=None):
    """The final-normed hidden states ``[B, S, d]``.  With ``remat``
    (training) each Mamba2 layer and each attention block of queries is
    checkpointed.  ``keep`` (a dict) receives ``attn.<g>`` and each
    Mamba2 layer's prefix -> what its block keeps."""
    x = P["embed.table"][tokens.long()]
    x0 = x

    def run(fn, *args, **kw):
        if remat and torch.is_grad_enabled():
            return checkpoint(lambda *a: fn(*a, **kw), *args,
                              use_reentrant=False)
        return fn(*args, **kw)

    layers = iter(mamba_layers(cfg))
    for g in range(_dims(cfg)["groups"]):
        site = None if keep is None else keep.setdefault(f"attn.{g}", {})
        x = shared_block(P, x, x0, cfg, prec, remat=remat, keep=site)
        for _ in range(cfg["attn_every"]):
            pre = next(layers)
            kept = None if keep is None else keep.setdefault(pre, {})
            x = run(mamba_block, P, pre, x, cfg, prec, keep=kept)
    for pre in layers:
        kept = None if keep is None else keep.setdefault(pre, {})
        x = run(mamba_block, P, pre, x, cfg, prec, keep=kept)
    return rmsnorm(x, P["final_norm.scale"], cfg["norm_eps"])


def logits(P: dict, x, cfg: dict, prec: Precision):
    """Tied logits of hidden states x, the padded ids masked off."""
    out = prec.mm(x, P["embed.table"].T)
    return out[..., :cfg["vocab"]]


def loss(P: dict, tokens, labels, cfg: dict, prec: Precision):
    """Mean cross-entropy plus z-loss, each row's logits checkpointed."""
    x = hidden(P, tokens, cfg, prec, remat=True)
    total = 0.0
    for r in range(x.shape[0]):
        total = total + checkpoint(
            lambda xr, lr: xent(logits(P, xr, cfg, prec), lr, cfg["zloss"]),
            x[r], labels[r], use_reentrant=False)
    return total / labels.numel()


def state_heads(cfg: dict) -> int:
    """SSD heads a layer holds state for (the digest samples some)."""
    return _dims(cfg)["h"]


def _digest(keep: dict, cfg: dict, picks: dict) -> dict:
    """The cache at the picked positions and heads: keys and values
    ``[G, B, npos, Hkv, D]``, SSD states ``[M, B, nheads, N, P]`` and
    conv tails ``[M, B, W - 1, C]`` (of x only the picked heads'
    channels), M the Mamba2 layers in order."""
    pos, heads, p = picks["positions"], picks["heads"], cfg["head_dim"]
    chans = [h * p + i for h in heads for i in range(p)]
    sites = [keep[f"attn.{g}"] for g in range(_dims(cfg)["groups"])]
    layers = [keep[pre] for pre in mamba_layers(cfg)]
    return {
        "k": torch.stack([s["k"][:, pos] for s in sites]),
        "v": torch.stack([s["v"][:, pos] for s in sites]),
        "state": torch.stack([m["state"][:, heads] for m in layers]),
        "conv_x": torch.stack([m["conv_x"][..., chans] for m in layers]),
        "conv_b": torch.stack([m["conv_b"] for m in layers]),
        "conv_c": torch.stack([m["conv_c"] for m in layers]),
    }


@torch.no_grad()
def prefill(cfg: dict, seed: int, prompts: list, picks: list, device,
            prec: Precision) -> list[dict]:
    """For each prompt (int ``[B, L]``): the logits at its last position
    ``[B, vocab]`` and the cache digest at its picks."""
    sch = schema(cfg)
    P = params(sch, sch, seed, device)
    out = []
    for tokens, pk in zip(prompts, picks):
        keep: dict = {}
        x = hidden(P, torch.as_tensor(tokens, device=device), cfg, prec,
                   keep=keep)
        out.append({"logits": logits(P, x[:, -1], cfg, prec),
                    "digest": _digest(keep, cfg, pk)})
        del keep, x
    return out


def train(cfg: dict, opt: dict, seed: int, batches: list, device,
          prec: Precision) -> dict:
    """The first ``len(batches)`` AdamW steps from the seeded weights,
    each gradient clipped to global norm ``opt["grad_clip"]`` and each
    update kept in the parameter's own dtype.  Returns every step's loss,
    the first step's gradient norm before clipping, the clipped first
    gradient's norm by leaf (what the optimizer gets) and the norm of
    each leaf's change over all the steps."""
    sch = schema(cfg)
    P = params(sch, sch, seed, device, requires_grad=True)
    p0 = {n: t.detach().clone() for n, t in P.items()}
    m = {n: torch.zeros_like(t) for n, t in P.items()}
    v = {n: torch.zeros_like(t) for n, t in P.items()}
    losses, first = [], {}
    for step, (tokens, labels) in enumerate(batches):
        tok = torch.as_tensor(tokens, device=device)
        lab = torch.as_tensor(labels, device=device)
        lval = loss(P, tok, lab, cfg, prec)
        grads = torch.autograd.grad(lval, list(P.values()))
        losses.append(float(lval.detach()))
        del lval
        with torch.no_grad():
            gnorm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
            scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            for (n, p), g in zip(P.items(), grads):
                g = g * scale
                if step == 0:
                    first[n] = g
                adamw_step(p.data, g, m[n], v[n], opt, step, sch[n][1])
            if step == 0:
                first = leaf_norms(first)
                gnorm0 = float(gnorm)
        del grads
    change = leaf_norms({n: P[n].detach() - p0[n] for n in P})
    return {"losses": losses, "grad_norm": gnorm0, "grad_leaves": first,
            "change_leaves": change}
