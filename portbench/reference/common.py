"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program.  Every matrix product goes through a
:class:`Precision`: ``"f32"`` computes in float32 with TF32 off (the
reference), ``"fp8"`` rounds both operands of every product to
float8 e4m3 (one scale per tensor, from its largest magnitude) before
the float32 product (the control: the reference in the precision below
the configuration's bfloat16).  Under autograd the rounding passes the
gradient straight through, so the backward multiplies by the rounded
operands.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0       # largest finite float8 e4m3fn


def strict_f32() -> None:
    """No TF32 anywhere: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the precision holds an operand."""
        if self.name == "f32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        r = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (r - t.detach()) if t.requires_grad else r

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` over the last dim of x and the first of w (w may
        have further dims, flattened and restored)."""
        out = self.q(x) @ self.q(w.reshape(w.shape[0], -1))
        return out.reshape(*x.shape[:-1], *w.shape[1:])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x ``[B, S, H, D]`` rotated by halves at ``positions`` ``[S]``."""
    d = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = positions.float()[:, None] * freqs           # [S, D/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Precision, *, window=None, block: int = 512,
              remat: bool = False):
    """Causal softmax attention of q ``[B, S, H, D]`` over k, v ``[B, S,
    Hkv, D]`` (query head ``h`` reads kv head ``h // (H / Hkv)``); a
    query at ``i`` sees keys ``j <= i`` and, with a window, ``j > i -
    window``.  Queries in blocks of ``block`` rows (each checkpointed
    with ``remat``); returns ``[B, S, H, D]``."""
    b, s, h, d = q.shape
    rep = h // k.shape[2]
    kt = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)   # [B,H,D,S]
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2)       # [B,H,S,D]
    cols = torch.arange(s, device=q.device)

    def one(q0: int, qb):
        rows = torch.arange(q0, q0 + qb.shape[1], device=q.device)
        lo = 0 if window is None else max(0, q0 - window + 1)
        hi = q0 + qb.shape[1]
        scores = prec.q(qb.transpose(1, 2) * d ** -0.5) @ prec.q(
            kt[..., lo:hi])                                # [B,H,qb,hi-lo]
        c = cols[lo:hi]
        vis = c[None, :] <= rows[:, None]
        if window is not None:
            vis = vis & (c[None, :] > rows[:, None] - window)
        scores = scores.masked_fill(~vis, float("-inf"))
        p = torch.softmax(scores, dim=-1)
        return (prec.q(p) @ prec.q(vt[:, :, lo:hi])).transpose(1, 2)

    outs = []
    for q0 in range(0, s, block):
        qb = q[:, q0:q0 + block]
        if remat and torch.is_grad_enabled():
            outs.append(checkpoint(one, q0, qb, use_reentrant=False))
        else:
            outs.append(one(q0, qb))
    return torch.cat(outs, dim=1)


def swiglu(x, wi, wg, wo, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wi), wo)


def xent(logits: torch.Tensor, labels: torch.Tensor, zloss: float):
    """Sum over rows of cross-entropy and ``zloss`` times the squared
    log-sum-exp (the caller divides by the token count)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    return (lse - ll).sum() + zloss * (lse ** 2).sum()


def warmup_cosine(opt: dict, step: int) -> float:
    """The learning rate of 0-based ``step``: linear warmup over
    ``warmup`` steps, then a cosine to ``final_fraction`` of the peak at
    ``total_steps``."""
    peak, warm, total = opt["peak_lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return peak * (step + 1.0) / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    ff = opt["final_fraction"]
    return peak * (ff + (1 - ff) * 0.5 * (1 + math.cos(math.pi * frac)))


def adamw_step(p, g, m, v, opt: dict, step: int, store_dtype):
    """One AdamW update of f32 ``p`` in place from f32 gradient ``g``
    (0-based ``step``); the result rounded to ``store_dtype``, the dtype
    the configuration keeps the parameter in, and back to f32."""
    b1, b2 = opt["b1"], opt["b2"]
    t = step + 1.0
    m.mul_(b1).add_(g, alpha=1 - b1)
    v.mul_(b2).addcmul_(g, g, value=1 - b2)
    upd = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + opt["eps"])
    upd = upd + opt["weight_decay"] * p
    p.sub_(warmup_cosine(opt, step) * upd)
    p.copy_(p.to(store_dtype).float())


def params(schema: dict, names, seed: int, device, *,
           requires_grad: bool = False) -> dict:
    """``{name: float32 tensor}``: each parameter drawn again from the
    run's seed in its own dtype (``portbench.weights``), then widened."""
    from portbench import weights

    out = {}
    for n in names:
        t = weights.make(schema, n, seed, device).float()
        out[n] = t.requires_grad_() if requires_grad else t
    return out


def leaf(name: str) -> str:
    """A parameter's leaf: its dotted name without layer indices."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def leaf_norms(tensors: dict) -> dict:
    """``{leaf: norm}`` over the parameters of each leaf, as floats."""
    sq: dict = {}
    for n, t in tensors.items():
        sq[leaf(n)] = sq.get(leaf(n), 0.0) + float(t.double().pow(2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}
