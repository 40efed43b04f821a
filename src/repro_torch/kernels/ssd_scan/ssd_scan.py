"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU's
``repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel``.  Per (batch, head)
the recurrence

    h_t = exp(la_t) h_{t-1} + b_t x_t^T        (state [N, P], f32)
    y_t = c_t^T h_t

is computed in chunks of :data:`CHUNK` steps: intra-chunk
``(c b^T) * exp(s_i - s_j)`` (``j <= i``) times x, plus ``exp(s) (c
h_in)``, and the state carried from chunk to chunk, with ``s`` the
inclusive cumulative sum of ``la`` inside the chunk.  The chunk length
only changes rounding; the TPU kernel's ``chunk`` and the models'
``Mamba2Config.chunk`` do not reach the port's kernel, which tiles at
64 steps so that the state and a chunk fit in shared memory at N = 128.
A ragged last chunk is padded with zeros, which leaves the result exact,
so any sequence length works (a prime one too).

Beyond ``_ssd_kernel``, :func:`ssd_scan` starts from an optional ``h0``
and returns the final state as well (``models/ssm.py::ssd_chunked``'s
``state0`` and ``final``, which the serving caches need).

Layouts, as the model holds them (read through strides, not copied):
x ``[B, S, H, P]`` (f32 or bf16), la ``[B, S, H]`` f32, b and c ``[B, S,
N]`` shared by the H heads (f32 or bf16, both the same; the kernel and
the plain version widen bf16 to f32, which is exact), h0 ``[B, H, N,
P]`` f32.  Returns y ``[B, S, H, P]`` in x's dtype and the final state
``[B, H, N, P]`` f32.  The TPU signature (x ``[BH, S, P]``, la ``[BH,
S]``, b, c ``[BH, S, N]``) is the case H = 1: ``x[:, :, None]``,
``la[..., None]``.

A wrapper given CPU tensors returns the plain version
(:func:`ssd_scan_plain`); given CUDA tensors it launches the kernel and
counts the launch in :data:`LAUNCHES`, or raises.  Given meta tensors
(an abstract step: the dry-run) it is one op, ``repro_torch::ssd_scan``,
with the kernel's result shapes, which a recording counts as the
kernel's work (:func:`scan_ops`); nothing is launched or counted.  With grad enabled
and an input that requires grad, the call goes through an
``autograd.Function`` (:class:`_SSDScan`): its forward is the same
launch (or, on the CPU, the plain version), so a kernel output always
carries its autograd history.  Its backward dispatches by device as the
forward does (the JAX package trains through jnp autodiff; its Pallas
kernel has no VJP): on the card the backward kernel
(``csrc/ssd_scan_bwd.cu``, counted in ``LAUNCHES["ssd_scan_bwd"]``, whose
algorithm :func:`ssd_scan_bwd_plain` spells out in torch ops); on meta one
op, ``repro_torch::ssd_scan_bwd`` (:func:`scan_bwd_ops`), with the
kernel's f32 scratch allocated across it as on the card; on the CPU
autograd through :func:`ssd_scan_plain`, the plain version recomputed and
differentiated.  A launch is two
kernels: C B^T of every (batch, chunk), which does not depend on the
head, into f32 scratch that the wrapper allocates; then the scan, which
splits the state's P columns across blocks, 64 per block while N <= 64,
else 32 (the last block of a row masks the columns past P).  N is at
most :data:`MAX_N`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import META_OPS, build, count_launch

#: Kernel launches; only the wrappers' launches add to it (the backward's
#: under ``ssd_scan_bwd``).
LAUNCHES = {"ssd_scan": 0, "ssd_scan_bwd": 0}

#: Steps per chunk, in the kernel (csrc/ssd_scan.cu kChunk) and the plain
#: version alike.
CHUNK = 64
#: Largest state size N the kernel takes (csrc/ssd_scan.cu kMaxN).
MAX_N = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x, la, b, c, h0):
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = {"la": (la, (bsz, s, h)), "b": (b, (bsz, s, n)),
            "c": (c, (bsz, s, n))}
    if h0 is not None:
        want["h0"] = (h0, (bsz, h, n, p))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if name in ("b", "c"):
            if t.dtype not in _DTYPES:
                raise TypeError(f"{name} must be float32 or bfloat16, got "
                                f"{t.dtype}")
        elif t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if b.dtype != c.dtype:
        raise TypeError(f"b and c dtypes differ: {b.dtype}, {c.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    if h0 is not None and not h0.is_contiguous():
        raise ValueError("h0 must be contiguous")
    return bsz, s, h, p, n


# --- plain PyTorch version ---------------------------------------------------


def ssd_scan_plain(x, la, b, c, h0=None):
    """The kernel's chunked algorithm in torch ops: a loop over chunks of
    :data:`CHUNK` steps, zero-padded at the end, f32 throughout."""
    bsz, s, h, p, n = _check_args(x, la, b, c, h0)
    pad = -s % CHUNK
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
    laf = torch.nn.functional.pad(la, (0, 0, 0, pad))
    bf = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    cf = torch.nn.functional.pad(c.float(), (0, 0, 0, pad))
    state = (torch.zeros(bsz, h, n, p, dtype=torch.float32, device=x.device)
             if h0 is None else h0.clone())
    tril = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=x.device).tril()
    ys = []
    for c0 in range(0, s + pad, CHUNK):
        xk = xf[:, c0:c0 + CHUNK]                         # [B,L,H,P]
        bk, ck = bf[:, c0:c0 + CHUNK], cf[:, c0:c0 + CHUNK]  # [B,L,N]
        sk = torch.cumsum(laf[:, c0:c0 + CHUNK], dim=1)  # [B,L,H]
        diff = sk[:, :, None, :] - sk[:, None, :, :]     # [B,L,L,H]
        decay = diff.masked_fill(~tril[None, :, :, None], float("-inf")).exp()
        scores = (ck @ bk.transpose(1, 2))[..., None] * decay
        y = torch.einsum("bijh,bjhp->bihp", scores, xk)
        y = y + sk.exp()[..., None] * torch.einsum("bin,bhnp->bihp", ck,
                                                    state)
        ys.append(y)
        s_last = sk[:, -1]                                # [B,H]
        w = (s_last[:, None, :] - sk).exp()               # [B,L,H]
        state = s_last.exp()[:, :, None, None] * state + torch.einsum(
            "bjn,bjh,bjhp->bhnp", bk, w, xk)
    y = torch.cat(ys, dim=1)[:, :s]
    return y.to(x.dtype), state


def scan_ops(bsz: int, s: int, h: int, p: int, n: int) -> float:
    """The kernel's operations: per chunk of ``lc`` steps the lc(lc+1)/2
    score pairs times N (C B^T, once per batch row: it does not depend on
    the head) and, per head, times P (scores · x), and lc·N·P twice per
    head (C h_in and the state update); two per multiply-add."""
    total = 0.0
    for c0 in range(0, s, CHUNK):
        lc = min(CHUNK, s - c0)
        total += 2.0 * (lc * (lc + 1) / 2 * (n + h * p)
                        + 2.0 * h * lc * n * p)
    return total * bsz


def ssd_scan_bwd_plain(x, la, b, c, h0, dy, dfinal):
    """The backward kernel's algorithm in torch ops, f32, phase by phase:
    the gradients ``(dx, dla, db, dc, dh0)`` of :func:`ssd_scan_plain`'s
    outputs for ``dy`` (y's gradient, None for zero) and ``dfinal`` (the
    final state's, None for zero); dh0 is None when h0 is.  With ``s`` the
    in-chunk cumsum of la, ``a = e^{s_last}`` and ``w = e^{s_last - s}``:
    (1) every chunk's increments ``U = sum_j w_j b_j x_j^T`` and ``V =
    sum_i e^{s_i} c_i dy_i^T``; (2) the forward pass over chunks for the
    states entering them (``H_{c+1} = a_c H_c + U_c`` from h0) and the
    reverse pass for the gradients of the states leaving them
    (``G_{c-1} = a_c G_c + V_c`` from dfinal; dh0 is the last); (3) every
    chunk's gradients from its H and G alone (``csrc/ssd_scan_bwd.cu``
    states each term).  Returned in the inputs' dtypes."""
    bsz, s, h, p, n = _check_args(x, la, b, c, h0)
    pad = -s % CHUNK
    dev = x.device
    chunks = (s + pad) // CHUNK

    def chunked(t, dims):   # padded with zeros, [B, chunks, L, ...]
        return torch.nn.functional.pad(t.float(), dims).unflatten(
            1, (chunks, CHUNK))

    xk = chunked(x, (0, 0, 0, 0, 0, pad))                # [B,C,L,H,P]
    dyk = (torch.zeros_like(xk) if dy is None
           else chunked(dy, (0, 0, 0, 0, 0, pad)))
    sk = torch.cumsum(chunked(la, (0, 0, 0, pad)), dim=2)  # [B,C,L,H]
    bk, ck = chunked(b, (0, 0, 0, pad)), chunked(c, (0, 0, 0, pad))
    s_last = sk[:, :, -1]                                 # [B,C,H]
    es = sk.exp()
    w = (s_last[:, :, None] - sk).exp()
    decay = s_last.exp()[..., None, None]                 # [B,C,H,1,1]
    # (1) the chunk increments
    u = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bk, w, xk)
    v = torch.einsum("bcin,bcih,bcihp->bchnp", ck, es, dyk)
    # (2) the two passes over chunks
    hs, gs = torch.empty_like(u), torch.empty_like(v)
    state = (torch.zeros(bsz, h, n, p, device=dev) if h0 is None
             else h0.float())
    for ci in range(chunks):
        hs[:, ci] = state
        state = decay[:, ci] * state + u[:, ci]
    g = (torch.zeros(bsz, h, n, p, device=dev) if dfinal is None
         else dfinal.float())
    for ci in reversed(range(chunks)):
        gs[:, ci] = g
        g = decay[:, ci] * g + v[:, ci]
    # (3) the chunk gradients, every chunk at once
    tril = torch.ones(CHUNK, CHUNK, dtype=torch.bool, device=dev).tril()
    dec = (sk[:, :, :, None] - sk[:, :, None]).masked_fill(
        ~tril[:, :, None], float("-inf")).exp()           # [B,C,i,j,H]
    cb = ck @ bk.transpose(-1, -2)                        # [B,C,i,j]
    m = torch.einsum("bcihp,bcjhp->bcijh", dyk, xk) * dec
    a = cb[..., None] * m
    hd = torch.einsum("bchnp,bcihp->bcihn", hs, dyk)     # H dy_i
    gx = torch.einsum("bchnp,bcjhp->bcjhn", gs, xk)      # G x_j
    dx = (torch.einsum("bcij,bcijh,bcihp->bcjhp", cb, dec, dyk)
          + w[..., None] * torch.einsum("bcjn,bchnp->bcjhp", bk, gs))
    db = (torch.einsum("bcijh,bcin->bcjn", m, ck)
          + torch.einsum("bcjh,bcjhn->bcjn", w, gx))
    dc = (torch.einsum("bcijh,bcjn->bcin", m, bk)
          + torch.einsum("bcih,bcihn->bcin", es, hd))
    q = w * torch.einsum("bcjn,bcjhn->bcjh", bk, gx)
    ds = (a.sum(3) - a.sum(2) - q
          + es * torch.einsum("bcin,bcihn->bcih", ck, hd))
    ds[:, :, -1] += decay[..., 0, 0] * (gs * hs).sum((-2, -1)) + q.sum(2)
    dla = ds.flip(2).cumsum(2).flip(2)

    def unchunked(t):
        return t.flatten(1, 2)[:, :s]

    return (unchunked(dx).to(x.dtype), unchunked(dla), unchunked(db).to(
        b.dtype), unchunked(dc).to(c.dtype), None if h0 is None else g)


def scan_bwd_ops(bsz: int, s: int, h: int, p: int, n: int) -> float:
    """The backward's operations: two multiply-adds of gradient per
    multiply-add of the forward (:func:`scan_ops`), the yardstick of its
    bound; the kernel also recomputes the states entering the chunks."""
    return 2.0 * scan_ops(bsz, s, h, p, n)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _meta_op(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor,
             h0: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel on the meta device; it has no
    implementation on a device with values."""
    raise RuntimeError("repro_torch::ssd_scan runs on meta tensors only")


@_meta_op.register_fake
def _(x, la, b, c, h0):
    bsz, _, h, p = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty(bsz, h, b.shape[-1], p, dtype=torch.float32,
                        device=x.device))


def _meta_ops(args, kwargs) -> float:
    x, _, b = args[:3]
    bsz, s, h, p = x.shape
    return scan_ops(bsz, s, h, p, b.shape[-1])


META_OPS["ssd_scan"] = _meta_ops


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _meta_bwd_op(x: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, h0: torch.Tensor | None, dy: torch.Tensor,
                 dfinal: torch.Tensor | None) -> list[torch.Tensor]:
    """One launch of the backward kernel on the meta device: ``[dx, dla,
    db, dc]``, and ``dh0`` when h0 is given."""
    raise RuntimeError("repro_torch::ssd_scan_bwd runs on meta tensors only")


@_meta_bwd_op.register_fake
def _(x, la, b, c, h0, dy, dfinal):
    grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
             for t in (x, la, b, c)]
    if h0 is not None:
        grads.append(torch.empty_like(h0))
    return grads


def _meta_bwd_ops(args, kwargs) -> float:
    x, _, b = args[:3]
    bsz, s, h, p = x.shape
    return scan_bwd_ops(bsz, s, h, p, b.shape[-1])


META_OPS["ssd_scan_bwd"] = _meta_bwd_ops


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                 ci, ci, ci, ci, ci, vp]
    lib.ssd_scan_fwd.restype = ci
    lib.ssd_scan_error_string.argtypes = [ci]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [vp] * 19 + [ci] * 7 + [vp]
    lib.ssd_scan_bwd.restype = ci
    lib.ssd_scan_bwd_columns.argtypes = [ci]
    lib.ssd_scan_bwd_columns.restype = ci
    lib.ssd_scan_bwd_error_string.argtypes = [ci]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x, la, b, c, h0=None):
    """SSD scan of x ``[B, S, H, P]`` with log decays la ``[B, S, H]``
    and the shared b, c ``[B, S, N]`` streams (f32 or bf16), from state
    ``h0`` ``[B, H, N, P]`` (zeros when None).  Returns ``(y [B, S, H,
    P] in x's dtype, contiguous; final state [B, H, N, P] f32)``.  Under
    grad, with an input that requires it, through :class:`_SSDScan`."""
    inputs = (x, la, b, c, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _SSDScan.apply(*inputs)
    return _forward(*inputs)


def _forward(x, la, b, c, h0):
    """The plain version on the CPU, the kernel's launch on the card."""
    bsz, s, h, p, n = _check_args(x, la, b, c, h0)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, la, b, c, h0)
    if dev.type == "meta":
        return _meta_op(x, la, b, c, h0)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > MAX_N:
        raise ValueError(f"the kernel takes N <= {MAX_N}, got {n}")
    y = torch.empty(x.shape, dtype=x.dtype, device=dev)
    final = torch.empty(bsz, h, n, p, dtype=torch.float32, device=dev)
    # C B^T of every chunk, shared by the heads (the kernel's first pass)
    cb = torch.empty(bsz, -(-s // CHUNK), CHUNK, CHUNK, dtype=torch.float32,
                     device=dev)
    strides = (ctypes.c_int64 * 13)(
        *x.stride()[:3], *y.stride()[:3], *la.stride(), *b.stride()[:2],
        *c.stride()[:2])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().ssd_scan_fwd(
            x.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(),
            final.data_ptr(), cb.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), bsz, s,
            h, n, p, _DTYPES[x.dtype], _DTYPES[b.dtype], stream,
        )
    if code:
        msg = _lib().ssd_scan_error_string(code).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {code} "
                           f"({msg})")
    count_launch(LAUNCHES, "ssd_scan")
    return y, final


def bwd_columns(n: int) -> int:
    """The state columns a block of the backward kernel takes at state
    size ``n`` (the library's ``ssd_scan_bwd_columns``, which sizes the
    scratch on the card): 64 at every ``n``."""
    return 64


def _bwd_scratch(bsz, s, h, p, n, cols, dev):
    """The backward kernel's f32 scratch: every chunk's increments ``[2,
    B, H, chunks, N, P4]`` (P rounded up to 4; rewritten in place as the
    states entering the chunks and the gradients of those leaving them),
    each chunk's ``s_last`` ``[B, H, chunks]``, the db and dc partials of
    every block of ``cols`` state columns and the ds partials."""
    f32 = dict(dtype=torch.float32, device=dev)
    chunks = -(-s // CHUNK)
    blocks = h * -(-p // cols)  # partials a row
    return (torch.empty(2, bsz * h * chunks * n * (-(-p // 4) * 4), **f32),
            torch.empty(bsz * h * chunks, **f32),
            torch.empty(2, bsz * blocks * chunks * CHUNK * n, **f32),
            torch.empty(bsz * blocks * chunks * CHUNK, **f32))


def _backward(x, la, b, c, h0, dy, dfinal):
    """``(dx, dla, db, dc, dh0)`` on the card (the backward kernel's
    launch) or on meta (its op); dh0 is None when h0 is."""
    bsz, s, h, p, n = _check_args(x, la, b, c, h0)
    dev = x.device
    dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype)
    if dev.type == "meta":
        # the kernel's scratch too, live across its launch, so that a
        # recording's peak holds what the card holds
        scratch = _bwd_scratch(bsz, s, h, p, n, bwd_columns(n), dev)
        grads = _meta_bwd_op(x, la, b, c, h0, dy, dfinal)
        del scratch
        return (*grads[:4], grads[4] if h0 is not None else None)
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dfinal is not None:
        dfinal = dfinal.float().contiguous()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if n > MAX_N:
        raise ValueError(f"the kernel takes N <= {MAX_N}, got {n}")
    lib = _bwd_lib()
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    dla = torch.empty(la.shape, **f32)
    db = torch.empty(b.shape, dtype=b.dtype, device=dev)
    dc = torch.empty(c.shape, dtype=c.dtype, device=dev)
    dh0 = None if h0 is None else torch.empty(h0.shape, **f32)
    incr, slast, part_bc, part_s = _bwd_scratch(
        bsz, s, h, p, n, lib.ssd_scan_bwd_columns(n), dev)
    strides = (ctypes.c_int64 * 13)(
        *x.stride()[:3], *dy.stride()[:3], *la.stride(), *b.stride()[:2],
        *c.stride()[:2])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ssd_scan_bwd(
            *map(ptr, (x, la, b, c, h0, dy, dfinal, dx, dla, db, dc, dh0,
                       incr[0], incr[1], slast, part_bc[0], part_bc[1],
                       part_s)),
            ctypes.cast(strides, ctypes.c_void_p), bsz, s, h, n, p,
            _DTYPES[x.dtype], _DTYPES[b.dtype], stream,
        )
    if code:
        msg = lib.ssd_scan_bwd_error_string(code).decode()
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {code} "
                           f"({msg})")
    count_launch(LAUNCHES, "ssd_scan_bwd")
    return dx, dla, db, dc, dh0


class _SSDScan(torch.autograd.Function):
    """B5 with a gradient: the forward launches the kernel (the plain
    version on the CPU) and saves its inputs; the backward launches the
    backward kernel on the card (one op on meta) and, on the CPU, runs
    :func:`ssd_scan_plain` on them again under autograd and returns the
    gradients of its outputs."""

    @staticmethod
    def forward(ctx, x, la, b, c, h0):
        ctx.save_for_backward(x, la, b, c, h0)
        ctx.set_materialize_grads(False)
        return _forward(x, la, b, c, h0)

    @staticmethod
    def backward(ctx, grad_y, grad_final):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        if saved[0].device.type == "cpu":
            return _autograd_backward(saved, need, grad_y, grad_final)
        grads = _backward(*saved, grad_y, grad_final)
        return tuple(g if n else None for g, n in zip(grads, need))


def _autograd_backward(saved, need, grad_y, grad_final):
    """The CPU's backward: :func:`ssd_scan_plain` on the saved inputs
    again under autograd, and the gradients of its outputs for those
    inputs that ``need`` them (None for the others)."""
    with torch.enable_grad():
        inputs = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(saved, need)]
        outs = ssd_scan_plain(*inputs)
        pairs = [(o, g) for o, g in zip(outs, (grad_y, grad_final))
                 if g is not None]
        wanted = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs else [None] * len(wanted))
    return tuple(next(grads) if n else None for n in need)
