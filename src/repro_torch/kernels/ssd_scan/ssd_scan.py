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
counts the launch in :data:`LAUNCHES`, or raises.  A launch is two
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

from repro_torch.kernels import build, count_launch

#: Kernel launches; only the wrapper's launch adds to it.
LAUNCHES = {"ssd_scan": 0}

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


def ssd_scan(x, la, b, c, h0=None):
    """SSD scan of x ``[B, S, H, P]`` with log decays la ``[B, S, H]``
    and the shared b, c ``[B, S, N]`` streams (f32 or bf16), from state
    ``h0`` ``[B, H, N, P]`` (zeros when None).  Returns ``(y [B, S, H,
    P] in x's dtype, contiguous; final state [B, H, N, P] f32)``."""
    bsz, s, h, p, n = _check_args(x, la, b, c, h0)
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, la, b, c, h0)
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
