"""Flash-attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU's
``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``:
blocked online softmax, f32 accumulation, GQA through the head index,
and a causal KV stream that stops at the last tile a row can see.

:func:`flash_attention` computes, for q ``[B, H, Sq, D]`` and k, v
``[B, Hkv, Sk, D]`` (``H % Hkv == 0``), row ``i`` of each head over the
columns ``j`` with ``j < kv_len`` and, when causal, ``j <= q_offset +
i``.  With ``q_offset = 0`` and ``kv_len = Sk`` that is the TPU kernel's
function.

Causal alignment (ROADMAP C1): the TPU kernel masks ``col <= row``
(top-left) while the reference's dense oracle ``attention_ref`` masks
``tril(k=Sk-Sq)`` (bottom-right); they agree only at ``Sq = Sk``.  The
port follows the kernel: without offsets, causal rows are top-left
aligned.  The model's cache path states the alignment explicitly with
``q_offset = cache length`` and ``kv_len = cache length + new tokens``,
which is the reference's position mask (``models/attention.py:_mask``).

A wrapper given CPU tensors returns the plain version
(:func:`flash_attention_plain`); given CUDA tensors it launches the
kernel and counts the launch in :data:`LAUNCHES`, or raises.  The
kernel reads q, k and v through their strides (the last dimension must
be contiguous), so the model's ``[B, S, H, D]`` tensors go in as
``transpose(1, 2)`` views; the output has q's layout and dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

#: Kernel launches; only the wrapper's launch adds to it.
LAUNCHES = {"flash_attention": 0}

HEAD_DIMS = (8, 16, 32, 64, 128)
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, q_offset, kv_len):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"{name} must be a 4-D tensor")
    b, h, sq, d = q.shape
    bk, hkv, sk, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or bk != b or dk != d:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B,H,Sq,D] / "
                         "[B,Hkv,Sk,D]")
    if hkv <= 0 or h % hkv:
        raise ValueError(f"heads {h} must be a multiple of kv heads {hkv}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (k.device == v.device == q.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    kv_len = sk if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len must be in [1, {sk}], got {kv_len}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    return q_offset, kv_len


# --- plain PyTorch version ---------------------------------------------------


def flash_attention_plain(q, k, v, *, causal: bool, scale=None,
                          q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """Dense masked softmax attention in f32 with the kernel's mask,
    ``-1e30`` for masked scores and ``acc / max(l, 1e-30)``."""
    q_offset, kv_len = _check_args(q, k, v, q_offset, kv_len)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    s = (q.float() * scale) @ kf.transpose(-1, -2)          # [B,H,Sq,Sk]
    cols = torch.arange(sk, device=q.device)
    mask = (cols < kv_len)[None, :]
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        mask = mask & (cols[None, :] <= q_offset + rows)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ vf) / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci,
        ci, vp,
    ]
    lib.flash_attention_fwd.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool, scale=None, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """Attention of q ``[B, H, Sq, D]`` over k, v ``[B, Hkv, Sk, D]``:
    row ``i`` sees column ``j`` iff ``j < kv_len`` and, when ``causal``,
    ``j <= q_offset + i``.  ``scale`` defaults to ``D ** -0.5``;
    ``kv_len`` to ``Sk``.  f32 or bf16 in, f32 accumulation, output in
    q's dtype and memory layout."""
    q_offset, kv_len = _check_args(q, k, v, q_offset, kv_len)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if max(b, h) > 65535:
        raise ValueError("batch and heads must be <= 65535")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)  # q's layout; its last dim stays contiguous
    strides = (ctypes.c_int64 * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, h, sq, hkv, kv_len,
            q_offset, int(bool(causal)), scale, d, _DTYPES[q.dtype], stream,
        )
    if code:
        msg = _lib().flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{code} ({msg})")
    LAUNCHES["flash_attention"] += 1
    return out
