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

The kernel has three forms; :func:`kernel_form` picks one per call and
each launch also counts in :data:`LAUNCHES_BY_FORM`:

* ``"split_kv"`` — bf16, D in :data:`TC_HEAD_DIMS`, at most
  :data:`SPLIT_MAX_ROWS` (16) q rows per kv head (``Sq * H / Hkv``: every
  decode step).  The visible columns are cut into splits of
  :data:`SPLIT_COLUMNS` (128); one block per (split, kv head, batch)
  writes f32 partials (max, sum, accumulator) to scratch from
  ``torch.empty``, and a second kernel merges them in split order.
  :func:`split_kv_plain` is the same decomposition in torch ops.
* ``"tensor_core"`` — bf16, D in :data:`TC_HEAD_DIMS`, more rows
  (prefill): ``mma.sync`` bf16 tiles with f32 accumulation; P is rounded
  to bf16 before P·V, as SDPA does.
* ``"simt"`` — everything else: f32 (TF32 would break the f32 gates),
  bf16 at D in {8, 16, 32}, and bf16 tensors that are not 16-byte
  aligned or whose (b, h, s) strides are not multiples of 8 elements
  (the other forms copy rows in 16-byte pieces): f32 FMAs on the CUDA
  cores.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, count_launch

#: Kernel launches; only the wrapper's launch adds to it.
LAUNCHES = {"flash_attention": 0}
#: The same launches by form (:func:`kernel_form`); they sum to LAUNCHES.
LAUNCHES_BY_FORM = {"tensor_core": 0, "split_kv": 0, "simt": 0}

HEAD_DIMS = (8, 16, 32, 64, 128)
#: Head dims of the tensor-core and split-KV forms (bf16 only).
TC_HEAD_DIMS = (64, 128)
#: q rows per kv head up to which bf16 goes to the split-KV form
#: (csrc/flash_split.cuh kMaxRows).
SPLIT_MAX_ROWS = 16
#: KV columns per split (csrc/flash_split.cuh kSplit).
SPLIT_COLUMNS = 128
_FORM_CODES = {"simt": 0, "tensor_core": 1, "split_kv": 2}
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


def _visible(sq: int, causal: bool, q_offset: int, kv_len: int) -> int:
    """Columns that the last q row sees: the KV extent a call reads."""
    return min(kv_len, q_offset + sq) if causal else kv_len


def split_kv_plain(q, k, v, *, causal: bool, scale=None, q_offset: int = 0,
                   kv_len=None) -> torch.Tensor:
    """The split-KV form's decomposition in torch ops: per split of
    :data:`SPLIT_COLUMNS` columns and per row, the max ``m`` of the visible scores
    (-1e30 where the row sees none of the split), ``l = sum exp(s - m)``
    and ``acc = sum exp(s - m) v`` over the visible columns (0 for a row
    that sees none); then, in split order, ``M = max m``,
    ``out = sum acc e^(m - M) / max(sum l e^(m - M), 1e-30)``."""
    q_offset, kv_len = _check_args(q, k, v, q_offset, kv_len)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else float(scale)
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    qf = q.float() * scale
    rows = torch.arange(sq, device=q.device)[:, None]
    split = SPLIT_COLUMNS
    ms, ls, accs = [], [], []
    for j0 in range(0, _visible(sq, causal, q_offset, kv_len), split):
        cols = torch.arange(j0, j0 + split, device=q.device)[None, :]
        ok = cols < kv_len
        if causal:
            ok = ok & (cols <= q_offset + rows)              # [Sq, split]
        j1 = min(j0 + split, kv_len)
        s = torch.zeros(b, h, sq, split, device=q.device)
        s[..., :j1 - j0] = qf @ kf[:, :, j0:j1].transpose(-1, -2)
        s = torch.where(ok, s, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        empty = torch.isneginf(m)
        p = torch.where(empty, 0.0, torch.exp(s - m))
        vs = torch.zeros(b, h, split, d, device=q.device)
        vs[:, :, :j1 - j0] = vf[:, :, j0:j1]
        ms.append(torch.where(empty, NEG_INF, m))
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(p @ vs)
    big = torch.stack(ms).amax(dim=0)
    den = torch.zeros_like(ls[0])
    num = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):
        w = torch.exp(m - big)
        den = den + l * w
        num = num + acc * w
    return (num / den.clamp_min(1e-30)).to(q.dtype)


def kernel_form(q, k, v) -> str:
    """The kernel form that :func:`flash_attention` launches for these
    arguments (see the module docstring).  The output, allocated like q,
    is aligned as q is."""
    _, h, sq, d = q.shape
    if q.dtype != torch.bfloat16 or d not in TC_HEAD_DIMS:
        return "simt"
    aligned = all(t.data_ptr() % 16 == 0
                  and all(st % 8 == 0 for st in t.stride()[:3])
                  for t in (q, k, v))
    if not aligned:
        return "simt"
    return "split_kv" if sq * (h // k.shape[1]) <= SPLIT_MAX_ROWS \
        else "tensor_core"


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci,
        ci, ci, ci, vp, vp, vp,
    ]
    lib.flash_attention_fwd.restype = ci
    for fn in (lib.flash_attention_split_columns,
               lib.flash_attention_split_max_rows):
        fn.argtypes, fn.restype = [], ci
    if (lib.flash_attention_split_columns() != SPLIT_COLUMNS
            or lib.flash_attention_split_max_rows() != SPLIT_MAX_ROWS):
        raise RuntimeError("flash_attention: the library's split sizes "
                           "differ from the wrapper's")
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
    if sq > 64 * 65535:
        raise ValueError("Sq must be <= 4194240")
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)  # q's layout; its last dim stays contiguous
    form = kernel_form(q, k, v)
    n_splits, part_ml, part_acc = 0, None, None
    if form == "split_kv":
        rows = sq * (h // hkv)
        n_splits = -(-_visible(sq, causal, q_offset, kv_len)
                     // SPLIT_COLUMNS)
        part_ml = torch.empty(b, hkv, n_splits, rows, 2,
                              dtype=torch.float32, device=dev)
        part_acc = torch.empty(b, hkv, n_splits, rows, d,
                               dtype=torch.float32, device=dev)
    strides = (ctypes.c_int64 * 12)(*[
        s for t in (q, k, v, out) for s in t.stride()[:3]
    ])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), b, h, sq, hkv, kv_len,
            q_offset, int(bool(causal)), scale, d, _DTYPES[q.dtype],
            _FORM_CODES[form], n_splits,
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(), stream,
        )
    if code:
        msg = _lib().flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed ({form} form): "
                           f"CUDA error {code} ({msg})")
    count_launch(LAUNCHES, "flash_attention")
    count_launch(LAUNCHES_BY_FORM, form)
    return out
