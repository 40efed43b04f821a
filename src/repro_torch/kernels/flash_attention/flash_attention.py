"""Flash-attention forward: the CUDA kernel's wrapper and its plain
PyTorch version.

The kernel (``csrc/flash_attention.cu``) replaces the TPU's
``repro/kernels/flash_attention/flash_attention.py::_flash_kernel``:
blocked online softmax, f32 accumulation, GQA through the head index,
and a causal KV stream that stops at the last tile a row can see.

:func:`flash_attention` computes, for q ``[B, H, Sq, D]`` and k, v
``[B, Hkv, Sk, D]`` (``H % Hkv == 0``), row ``i`` of each head over the
columns ``j`` with ``j < kv_len``, when causal ``j <= q_offset + i``,
and with a sliding ``window = W`` ``j > q_offset + i - W`` (the
reference's ``models/attention.py::_mask``; the TPU kernel has no
window).  With ``q_offset = 0``, ``kv_len = Sk`` and no window that is
the TPU kernel's function.  Every row must see at least one column
(with a window: ``q_offset + Sq - W < kv_len``); the wrapper raises
otherwise.

Causal alignment (ROADMAP C1): the TPU kernel masks ``col <= row``
(top-left) while the reference's dense oracle ``attention_ref`` masks
``tril(k=Sk-Sq)`` (bottom-right); they agree only at ``Sq = Sk``.  The
port follows the kernel: without offsets, causal rows are top-left
aligned.  The model's cache path states the alignment explicitly with
``q_offset = cache length`` and ``kv_len = cache length + new tokens``,
which is the reference's position mask (``models/attention.py:_mask``).

A wrapper given CPU tensors returns the plain version
(:func:`flash_attention_plain`); given CUDA tensors it launches the
kernel and counts the launch in :data:`LAUNCHES`, or raises.  Given
meta tensors (an abstract step: the dry-run) it is one op,
``repro_torch::flash_attention``, whose result has the kernel's shape,
dtype and layout and which a recording counts as the kernel's work
(:func:`attention_ops`); nothing is launched or counted.  With grad
enabled and an input that requires grad, the call goes through an
``autograd.Function`` (:class:`_FlashAttention`): its forward is the
same launch (or, on the CPU, the plain version), so a kernel output
always carries its autograd history.  Where the backward will take a
tensor-core form (:func:`keeps_lse`: every form but the CUDA-core and the
f32 split-KV ones, on the card or on meta), that forward also writes each
row's log-sum-exp (f32
``[B, H, Sq]``) and saves it with the output; the bf16 forms also write
the output's bf16 rounding residual (their P·V then takes P in two bf16
parts, so that output + residual holds ~16 bits), f32 has none.  Its
backward dispatches by device as the
forward does (the JAX package trains through jnp autodiff; its Pallas
kernel has no VJP): on the card the backward kernel
(``csrc/flash_bwd.cu``, two deterministic passes that recompute P from
the forward's log-sum-exp in the tensor-core forms, with ``Delta =
rowsum(dO (O + O_lo))`` in bf16 and, in f32 (3xTF32 products),
``dO . O`` corrected to the products' own ``rowsum(dP P)``; counted in
``LAUNCHES["flash_attention_bwd"]`` and by the form :func:`backward_form`
picks in :data:`LAUNCHES_BY_BWD_FORM`), on meta
one op, ``repro_torch::flash_attention_bwd``
(:func:`attention_bwd_ops`), with the kernel's f32 scratch allocated
across it as on the card, on the CPU :func:`flash_attention_bwd`, the
closed-form gradient in torch ops (the backward's plain version, which
also has the log-sum-exp-and-Delta form the kernel computes).  The
kernel reads q, k and v through their strides (the last dimension must
be contiguous), so the model's ``[B, S, H, D]`` tensors go in as
``transpose(1, 2)`` views; the output has q's layout and dtype.

The kernel has five forms; :func:`kernel_form` picks one per call and
each launch also counts in :data:`LAUNCHES_BY_FORM`:

* ``"split_kv"`` — bf16, D in :data:`TC_HEAD_DIMS` (64, 96, 128), at most
  :data:`SPLIT_MAX_ROWS` (16) q rows per kv head (``Sq * H / Hkv``: every
  decode step).  The visible columns are cut into splits of
  :data:`SPLIT_COLUMNS` (128), splits wholly below a window's band
  left out; one block per (split, kv head, batch)
  writes f32 partials (max, sum, accumulator) to scratch from
  ``torch.empty``, and a second kernel merges them in split order.
  :func:`split_kv_plain` is the same decomposition in torch ops.
* ``"split_kv_f32"`` — the same for f32 (every f32 decode step), in splits
  of :data:`SPLIT_COLUMNS_F32` (64) columns (:func:`split_columns`); its
  merge writes the output alone, and its backward is the CUDA-core form.
* ``"tensor_core"`` — bf16, D in :data:`TC_HEAD_DIMS`, more rows
  (prefill, an encoder, cross-attention over a source): ``mma.sync`` bf16 tiles with f32 accumulation; P is rounded
  to bf16 before P·V, as SDPA does.
* ``"tensor_core_f32"`` — f32, D in :data:`TC_HEAD_DIMS`, more than
  :data:`SPLIT_MAX_ROWS` q rows per kv head (``csrc/flash_tc_f32.cuh``):
  the tensor-core form's shape with 3xTF32 products (each f32 operand
  split into a TF32 high part and the rest, three ``mma.sync`` a
  product, f32 sums), which meets the f32 gates where TF32 alone would
  not.
* ``"simt"`` — everything else: f32 and bf16 at D in {8, 16, 32}, and
  tensors that are not 16-byte aligned or whose (b, h, s) strides are
  not multiples of 16 bytes (8 bf16 or 4 f32 elements; the other forms
  copy rows in 16-byte pieces): f32 FMAs on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import META_OPS, build, count_launch

#: Kernel launches; only the wrappers' launches add to it (the
#: backward's under ``flash_attention_bwd``).
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
#: The forward's launches by form (:func:`kernel_form`); they sum to
#: ``LAUNCHES["flash_attention"]``.
LAUNCHES_BY_FORM = {"tensor_core": 0, "split_kv": 0, "tensor_core_f32": 0,
                    "split_kv_f32": 0, "simt": 0}
#: The backward's launches by form (:func:`backward_form`); they sum to
#: ``LAUNCHES["flash_attention_bwd"]``.
LAUNCHES_BY_BWD_FORM = {"tensor_core_bwd": 0, "tensor_core_f32_bwd": 0,
                        "simt_bwd": 0}

HEAD_DIMS = (8, 16, 32, 64, 96, 128)
#: Head dims of the tensor-core and split-KV forms (bf16 and f32).
TC_HEAD_DIMS = (64, 96, 128)
#: q rows per kv head up to which a call goes to a split-KV form
#: (csrc/flash_split.cuh kMaxRows).
SPLIT_MAX_ROWS = 16
#: KV columns per split of the bf16 and the f32 split-KV form
#: (csrc/flash_split.cuh ``Split<T>::kColumns``): in f32 a 64-column split
#: keeps K and V in shared memory at ~79 KB a block at D 128.
SPLIT_COLUMNS = 128
SPLIT_COLUMNS_F32 = 64
_FORM_CODES = {"simt": 0, "tensor_core": 1, "split_kv": 2,
               "tensor_core_f32": 3, "split_kv_f32": 4}
NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, q_offset, kv_len, window=None):
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
    if window is not None:
        window = int(window)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if q_offset + sq - window >= kv_len:
            raise ValueError(
                f"with window {window}, q_offset {q_offset} and kv_len "
                f"{kv_len}, row {sq - 1} sees no column")
    return q_offset, kv_len, window


# --- plain PyTorch version ---------------------------------------------------


#: Score elements per row block of the plain version (1 GiB in f32): its
#: rows are independent, so it takes them in blocks to bound its memory.
PLAIN_BLOCK_ELEMENTS = 1 << 28


def _visible_mask(rows, cols, *, causal: bool, q_offset: int, kv_len: int,
                  window):
    """``[rows, cols]`` boolean: row ``i`` sees column ``j``."""
    ok = cols[None, :] < kv_len
    if causal:
        ok = ok & (cols[None, :] <= q_offset + rows[:, None])
    if window is not None:
        ok = ok & (cols[None, :] > q_offset + rows[:, None] - window)
    return ok


def _acc_dtype(q) -> torch.dtype:
    """The plain versions' arithmetic: f64 for f64 inputs (the oracle of
    the card's f32 cases whose softmax is sharp enough that f32's own
    rounding reaches the gates), else f32."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_plain(q, k, v, *, causal: bool, scale=None,
                          q_offset: int = 0, kv_len=None, window=None,
                          return_lse: bool = False):
    """Dense masked softmax attention in f32 (f64 for f64 inputs) with the
    kernel's mask, ``-1e30`` for masked scores and ``acc / max(l,
    1e-30)``; q rows in blocks of at most :data:`PLAIN_BLOCK_ELEMENTS`
    scores.  With ``return_lse`` also each row's log-sum-exp ``m + ln
    max(l, 1e-30)`` over its visible scores ``scale q k^T`` (``[B, H,
    Sq]`` in the arithmetic's dtype; the kernel writes it in f32 under
    autograd): ``(out, lse)``."""
    q_offset, kv_len, window = _check_args(q, k, v, q_offset, kv_len, window)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    acc = _acc_dtype(q)
    kf = k.to(acc).repeat_interleave(h // hkv, dim=1)
    vf = v.to(acc).repeat_interleave(h // hkv, dim=1)
    cols = torch.arange(sk, device=q.device)
    step = max(1, PLAIN_BLOCK_ELEMENTS // (b * h * sk))
    out = torch.empty(b, h, sq, d, dtype=acc, device=q.device)
    lse = torch.empty(b, h, sq, dtype=acc, device=q.device) \
        if return_lse else None
    for r0 in range(0, sq, step):
        rows = torch.arange(r0, min(r0 + step, sq), device=q.device)
        s = (q[:, :, r0:r0 + step].to(acc) * scale) @ kf.transpose(-1, -2)
        mask = _visible_mask(rows, cols, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, window=window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out[:, :, r0:r0 + step] = (p @ vf) / den
        if return_lse:
            lse[:, :, r0:r0 + step] = (m + den.log())[..., 0]
        del s, p
    return (out.to(q.dtype), lse) if return_lse else out.to(q.dtype)


def split_columns(dtype) -> int:
    """Columns a split of the split-KV form for ``dtype``:
    :data:`SPLIT_COLUMNS_F32` in f32, else :data:`SPLIT_COLUMNS`."""
    return SPLIT_COLUMNS_F32 if dtype == torch.float32 else SPLIT_COLUMNS


def split_range(sq: int, causal: bool, q_offset: int, kv_len: int,
                window=None, columns: int = SPLIT_COLUMNS) -> tuple[int, int]:
    """(first split, number of splits) that a split-KV form visits: the
    ``columns``-column splits from the one holding the first row's window
    edge to the one holding the last row's last visible column."""
    end = min(kv_len, q_offset + sq) if causal else kv_len
    first = 0 if window is None else max(0, q_offset - window + 1)
    lo = first // columns
    return lo, -(-end // columns) - lo


def split_kv_plain(q, k, v, *, causal: bool, scale=None, q_offset: int = 0,
                   kv_len=None, window=None,
                   columns: int = SPLIT_COLUMNS) -> torch.Tensor:
    """A split-KV form's decomposition in torch ops: per split of
    ``columns`` columns (:func:`split_columns` of the form's dtype) that
    :func:`split_range` visits and per row, the max ``m`` of the visible
    scores
    (-1e30 where the row sees none of the split), ``l = sum exp(s - m)``
    and ``acc = sum exp(s - m) v`` over the visible columns (0 for a row
    that sees none); then, in split order, ``M = max m``,
    ``out = sum acc e^(m - M) / max(sum l e^(m - M), 1e-30)``."""
    q_offset, kv_len, window = _check_args(q, k, v, q_offset, kv_len, window)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else float(scale)
    kf = k.float().repeat_interleave(h // hkv, dim=1)
    vf = v.float().repeat_interleave(h // hkv, dim=1)
    qf = q.float() * scale
    rows = torch.arange(sq, device=q.device)
    split = columns
    lo, n_splits = split_range(sq, causal, q_offset, kv_len, window, split)
    ms, ls, accs = [], [], []
    for j0 in range(lo * split, (lo + n_splits) * split, split):
        cols = torch.arange(j0, j0 + split, device=q.device)
        ok = _visible_mask(rows, cols, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, window=window)  # [Sq, split]
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


def _aligned(*ts) -> bool:
    """Whether every tensor can be copied in 16-byte rows (the
    tensor-core and split-KV forms' loads): a 16-byte aligned start and
    (b, h, s) strides that are multiples of 16 bytes (8 bf16 or 4 f32
    elements)."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:3]) for t in ts)


def backward_form(q, k, v) -> str:
    """The backward kernel's form after a forward of
    :func:`kernel_form`'s form on q, k, v (the output's gradient is
    copied when it is not aligned, so it does not choose):
    ``"tensor_core"`` after a bf16 tensor-core or split-KV forward,
    ``"tensor_core_f32"`` after an f32 tensor-core one, else ``"simt"``
    (the CUDA-core form, with its statistics stage: after a CUDA-core or
    an f32 split-KV forward)."""
    form = kernel_form(q, k, v)
    return {"split_kv": "tensor_core", "split_kv_f32": "simt"}.get(form,
                                                                   form)


def keeps_lse(q, k, v) -> bool:
    """Whether a forward under autograd writes and saves each row's
    log-sum-exp (bf16: and its output's rounding residual) and its
    output for the backward: on the card or on meta, where the backward
    takes a tensor-core form (:func:`backward_form`; the forward's form
    then writes them)."""
    return q.device.type in ("cuda", "meta") and \
        backward_form(q, k, v) != "simt"


def kernel_form(q, k, v) -> str:
    """The kernel form that :func:`flash_attention` launches for these
    arguments (see the module docstring).  The output, allocated like q,
    is aligned as q is."""
    _, h, sq, d = q.shape
    if q.dtype not in _DTYPES or d not in TC_HEAD_DIMS \
            or not _aligned(q, k, v):
        return "simt"
    few = sq * (h // k.shape[1]) <= SPLIT_MAX_ROWS
    if q.dtype == torch.float32:
        return "split_kv_f32" if few else "tensor_core_f32"
    return "split_kv" if few else "tensor_core"


def attention_ops(b: int, h: int, sq: int, d: int, *, causal: bool,
                  q_offset: int, kv_len: int, window=None) -> float:
    """The kernel's operations: 4·D per visible (row, column) pair (Q K^T
    and P V, two per multiply-add; the softmax's exps not counted), over
    ``b`` batch rows and ``h`` q heads."""
    rows = np.arange(sq)
    hi = (np.minimum(kv_len, q_offset + rows + 1) if causal
          else np.full(sq, kv_len))
    lo = (np.maximum(0, q_offset + rows - window + 1) if window
          else np.zeros(sq, np.int64))
    return 4.0 * d * float(np.maximum(hi - lo, 0).sum()) * b * h


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _meta_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             for_grad: bool, causal: bool, scale: float, q_offset: int,
             kv_len: int, window: int) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]:
    """One launch of the kernel on the meta device (``window`` 0: none):
    the output and, ``for_grad``, each row's log-sum-exp and, in bf16, the
    output's rounding residual (else empty tensors); it has no
    implementation on a device with values."""
    raise RuntimeError("repro_torch::flash_attention runs on meta tensors "
                       "only")


@_meta_op.register_fake
def _(q, k, v, for_grad, causal, scale, q_offset, kv_len, window):
    b, h, sq, _ = q.shape
    lse = torch.empty((b, h, sq) if for_grad else (0,), dtype=torch.float32,
                      device=q.device)
    out_lo = (torch.empty_like(q) if for_grad and q.dtype != torch.float32
              else torch.empty(0, dtype=q.dtype, device=q.device))
    return torch.empty_like(q), lse, out_lo   # the output: q's layout


def _meta_ops(args, kwargs) -> float:
    q, _, _, _, causal, _, q_offset, kv_len, window = args
    b, h, sq, d = q.shape
    return attention_ops(b, h, sq, d, causal=causal, q_offset=q_offset,
                         kv_len=kv_len, window=window or None)


META_OPS["flash_attention"] = _meta_ops


def attention_bwd_ops(b: int, h: int, sq: int, d: int, *, causal: bool,
                      q_offset: int, kv_len: int, window=None) -> float:
    """The backward's operations, the yardstick of its bound: P
    recomputed and dV, dP, dQ, dK, 10·D per visible pair (2.5 times
    :func:`attention_ops`; the second pass's recomputation of S and dP,
    and the CUDA-core form's statistics stage, not counted)."""
    return 2.5 * attention_ops(b, h, sq, d, causal=causal,
                               q_offset=q_offset, kv_len=kv_len,
                               window=window)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _meta_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 grad: torch.Tensor, out: torch.Tensor | None,
                 out_lo: torch.Tensor | None, lse: torch.Tensor | None,
                 causal: bool, scale: float,
                 q_offset: int, kv_len: int,
                 window: int) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """One launch of the backward kernel on the meta device (``window``
    0: none; ``out``, ``out_lo`` and ``lse`` the forward's, read by the
    tensor-core form, else None): ``(dq, dk, dv)``."""
    raise RuntimeError("repro_torch::flash_attention_bwd runs on meta "
                       "tensors only")


@_meta_bwd_op.register_fake
def _(q, k, v, grad, out, out_lo, lse, causal, scale, q_offset, kv_len,
      window):
    return _grads_like(q, k, v)


def _grads_like(*ts):
    """The backward's outputs: contiguous tensors of the inputs' shapes
    and dtypes, as the plain version's (in q's layout, a ``view`` in the
    backward of a full-size pod partition's DTensor step fails)."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in ts)


def _meta_bwd_ops(args, kwargs) -> float:
    q, *_, causal, _, q_offset, kv_len, window = args
    b, h, sq, d = q.shape
    return attention_bwd_ops(b, h, sq, d, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, window=window or None)


META_OPS["flash_attention_bwd"] = _meta_bwd_ops


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float,
        ci, ci, ci, ci, vp, vp, vp, vp, vp,
    ]
    lib.flash_attention_fwd.restype = ci
    lib.flash_attention_split_columns.argtypes = [ci]
    lib.flash_attention_split_max_rows.argtypes = []
    for fn in (lib.flash_attention_split_columns,
               lib.flash_attention_split_max_rows):
        fn.restype = ci
    if (any(lib.flash_attention_split_columns(code) != split_columns(dtype)
            for dtype, code in _DTYPES.items())
            or lib.flash_attention_split_max_rows() != SPLIT_MAX_ROWS):
        raise RuntimeError("flash_attention: the library's split sizes "
                           "differ from the wrapper's")
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd.argtypes = (
        [vp] * 12 + [ci] * 9 + [ctypes.c_float, ci, ci, ci, vp])
    lib.flash_attention_bwd.restype = ci
    lib.flash_attention_bwd_error_string.argtypes = [ci]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool, scale=None, q_offset: int = 0,
                    kv_len=None, window=None) -> torch.Tensor:
    """Attention of q ``[B, H, Sq, D]`` over k, v ``[B, Hkv, Sk, D]``:
    row ``i`` sees column ``j`` iff ``j < kv_len``, when ``causal``
    ``j <= q_offset + i``, and with a ``window`` ``j > q_offset + i -
    window``.  ``scale`` defaults to ``D ** -0.5``; ``kv_len`` to
    ``Sk``; ``window`` None is no window.  f32 or bf16 in, f32
    accumulation, output in q's dtype and memory layout.  Under grad,
    with an input that requires it, through :class:`_FlashAttention`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, q_offset,
                                     kv_len, window)
    return _forward(q, k, v, causal, scale, q_offset, kv_len, window)


def _forward(q, k, v, causal, scale, q_offset, kv_len, window,
             for_grad=False):
    """The plain version on the CPU, the kernel's launch on the card;
    ``for_grad``: ``(out, lse, out_lo)``, each row's log-sum-exp and the
    output's rounding residual in q's dtype beside the output (the
    kernel's tensor-core and split-KV forms write them; :func:`keeps_lse`).
    The f32 form on the card and on meta writes no residual (``out_lo``
    None); the CPU's f32 residual is zeros."""
    q_offset, kv_len, window = _check_args(q, k, v, q_offset, kv_len, window)
    dev = q.device
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len,
              window=window)
    if dev.type == "cpu":
        if not for_grad:
            return flash_attention_plain(q, k, v, **kw)
        out, lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw, return_lse=True)
        hi = out.to(q.dtype)
        return hi, lse, (out - hi.float()).to(q.dtype)
    if dev.type == "meta":
        scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
        out, lse, out_lo = _meta_op(q, k, v, bool(for_grad), bool(causal),
                                    scale, q_offset, kv_len,
                                    0 if window is None else window)
        if not for_grad:
            return out
        return out, lse, None if q.dtype == torch.float32 else out_lo
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
    lse = out_lo = None
    if for_grad:
        if not keeps_lse(q, k, v):
            raise ValueError(f"the {form} form writes no log-sum-exp")
        lse = torch.empty(b, h, sq, dtype=torch.float32, device=dev)
        if form != "tensor_core_f32":
            out_lo = torch.empty_like(out)   # out's strides
    n_splits, part_ml, part_acc = 0, None, None
    if form in ("split_kv", "split_kv_f32"):
        rows = sq * (h // hkv)
        n_splits = split_range(sq, causal, q_offset, kv_len, window,
                               split_columns(q.dtype))[1]
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
            q_offset, int(bool(causal)), 0 if window is None else window,
            scale, d, _DTYPES[q.dtype],
            _FORM_CODES[form], n_splits,
            None if part_ml is None else part_ml.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out_lo is None else out_lo.data_ptr(), stream,
        )
    if code:
        msg = _lib().flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention launch failed ({form} form): "
                           f"CUDA error {code} ({msg})")
    count_launch(LAUNCHES, "flash_attention")
    count_launch(LAUNCHES_BY_FORM, form)
    return (out, lse, out_lo) if for_grad else out


# --- the gradient --------------------------------------------------------------


def flash_attention_bwd(q, k, v, grad, *, causal: bool, scale=None,
                        q_offset: int = 0, kv_len=None, window=None,
                        out=None, lse=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_plain`'s function for
    the output gradient ``grad`` ``[B, H, Sq, D]``, in closed form and
    f32, q rows in the plain version's blocks: with ``P`` the row softmax
    of ``S = scale q k^T`` (masked), ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P (dP - rowsum(P dP))``, ``dQ = scale dS K``, ``dK = scale dS^T
    Q``; a kv head's gradients sum over the q heads that share it.  Given
    the forward's output ``out`` and log-sum-exp ``lse``, the form the
    tensor-core kernel computes: ``P = exp(S - lse)`` on the visible
    columns and ``rowsum(P dP)`` as ``Delta = rowsum(dO out)`` in f32 (the
    kernel's ``out`` is the bf16 output plus its rounding residual).  In
    f64 for f64 inputs.  Returned in the inputs' dtypes."""
    q_offset, kv_len, window = _check_args(q, k, v, q_offset, kv_len, window)
    if (out is None) != (lse is None):
        raise ValueError("give both out and lse, or neither")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    scale = d ** -0.5 if scale is None else float(scale)
    acc = _acc_dtype(q)
    kf = k.to(acc).repeat_interleave(rep, dim=1)
    vf = v.to(acc).repeat_interleave(rep, dim=1)
    dq = torch.empty(b, h, sq, d, dtype=acc, device=q.device)
    dk = torch.zeros(b, h, sk, d, dtype=acc, device=q.device)
    dv = torch.zeros(b, h, sk, d, dtype=acc, device=q.device)
    cols = torch.arange(sk, device=q.device)
    step = max(1, PLAIN_BLOCK_ELEMENTS // (b * h * sk))
    for r0 in range(0, sq, step):
        rows = torch.arange(r0, min(r0 + step, sq), device=q.device)
        qs = q[:, :, r0:r0 + step].to(acc) * scale
        s = qs @ kf.transpose(-1, -2)
        mask = _visible_mask(rows, cols, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, window=window)
        g = grad[:, :, r0:r0 + step].to(acc)
        if lse is None:
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        else:
            p = torch.where(mask, torch.exp(
                s - lse[:, :, r0:r0 + step, None].to(acc)), 0.0)
        del s
        dv += p.transpose(-1, -2) @ g
        dp = g @ vf.transpose(-1, -2)
        if lse is None:
            delta = (dp * p).sum(dim=-1, keepdim=True)
        else:
            delta = (g * out[:, :, r0:r0 + step].to(acc)).sum(
                dim=-1, keepdim=True)
        ds = p * (dp - delta)
        del p, dp
        dq[:, :, r0:r0 + step] = (ds @ kf) * scale
        dk += ds.transpose(-1, -2) @ qs
        del ds
    dk = dk.unflatten(1, (hkv, rep)).sum(dim=2)
    dv = dv.unflatten(1, (hkv, rep)).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_BWD_FORM_CODES = {"simt": 0, "tensor_core": 1, "tensor_core_f32": 2}


def _bwd_stats(b: int, h: int, sq: int, dev, form: str) -> torch.Tensor:
    """The backward kernel's f32 scratch: each q row's Delta (tensor-core
    forms: dO . (O + O_lo) in bf16, rowsum(dP P) in f32), or its
    log-sum-exp and rowsum(dP P) (CUDA-core form, from its statistics
    stage)."""
    rows = (2, b, h, sq) if form == "simt" else (b, h, sq)
    return torch.empty(rows, dtype=torch.float32, device=dev)


def _backward(q, k, v, grad, causal, scale, q_offset, kv_len, window,
              out=None, lse=None, out_lo=None):
    """``(dq, dk, dv)`` on the card (the backward kernel's launch) or on
    meta (its op), contiguous, in q's, k's and v's dtypes.  The
    tensor-core forms read the forward's output ``out`` and log-sum-exp
    ``lse``, the bf16 one also its rounding residual ``out_lo``
    (``_forward(..., for_grad=True)``); the CUDA-core form none of
    them."""
    q_offset, kv_len, window = _check_args(q, k, v, q_offset, kv_len, window)
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    grad = grad.to(q.dtype)
    dev = q.device
    # the forward's choice (an unaligned grad is copied below)
    form = backward_form(q, k, v)
    if form == "simt":
        out = lse = out_lo = None
    elif form == "tensor_core_f32":
        out_lo = None
        if out is None or lse is None:
            raise ValueError("the tensor-core f32 backward reads the "
                             "forward's output and log-sum-exp")
    elif out is None or lse is None or out_lo is None:
        raise ValueError("the tensor-core backward reads the forward's "
                         "output, log-sum-exp and rounding residual")
    if dev.type == "meta":
        # the kernel's scratch too, live across its launch, so that a
        # recording's peak holds what the card holds
        stats = _bwd_stats(b, h, sq, dev, form)
        grads = _meta_bwd_op(q, k, v, grad, out, out_lo, lse, bool(causal),
                             scale, q_offset, kv_len,
                             0 if window is None else window)
        del stats
        return grads
    if grad.stride(-1) != 1 or not _aligned(grad):
        grad = grad.contiguous()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if max(b, h) > 65535 or max(sq, sk) > 64 * 65535:
        raise ValueError("batch and heads must be <= 65535, Sq and Sk <= "
                         "4194240")
    if form != "simt":
        kept = (out,) if out_lo is None else (out, out_lo)
        if any(tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype
               for t in kept) or tuple(lse.shape) != (b, h, sq) \
                or lse.dtype != torch.float32:
            raise ValueError("out and out_lo must be q's shape and dtype, "
                             "lse f32 [B, H, Sq]")
        if out_lo is None:
            if not _aligned(out):
                out = out.contiguous()
        elif out_lo.stride() != out.stride() or not _aligned(out, out_lo):
            out, out_lo = out.contiguous(), out_lo.contiguous()
        lse = lse.contiguous()
    dq, dk, dv = _grads_like(q, k, v)
    stats = _bwd_stats(b, h, sq, dev, form)
    strides = (ctypes.c_int64 * 24)(*[
        s for t in (q, k, v, grad, q if out is None else out, dq, dk, dv)
        for s in t.stride()[:3]
    ])

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.flash_attention_bwd(
            *map(ptr, (q, k, v, grad, out, out_lo, lse, dq, dk, dv, stats)),
            ctypes.cast(strides, ctypes.c_void_p), b, h, sq, hkv, sk,
            kv_len, q_offset, int(bool(causal)),
            0 if window is None else window, scale, d, _DTYPES[q.dtype],
            _BWD_FORM_CODES[form], stream,
        )
    if code:
        msg = lib.flash_attention_bwd_error_string(code).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed ({form} "
                           f"form): CUDA error {code} ({msg})")
    count_launch(LAUNCHES, "flash_attention_bwd")
    count_launch(LAUNCHES_BY_BWD_FORM, f"{form}_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """B4 with a gradient: the forward launches the kernel (the plain
    version on the CPU) and saves q, k, v, and, where the backward takes
    a tensor-core form (:func:`keeps_lse`), the output, each row's
    log-sum-exp and (bf16) the output's rounding residual; the backward
    launches the backward kernel on the card
    (one op on meta) and, on the CPU, is :func:`flash_attention_bwd`,
    torch ops; each recomputes P."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, kv_len, window):
        ctx.args = dict(causal=causal, scale=scale, q_offset=q_offset,
                        kv_len=kv_len, window=window)
        if not keeps_lse(q, k, v):
            ctx.save_for_backward(q, k, v)
            return _forward(q, k, v, causal, scale, q_offset, kv_len, window)
        out, lse, out_lo = _forward(q, k, v, causal, scale, q_offset, kv_len,
                                    window, for_grad=True)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, *kept = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd(q, k, v, grad, **ctx.args)
        else:
            out, lse, out_lo = kept if kept else (None, None, None)
            dq, dk, dv = _backward(q, k, v, grad, **ctx.args, out=out,
                                   lse=lse, out_lo=out_lo)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, None, None, None)
