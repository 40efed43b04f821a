"""The MoE layer's expert pipeline without the host: the CUDA kernels'
wrappers and the plain PyTorch version of the whole pipeline.

The kernels (``csrc/moe.cu``) replace no Pallas kernel: the JAX package
leaves the expert products to XLA (``repro/models/moe.py::moe_apply``).
They were added because the port's loop over the experts
(``models/moe.py::_experts``) reads each expert's pair count on the host
(three syncs a layer, each draining the device's queue), launches about
seven operations an expert, and passes over device memory three more
times for the SwiGLU and the weighted combine.  The pipeline here keeps
every count, offset and size on the device, in four stages:

1. :func:`dispatch`: each expert's pairs and their exclusive prefix sum
   ``offs`` ``[E + 1]`` (int32), each (token, choice) pair's ``slot`` in
   expert order (stable: an expert's pairs in token order, as the loop's
   stable argsort) and ``xs``, x's rows gathered in that order;
2. :func:`grouped_swiglu`: ``h = silu(xs wg[e]) * (xs wi[e])`` for every
   expert's rows in one launch of the grouped GEMM, the SwiGLU in its
   epilogue (``g``, ``i`` and ``silu(g)`` are never stored);
3. :func:`grouped_down`: ``yp = h wo[e]``, the same kernel, rounded to
   x's dtype as ``torch.matmul``'s output is;
4. :func:`combine`: per token, its pairs in expert order, ``sum of
   bf16(gate) * yp[slot]`` in f32, cast to x's dtype: the reference's two
   rounding points (the gate rounded to x's dtype, the sum in f32), and
   the loop's order of the sum.

The bound: the two GEMMs do 6·d·f operations a pair (:func:`gemm_ops`):
at mixtral's d 4,096 and f 14,336 and the long prompts' 8,960 pairs a
layer, 3.16e12, 3.2 ms at 989 TFLOP/s.  The GEMM kernel is a persistent
grid of one block an SM, in clusters of two that share the A tile, over
every expert's tiles of 128 rows: a ring of TMA loads and two warpgroups
on ``wgmma``; ``csrc/moe.cu`` states its design.

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches its kernel and counts the launch in :data:`LAUNCHES`, or
raises.  The kernels take bf16 alone, K a multiple of 64
(:func:`supports`).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

from repro_torch.kernels import build, count_launch

#: Kernel launches: ``moe_gemm`` counts each grouped GEMM (two a layer),
#: ``moe_dispatch`` and ``moe_combine`` one each a layer.
LAUNCHES = {"moe_dispatch": 0, "moe_gemm": 0, "moe_combine": 0}

#: Most experts and most choices a token the kernels take: the sizes of
#: their shared-memory tables, ``kMaxExperts`` and ``kMaxK`` in
#: ``csrc/moe.cu``, whose entry points reject larger ones.
MAX_EXPERTS, MAX_K = 128, 8


def supports(d: int, f: int, experts: int, k: int) -> bool:
    """The shapes the kernels take: both GEMMs' depths (d, f) multiples
    of 64, at most :data:`MAX_EXPERTS` experts and :data:`MAX_K` choices."""
    return (d % 64 == 0 and f % 64 == 0 and experts <= MAX_EXPERTS
            and k <= MAX_K)


def gemm_ops(pairs: int, d: int, f: int) -> float:
    """The two grouped GEMMs' operations: 2·d·f a pair for each of the
    gate, up and down products."""
    return 6.0 * pairs * d * f


# --- plain PyTorch version ---------------------------------------------------


def dispatch_plain(xt, idx, experts: int):
    """``(offs [E + 1] int32, slot [T k] int32, xs [T k, d])``: the
    offsets of each expert's pairs in expert order, each pair's place in
    that order (stable) and x's rows in it."""
    k = idx.shape[1]
    e = idx.flatten()
    offs = torch.zeros(experts + 1, dtype=torch.int32, device=xt.device)
    offs[1:] = torch.bincount(e, minlength=experts).cumsum(0)
    order = torch.argsort(e, stable=True)
    slot = torch.empty_like(order, dtype=torch.int32)
    slot[order] = torch.arange(len(order), dtype=torch.int32,
                               device=xt.device)
    return offs, slot, xt[order // k]


def _groups(offs):
    bounds = offs.tolist()
    return [(ex, a, b) for ex, (a, b) in enumerate(zip(bounds, bounds[1:]))
            if b > a]


def grouped_swiglu_plain(xs, offs, wg, wi):
    """``h [P, f]`` in xs's dtype: each expert's rows through
    ``silu(xs wg[e]) * (xs wi[e])``, computed in f32 and rounded once,
    as the kernel's epilogue does."""
    h = torch.empty(xs.shape[0], wg.shape[-1], dtype=xs.dtype,
                    device=xs.device)
    for ex, a, b in _groups(offs):
        xe = xs[a:b].float()
        h[a:b] = (F.silu(xe @ wg[ex].float()) * (xe @ wi[ex].float())).to(
            xs.dtype)
    return h


def grouped_down_plain(h, offs, wo):
    """``yp [P, d]`` in h's dtype: each expert's rows times ``wo[e]``,
    summed in f32 and rounded once."""
    yp = torch.empty(h.shape[0], wo.shape[-1], dtype=h.dtype,
                     device=h.device)
    for ex, a, b in _groups(offs):
        yp[a:b] = (h[a:b].float() @ wo[ex].float()).to(h.dtype)
    return yp


def combine_plain(yp, slot, gate, idx):
    """``y [T, d]`` in yp's dtype: each token's pairs in expert order,
    ``bf16(gate) * yp[slot]`` summed in f32 from 0, then cast."""
    t, k = idx.shape
    order = idx.argsort(dim=1)
    rows = slot.view(t, k).long().gather(1, order)
    w = gate.to(yp.dtype).float().gather(1, order)
    y = torch.zeros(t, yp.shape[1], dtype=torch.float32, device=yp.device)
    for j in range(k):
        y += yp[rows[:, j]].float() * w[:, j:j + 1]
    return y.to(yp.dtype)


def experts_plain(xt, gate, idx, wi, wg, wo):
    """The whole pipeline in torch ops: ``(y [T, d] in xt's dtype, offs)``."""
    offs, slot, xs = dispatch_plain(xt, idx, wi.shape[0])
    h = grouped_swiglu_plain(xs, offs, wg, wi)
    return combine_plain(grouped_down_plain(h, offs, wo), slot, gate,
                         idx), offs


# --- the CUDA kernels --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("moe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.moe_dispatch.argtypes = [vp] * 5 + [ci] * 4 + [vp]
    lib.moe_dispatch.restype = ci
    lib.moe_gemm.argtypes = [ci] + [vp] * 5 + [ci] * 4 + [vp]
    lib.moe_gemm.restype = ci
    lib.moe_combine.argtypes = [vp] * 5 + [ci] * 3 + [vp]
    lib.moe_combine.restype = ci
    lib.moe_error_string.argtypes = [ci]
    lib.moe_error_string.restype = ctypes.c_char_p
    return lib


def _on_card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain version), True for CUDA tensors of
    the kernel's kinds; raises for anything else."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on several devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def _check(name: str, code: int) -> None:
    if code:
        msg = _lib().moe_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: error {code} ({msg})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def dispatch(xt, idx, experts: int):
    """``(offs, slot, xs)`` as :func:`dispatch_plain`; on the card two
    small kernels (the counts, offsets and slots in one block, then the
    row gather), one entry in :data:`LAUNCHES`."""
    if not _on_card("moe_dispatch", xt, idx):
        return dispatch_plain(xt, idx, experts)
    t, d = xt.shape
    k = idx.shape[1]
    if xt.dtype != torch.bfloat16 or idx.dtype != torch.int64 \
            or idx.shape[0] != t:
        raise ValueError("moe_dispatch takes bf16 x [T, d] and int64 idx "
                         "[T, k]")
    dev = xt.device
    offs = torch.empty(experts + 1, dtype=torch.int32, device=dev)
    slot = torch.empty(t * k, dtype=torch.int32, device=dev)
    xs = torch.empty(t * k, d, dtype=xt.dtype, device=dev)
    with torch.cuda.device(dev):
        _check("moe_dispatch", _lib().moe_dispatch(
            idx.data_ptr(), xt.data_ptr(), offs.data_ptr(), slot.data_ptr(),
            xs.data_ptr(), t, k, d, experts, _stream(dev)))
    count_launch(LAUNCHES, "moe_dispatch")
    return offs, slot, xs


def _gemm(mode: int, a, offs, b0, b1, n: int):
    experts, depth, _ = b0.shape
    rows = a.shape[0]
    if a.dtype != torch.bfloat16 or b0.dtype != torch.bfloat16 \
            or b1.dtype != torch.bfloat16 or offs.dtype != torch.int32:
        raise ValueError("moe_gemm takes bf16 operands and int32 offsets")
    if a.shape[1] != depth or depth % 64 or n % 8 \
            or offs.shape != (experts + 1,):
        raise ValueError(f"moe_gemm: a {tuple(a.shape)}, weights "
                         f"{tuple(b0.shape)}: the depth must match and be a "
                         "multiple of 64")
    dev = a.device
    out = torch.empty(rows, n, dtype=a.dtype, device=dev)
    with torch.cuda.device(dev):
        _check("moe_gemm", _lib().moe_gemm(
            mode, a.data_ptr(), b0.data_ptr(), b1.data_ptr(),
            offs.data_ptr(), out.data_ptr(), rows, depth, n, experts,
            _stream(dev)))
    count_launch(LAUNCHES, "moe_gemm")
    return out


def grouped_swiglu(xs, offs, wg, wi):
    """``h [P, f]`` as :func:`grouped_swiglu_plain`; on the card one
    launch of the grouped GEMM, the SwiGLU in its epilogue."""
    if not _on_card("moe_gemm", xs, offs, wg, wi):
        return grouped_swiglu_plain(xs, offs, wg, wi)
    if wi.shape != wg.shape:
        raise ValueError("wg and wi must have one shape")
    return _gemm(0, xs, offs, wg, wi, wg.shape[-1])


def grouped_down(h, offs, wo):
    """``yp [P, d]`` as :func:`grouped_down_plain`; on the card one launch
    of the grouped GEMM."""
    if not _on_card("moe_gemm", h, offs, wo):
        return grouped_down_plain(h, offs, wo)
    return _gemm(1, h, offs, wo, wo, wo.shape[-1])


def combine(yp, slot, gate, idx):
    """``y [T, d]`` as :func:`combine_plain`; on the card one pass, a block
    a token, with no atomics (a fixed order)."""
    if not _on_card("moe_combine", yp, slot, gate, idx):
        return combine_plain(yp, slot, gate, idx)
    t, k = idx.shape
    d = yp.shape[1]
    if yp.dtype != torch.bfloat16 or gate.dtype != torch.float32 \
            or idx.dtype != torch.int64 or slot.dtype != torch.int32 \
            or gate.shape != (t, k) or d % 8:
        raise ValueError("moe_combine takes bf16 yp, int32 slot, f32 gate "
                         "and int64 idx [T, k]")
    y = torch.empty(t, d, dtype=yp.dtype, device=yp.device)
    with torch.cuda.device(yp.device):
        _check("moe_combine", _lib().moe_combine(
            yp.data_ptr(), slot.data_ptr(), gate.data_ptr(), idx.data_ptr(),
            y.data_ptr(), t, k, d, _stream(yp.device)))
    count_launch(LAUNCHES, "moe_combine")
    return y


def experts(xt, gate, idx, wi, wg, wo):
    """The whole pipeline: ``(y [T, d] in xt's dtype, offs)``; on the card
    five kernels (four entries of :data:`LAUNCHES`) and no host sync."""
    offs, slot, xs = dispatch(xt, idx, wi.shape[0])
    h = grouped_swiglu(xs, offs, wg, wi)
    return combine(grouped_down(h, offs, wo), slot, gate.contiguous(),
                   idx), offs
