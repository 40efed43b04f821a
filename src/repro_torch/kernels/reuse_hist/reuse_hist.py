"""Log2-binned reuse-distance histogram: the CUDA kernel's wrappers and
their plain PyTorch versions.

The kernel (``csrc/reuse_hist.cu``) replaces the TPU's
``repro/kernels/reuse_hist/reuse_hist.py::_moments_kernel`` and
``::_hist_kernel``; one kernel serves both, behind two wrappers:

* :func:`reuse_histogram_moments` — float64 ``[2, NUM_BINS]``: the
  weighted count per bin (row 0) and the weighted finite-distance mass
  per bin (row 1), the device side of the ``binned=True`` profile mode;
* :func:`reuse_histogram` — row 0 alone, float64 ``[NUM_BINS]``.

Bins follow the documented rule: bin 0 holds D < 0 (``INF_RD``, first
touch), bin 1 holds D = 0, and D >= 1 goes to its bit length
``1 + floor(log2 D)``, clamped to ``NUM_BINS - 1``.  The reference bins
through a float32 ``log2`` and lands one bin off at some powers of two
(D = 8192, 32768, 2^26, ...) and at D = 2^k - 1 for k >= 21 (ROADMAP
C2); the port follows the rule at every int64 distance.

Distances are integers: int64 is read as it is, other types are cast to
int64 (floats truncate).  With unit weights (``w=None``) counts and
masses are summed as integers and each bin is rounded to float64 once,
so the result is bit-reproducible and the kernel equals the plain
version bit for bit at every sum.  Weights are float32 (as in the
reference) and their sums are taken in double, in a fixed order on the
card, within rtol 1e-12 of the plain version.

``out=`` adds the histogram into a float64 tensor in place (the kernel
adds as it writes, so an accumulator costs no extra pass).

A wrapper given CPU tensors returns the plain version
(:func:`reuse_histogram_moments_plain`, :func:`reuse_histogram_plain`);
given CUDA tensors it launches the kernel and counts the launch in
:data:`LAUNCHES`, or raises.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.kernels import build, count_launch

NUM_BINS = 64

#: Kernel launches per entry point; only a wrapper's launch adds to it.
LAUNCHES = {"reuse_hist_moments": 0, "reuse_hist": 0}

_THREADS = 512          # threads per block (csrc/reuse_hist.cu kThreads)
_PER_THREAD = 8         # distances per thread before the grid is capped
_MAX_CTAS = 1024        # blocks: 7.75 per SM on 132 SMs, then grid-stride
_LIMB = (1 << 21) - 1   # limb of the exact integer mass


# --- plain PyTorch versions --------------------------------------------------


def bin_ids_plain(d: torch.Tensor) -> torch.Tensor:
    """Bin of every int64 distance: 0 for D < 0, 1 for D = 0, else the
    bit length of D clamped to ``NUM_BINS - 1`` (exact integer ops)."""
    x = d.clamp_min(0)
    bits = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >= (1 << s)
        bits += hi * s
        x = torch.where(hi, x >> s, x)
    bits += x > 0
    bits = torch.where(d == 0, 1, bits.clamp_max(NUM_BINS - 1))
    return torch.where(d < 0, 0, bits)


def _exact_mass(bins: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Per-bin sum of the non-negative distances, as exact integers rounded
    to float64 once.  Each distance is cut into three 21-bit limbs, whose
    per-bin sums stay below 2^53 (for fewer than 2^32 distances) and so
    are exact in any order; Python integers put them together."""
    x = d.clamp_min(0)
    limbs = [torch.bincount(bins, weights=((x >> s) & _LIMB).to(torch.float64),
                            minlength=NUM_BINS).tolist()
             for s in (0, 21, 42)]
    sums = [int(a) + (int(b) << 21) + (int(c) << 42) for a, b, c in zip(*limbs)]
    return torch.tensor([float(v) for v in sums], dtype=torch.float64,
                        device=d.device)


def _counts(bins: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    if w is None:
        return torch.bincount(bins, minlength=NUM_BINS).to(torch.float64)
    # (bincount of an empty input comes back int64 whatever the weights)
    return torch.bincount(bins, weights=w.to(torch.float64),
                          minlength=NUM_BINS).to(torch.float64)


def reuse_histogram_moments_plain(d: torch.Tensor, w: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """``[2, NUM_BINS]`` float64 counts and finite-distance mass, by
    ``torch.bincount`` over :func:`bin_ids_plain`; unit-weight sums are
    exact integers rounded once (:func:`_exact_mass`)."""
    d, w = _flat(d, w)
    bins = bin_ids_plain(d)
    if w is None:
        mass = _exact_mass(bins, d)
    else:
        mass = torch.bincount(
            bins, weights=w.to(torch.float64) * d.clamp_min(0).to(torch.float64),
            minlength=NUM_BINS).to(torch.float64)
    return torch.stack([_counts(bins, w), mass])


def reuse_histogram_plain(d: torch.Tensor, w: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """``[NUM_BINS]`` float64 weighted counts (row 0 of the moments)."""
    d, w = _flat(d, w)
    return _counts(bin_ids_plain(d), w)


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("reuse_hist")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.reuse_hist.argtypes = [vp, vp, ctypes.c_int64, ci, ci, vp, vp, vp, ci,
                               vp]
    lib.reuse_hist.restype = ci
    lib.reuse_hist_acc_bytes.argtypes = []
    lib.reuse_hist_acc_bytes.restype = ctypes.c_int64
    lib.reuse_hist_error_string.argtypes = [ci]
    lib.reuse_hist_error_string.restype = ctypes.c_char_p
    return lib


_ACC_LOCK = threading.Lock()
_ACCUMULATORS: dict[tuple, torch.Tensor] = {}


def _accumulator(device: torch.device) -> torch.Tensor:
    """The unit-weight kernel's integer accumulator for the current
    stream of ``device``: zeroed once, on that stream, when the stream
    first launches the kernel, and left at zero by every launch (its
    last block clears it).  Launches on one stream are ordered, so they
    can share it; a launch on another stream (another thread's, or a
    ``torch.cuda.stream`` block) gets an accumulator of its own."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device_index, stream.cuda_stream)
    with _ACC_LOCK:
        acc = _ACCUMULATORS.get(key)
        if acc is None:
            words = -(-_lib().reuse_hist_acc_bytes() // 8)
            acc = torch.zeros(words, dtype=torch.int64, device=device)
            _ACCUMULATORS[key] = acc
        return acc


def _flat(d, w):
    """Flat contiguous int64 distances and float32 weights (or None) on
    ``d``'s device; raises on what the kernel does not take."""
    if not isinstance(d, torch.Tensor):
        raise TypeError("d must be a tensor")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {d.device}")
    if d.dtype == torch.bool or d.is_complex():
        raise TypeError(f"d must hold integer distances, got {d.dtype}")
    d = d.reshape(-1).to(torch.int64).contiguous()
    if w is None:
        return d, None
    if not isinstance(w, torch.Tensor):
        raise TypeError("w must be a tensor or None")
    if w.device != d.device:
        raise ValueError(f"w is on {w.device}, d on {d.device}")
    if w.numel() != d.numel():
        raise ValueError(f"w has {w.numel()} entries, d has {d.numel()}")
    return d, w.reshape(-1).to(torch.float32).contiguous()


def ctas_for(n: int) -> int:
    """Blocks of the histogram pass for ``n`` distances (a function of
    ``n`` alone, so a stream is always cut the same way)."""
    return max(1, min(-(-n // (_THREADS * _PER_THREAD)), _MAX_CTAS))


def _check_out(out: torch.Tensor, shape: tuple, device) -> None:
    if not isinstance(out, torch.Tensor):
        raise TypeError("out must be a tensor")
    if (out.dtype != torch.float64 or tuple(out.shape) != shape
            or out.device != device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float64 tensor of shape "
                         f"{shape} on {device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")


def _histogram(d, w, moments: bool, out) -> torch.Tensor:
    d, w = _flat(d, w)
    shape = (2, NUM_BINS) if moments else (NUM_BINS,)
    if out is not None:
        _check_out(out, shape, d.device)
    if d.device.type == "cpu":
        plain = (reuse_histogram_moments_plain(d, w) if moments
                 else reuse_histogram_plain(d, w))
        return plain if out is None else out.add_(plain)
    n = d.numel()
    if n == 0:
        return (torch.zeros(shape, dtype=torch.float64, device=d.device)
                if out is None else out)
    accumulate = out is not None
    if out is None:
        out = torch.empty(shape, dtype=torch.float64, device=d.device)
    ctas = ctas_for(n)
    partials = acc = None
    if w is None:
        acc = _accumulator(d.device)
    else:
        partials = torch.empty((ctas, shape[0] * NUM_BINS),
                               dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        code = _lib().reuse_hist(
            d.data_ptr(), None if w is None else w.data_ptr(), n,
            int(moments), ctas,
            None if partials is None else partials.data_ptr(),
            None if acc is None else acc.data_ptr(),
            out.data_ptr(), int(accumulate), stream,
        )
    if code:
        msg = _lib().reuse_hist_error_string(code).decode()
        raise RuntimeError(f"reuse_hist launch failed: CUDA error {code} ({msg})")
    count_launch(LAUNCHES, "reuse_hist_moments" if moments else "reuse_hist")
    return out


def reuse_histogram_moments(d: torch.Tensor, w: torch.Tensor | None = None,
                            *, out: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Per-bin weighted counts (row 0) and weighted finite-distance mass
    (row 1) of a distance tensor: float64 ``[2, NUM_BINS]`` on its
    device.  ``w=None`` is unit weights (no weight array is read).  With
    ``out``, the histogram is added into it in place and it is returned."""
    return _histogram(d, w, True, out)


def reuse_histogram(d: torch.Tensor, w: torch.Tensor | None = None,
                    *, out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-bin weighted counts of a distance tensor: float64
    ``[NUM_BINS]`` on its device; bin 0 is the D = inf mass.  ``out`` as
    in :func:`reuse_histogram_moments`."""
    return _histogram(d, w, False, out)
