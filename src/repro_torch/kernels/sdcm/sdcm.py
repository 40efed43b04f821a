"""SDCM hit probability (paper Eq. 1) and its Eq. 3 row fold: the CUDA
kernel's wrappers and their plain PyTorch versions.

The kernel (``csrc/sdcm.cu``) replaces the TPU's
``repro/kernels/sdcm/sdcm.py::_sdcm_kernel`` and the vmapped grid form
``repro/api/batched.py::_phit_row``.  Three entry points share one
device function:

* :func:`sdcm_rates_ragged` — the Eq. 3 rate of every row of a ragged
  grid (rows back to back at their own lengths, a ``[R, 5]`` record of
  offset, length, A, B and A_MAX bucket per row) in one launch: what
  ``api/batched.py::batched_hit_rates`` launches, once per predict;
* :func:`sdcm_rates` — ``rates[g] = sum_m probs[g, m] P(h | d[g, m])``
  with per-row ``assoc[g]``/``blocks[g]``: one padded row-shape group;
* :func:`sdcm_hit_probs` — ``P(h | d[i])`` for a flat float32 distance
  stream at one geometry: what ``_sdcm_kernel`` computes.

A wrapper checks device, dtype, shape and contiguity.  For CPU tensors
it returns the plain version (:func:`sdcm_rates_ragged_plain`,
:func:`sdcm_rates_plain`, :func:`sdcm_hit_probs_plain`); for CUDA tensors
it launches the kernel and counts the launch in :data:`LAUNCHES`, or
raises.  A row gives the same bits in the ragged and the padded form.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, count_launch

#: A_MAX buckets the kernel is instantiated for (run-time A <= A_MAX).
A_BUCKETS = (8, 16, 32, 64)

#: Kernel launches per entry point; only a wrapper's launch adds to it.
LAUNCHES = {"sdcm_rates_ragged": 0, "sdcm_rates": 0, "sdcm_hit_probs": 0}

#: Columns of the ragged form's per-row record (csrc/sdcm.cu kMetaWidth).
META_COLUMNS = ("offset", "length", "assoc", "blocks", "a_max")


def pow2(n: int) -> int:
    """The power of two padded row counts and widths round up to (>= 2)."""
    return 1 << max(n - 1, 1).bit_length()


def a_max_bucket(assoc: int, blocks: int) -> int:
    """The A_MAX bucket a geometry runs under; fully-associative
    geometries take the exact stack rule and share the smallest."""
    if assoc >= blocks:
        return A_BUCKETS[0]
    for b in A_BUCKETS:
        if assoc <= b:
            return b
    raise ValueError(
        f"set-associativity {assoc} exceeds the SDCM kernel's "
        f"A_MAX={A_BUCKETS[-1]} (fully-associative levels are fine)"
    )


# --- plain PyTorch versions --------------------------------------------------


def phit_plain(d: torch.Tensor, assoc: torch.Tensor, blocks: torch.Tensor,
               a_max: int) -> torch.Tensor:
    """P(h | D) elementwise in float64; ``assoc``/``blocks`` broadcast
    against ``d``.  The kernel's maths, term for term."""
    d = d.to(torch.float64)
    assoc = assoc.to(torch.float64)
    blocks = blocks.to(torch.float64)
    df = d.clamp_min(0.0)
    p = (assoc / blocks).clamp(1e-30, 1.0 - 1e-7)
    log_p, log_1mp = torch.log(p), torch.log1p(-p)
    acc = torch.exp(df * log_1mp)
    log_comb = torch.zeros_like(acc)
    for k in range(1, a_max):
        log_comb = log_comb + (
            torch.log((df - (k - 1.0)).clamp_min(1e-30)) - math.log(k)
        )
        term = torch.exp(log_comb + k * log_p + (df - k) * log_1mp)
        acc = acc + torch.where((k < assoc) & (k <= df), term, 0.0)
    out = torch.where(assoc > a_max, math.nan, acc.clamp_max(1.0))
    out = torch.where(df <= assoc - 1.0, 1.0, out)
    out = torch.where(assoc >= blocks, (df < blocks).to(out.dtype), out)
    return torch.where(d < 0, 0.0, out)


def sdcm_rates_plain(d, probs, assoc, blocks, a_max: int) -> torch.Tensor:
    """Eq. 3 per row: ``(probs * P(h|d)).sum(-1)`` in float64."""
    phit = phit_plain(d, assoc[:, None], blocks[:, None], a_max)
    return (probs * phit).sum(dim=-1)


def sdcm_rates_ragged_plain(d, probs, meta) -> torch.Tensor:
    """The ragged form as the padded form's plain version: rows grouped
    by (A_MAX bucket, ``pow2(length)``), each group padded as
    ``api/batched.py::pack_grid`` pads it (row count to a power of two,
    inert rows of A = 1, B = 2) and folded by :func:`sdcm_rates_plain`.
    Rows the kernel gives NaN for (a record out of range or with no
    bucket) are NaN here too."""
    dev = d.device
    recs = meta.tolist()
    rates = torch.full((len(recs),), math.nan, dtype=torch.float64, device=dev)
    groups: dict[tuple[int, int], list[int]] = {}
    for r, (off, length, _a, _b, a_max) in enumerate(recs):
        if a_max in A_BUCKETS and 0 <= off and 0 <= length <= d.numel() - off:
            groups.setdefault((int(a_max), pow2(max(int(length), 1))),
                              []).append(r)
    for (a_max, m), idx in groups.items():
        g = pow2(len(idx))
        rec = torch.tensor([recs[r] for r in idx], dtype=torch.float64)
        off, length = rec[:, 0].long(), rec[:, 1].long()
        cols = torch.arange(m)
        inside = cols[None, :] < length[:, None]
        at = (off[:, None] + cols[None, :]).clamp(0, max(d.numel() - 1, 0))
        grid_d = torch.zeros((g, m), dtype=torch.float64, device=dev)
        grid_p = torch.zeros((g, m), dtype=torch.float64, device=dev)
        inside, at = inside.to(dev), at.to(dev)
        if d.numel():
            grid_d[:len(idx)] = torch.where(inside, d[at], 0.0)
            grid_p[:len(idx)] = torch.where(inside, probs[at], 0.0)
        assoc = torch.ones(g, dtype=torch.float64, device=dev)
        blocks = torch.full((g,), 2.0, dtype=torch.float64, device=dev)
        assoc[:len(idx)] = rec[:, 2].to(dev)
        blocks[:len(idx)] = rec[:, 3].to(dev)
        out = sdcm_rates_plain(grid_d, grid_p, assoc, blocks, a_max)
        rates[torch.tensor(idx, device=dev)] = out[:len(idx)]
    return rates


def sdcm_hit_probs_plain(d, assoc: int, blocks: int) -> torch.Tensor:
    """P(h | D) of a flat distance stream at one geometry (float32)."""
    a_max = a_max_bucket(assoc, blocks)
    a = torch.tensor(float(assoc), dtype=torch.float64, device=d.device)
    b = torch.tensor(float(blocks), dtype=torch.float64, device=d.device)
    return phit_plain(d, a, b, a_max).to(torch.float32)


# --- the CUDA kernel ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("sdcm")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.sdcm_rates.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
    lib.sdcm_rates.restype = ci
    lib.sdcm_rates_ragged.argtypes = [vp, vp, vp, ctypes.c_int64, vp, ci, vp]
    lib.sdcm_rates_ragged.restype = ci
    lib.sdcm_hit_probs.argtypes = [
        vp, vp, ctypes.c_int64, ctypes.c_double, ctypes.c_double, ci, vp,
    ]
    lib.sdcm_hit_probs.restype = ci
    lib.sdcm_error_string.argtypes = [ci]
    lib.sdcm_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(code: int, what: str) -> None:
    if code:
        msg = _lib().sdcm_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _device_of(t: torch.Tensor) -> torch.device:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def sdcm_rates(d: torch.Tensor, probs: torch.Tensor, assoc: torch.Tensor,
               blocks: torch.Tensor, a_max: int) -> torch.Tensor:
    """Eq. 3 hit rate of every row of a padded profile grid.

    ``d``, ``probs``: float64 [G, M]; ``assoc``, ``blocks``: float64
    [G]; ``a_max``: the rows' A_MAX bucket.  Returns float64 [G].  A
    set-associative row with ``assoc > a_max`` comes back NaN.
    """
    dev = _device_of(d)
    if d.dim() != 2:
        raise ValueError(f"d must be 2-D [G, M], got shape {tuple(d.shape)}")
    g, m = d.shape
    _check("d", d, torch.float64, (g, m), dev)
    _check("probs", probs, torch.float64, (g, m), dev)
    _check("assoc", assoc, torch.float64, (g,), dev)
    _check("blocks", blocks, torch.float64, (g,), dev)
    if a_max not in A_BUCKETS:
        raise ValueError(f"a_max must be one of {A_BUCKETS}, got {a_max}")
    if dev.type == "cpu":
        return sdcm_rates_plain(d, probs, assoc, blocks, a_max)
    rates = torch.empty(g, dtype=torch.float64, device=dev)
    if g == 0 or m == 0:
        return rates.zero_()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sdcm_rates(
            d.data_ptr(), probs.data_ptr(), assoc.data_ptr(),
            blocks.data_ptr(), rates.data_ptr(), g, m, a_max, stream,
        )
    _raise_on(code, "sdcm_rates launch")
    count_launch(LAUNCHES, "sdcm_rates")
    return rates


def sdcm_rates_ragged(d: torch.Tensor, probs: torch.Tensor,
                      meta: torch.Tensor) -> torch.Tensor:
    """Eq. 3 hit rate of every row of a ragged profile grid, in one
    launch.

    ``d``, ``probs``: float64 [T], the rows back to back; ``meta``:
    float64 [R, 5], per row (offset, length, assoc, blocks, a_max) as in
    :data:`META_COLUMNS`.  Returns float64 [R].  A row whose record lies
    outside ``[0, T)``, names no bucket of :data:`A_BUCKETS`, or is
    set-associative with ``assoc > a_max`` comes back NaN.  On the card
    the records are read by the kernel, not checked on the host (that
    would wait for the copy).
    """
    dev = _device_of(d)
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D [T], got shape {tuple(d.shape)}")
    (t,) = d.shape
    _check("d", d, torch.float64, (t,), dev)
    _check("probs", probs, torch.float64, (t,), dev)
    if meta.dim() != 2:
        raise ValueError(f"meta must be 2-D [R, {len(META_COLUMNS)}], "
                         f"got shape {tuple(meta.shape)}")
    _check("meta", meta, torch.float64, (meta.shape[0], len(META_COLUMNS)),
           dev)
    rows = meta.shape[0]
    if dev.type == "cpu":
        return sdcm_rates_ragged_plain(d, probs, meta)
    rates = torch.empty(rows, dtype=torch.float64, device=dev)
    if rows == 0:
        return rates
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sdcm_rates_ragged(
            d.data_ptr(), probs.data_ptr(), meta.data_ptr(), t,
            rates.data_ptr(), rows, stream,
        )
    _raise_on(code, "sdcm_rates_ragged launch")
    count_launch(LAUNCHES, "sdcm_rates_ragged")
    return rates


def sdcm_hit_probs(d: torch.Tensor, assoc: int, blocks: int) -> torch.Tensor:
    """P(h | D) for a flat float32 distance tensor (-1 = first touch)
    on an ``assoc``-way cache of ``blocks`` lines.  Returns float32."""
    dev = _device_of(d)
    if d.dim() != 1:
        raise ValueError(f"d must be 1-D, got shape {tuple(d.shape)}")
    _check("d", d, torch.float32, tuple(d.shape), dev)
    assoc, blocks = int(assoc), int(blocks)
    if assoc < 1 or blocks < 1:
        raise ValueError("assoc and blocks must be >= 1")
    a_max = a_max_bucket(assoc, blocks)
    if dev.type == "cpu":
        return sdcm_hit_probs_plain(d, assoc, blocks)
    out = torch.empty_like(d)
    if d.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = _lib().sdcm_hit_probs(
            d.data_ptr(), out.data_ptr(), d.numel(), float(assoc),
            float(blocks), a_max, stream,
        )
    _raise_on(code, "sdcm_hit_probs launch")
    count_launch(LAUNCHES, "sdcm_hit_probs")
    return out
