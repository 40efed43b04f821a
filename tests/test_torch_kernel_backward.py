"""The plain versions of kernels B4's and B5's backward kernels — what
their ``autograd.Function``s run on the CPU and what the card's kernels
are held to — against ``jax.vjp`` of the JAX package's functions, on the
same numpy-seeded inputs, and the meta device's one op per backward
launch (what a dry-run records).

B5: ``ssd_scan_bwd_plain`` (the backward kernel's algorithm in torch
ops) against ``jax.vjp`` of ``repro.models.ssm.ssd_chunked`` in f32 (an
initial state, a final-state cotangent, sequence lengths that are not a
multiple of 64) and against autograd through ``ssd_scan_plain``.  B4:
``flash_attention_bwd`` (the closed form) against ``jax.vjp`` of
``repro.kernels.flash_attention.ref.attention_ref`` at Sq = Sk (where
the Pallas kernel's top-left causal alignment and the oracle's agree,
ROADMAP C1) and of ``repro.models.attention._sdpa_dense`` with the
reference's position masks for the window and the offset / ``kv_len``
cases.

Bound: each gradient's max |port - reference| over its largest |value|,
1e-5 in f32: the same function summed in other orders (the port's
chunks of 64 against the reference's chunk that divides S; masked
scores exponentiated to 0 or carried as -1e30 against jnp's own order).
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.flash_attention.ref import attention_ref
from repro.models.attention import _sdpa_dense
from repro.models.ssm import ssd_chunked
from repro_torch.analysis import aten_trace
from repro_torch.kernels import META_OPS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as scan

TOL = 1e-5


def assert_scaled_close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- B5 ---------------------------------------------------------------------


def ssd_inputs(bsz, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((bsz, s, h))).astype(
        np.float32)
    b = (rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((bsz, h, n, p)).astype(np.float32)
    gy = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    gf = rng.standard_normal((bsz, h, n, p)).astype(np.float32)
    return x, la, b, c, h0, gy, gf


@pytest.mark.parametrize("bsz,s,h,p,n,with_h0,with_final", [
    (2, 100, 3, 8, 16, True, True),    # ragged last chunk
    (1, 200, 2, 16, 8, False, True),   # four chunks, the last ragged
    (2, 128, 2, 4, 4, True, False),    # whole chunks, no final cotangent
    (1, 37, 1, 8, 4, False, False),    # one short chunk
], ids=["ragged", "four-chunks", "whole-chunks", "short"])
def test_ssd_scan_bwd_plain_matches_jax_vjp_of_ssd_chunked(
        bsz, s, h, p, n, with_h0, with_final):
    x, la, b, c, h0, gy, gf = ssd_inputs(bsz, s, h, p, n, seed=s + n)
    h0 = h0 if with_h0 else None
    gf = gf if with_final else None

    def ref(x, la, b, c, *state0):
        return ssd_chunked(x, la, b, c, 64, *state0)

    primals = (x, la, b, c) + ((h0,) if with_h0 else ())
    (y, final), vjp = jax.vjp(ref, *map(jnp.asarray, primals))
    want = vjp((jnp.asarray(gy), jnp.zeros_like(final) if gf is None
                else jnp.asarray(gf)))
    got = scan.ssd_scan_bwd_plain(
        t(x), t(la), t(b), t(c), None if h0 is None else t(h0), t(gy),
        None if gf is None else t(gf))
    assert (got[4] is None) == (h0 is None)
    for g, w in zip([g for g in got if g is not None], want):
        assert_scaled_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("with_h0,with_final", [(True, True), (False, False),
                                                (True, False)])
def test_ssd_scan_bwd_plain_matches_autograd_of_the_plain_scan(with_h0,
                                                               with_final):
    x, la, b, c, h0, gy, gf = map(t, ssd_inputs(2, 150, 3, 8, 5, seed=7))
    inputs = [x, la, b, c] + ([h0] if with_h0 else [])
    leaves = [a.clone().requires_grad_() for a in inputs]
    y, final = scan.ssd_scan_plain(*leaves[:4],
                                   leaves[4] if with_h0 else None)
    outs, gouts = ((y, final), (gy, gf)) if with_final else ((y,), (gy,))
    want = torch.autograd.grad(outs, leaves, gouts)
    got = scan.ssd_scan_bwd_plain(x, la, b, c, h0 if with_h0 else None, gy,
                                  gf if with_final else None)
    for g, w in zip([g for g in got if g is not None], want):
        assert_scaled_close(g.numpy(), w.numpy())


# --- B4 ---------------------------------------------------------------------


def attention_inputs(b, h, hkv, sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sq, d)).astype(np.float32))


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (2, 4, 4, 96, 16, True),
    (1, 8, 2, 130, 32, True),     # GQA, ragged tiles
    (2, 4, 1, 64, 64, False),     # MQA, not causal
])
def test_flash_attention_bwd_matches_jax_vjp_of_attention_ref(b, h, hkv, s,
                                                              d, causal):
    q, k, v, g = attention_inputs(b, h, hkv, s, s, d, seed=s + d)
    _, vjp = jax.vjp(lambda q, k, v: attention_ref(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = fa.flash_attention_bwd(t(q), t(k), t(v), t(g), causal=causal)
    for a, w in zip(got, want):
        assert_scaled_close(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("h,hkv,sq,sk,d,q_offset,kv_len,window", [
    (4, 2, 100, 100, 16, 0, 100, 20),     # sliding window, self-attention
    (4, 4, 9, 40, 32, 20, 29, None),      # a chunk into a partly full cache
    (2, 1, 1, 64, 16, 40, 41, None),      # a decode step
    (4, 2, 30, 90, 16, 50, 80, 24),       # window on the cache path
], ids=["window", "chunk", "decode", "window-cache"])
def test_flash_attention_bwd_matches_jax_vjp_of_sdpa_dense(
        h, hkv, sq, sk, d, q_offset, kv_len, window):
    """The reference's cache path: positions ``q_offset + arange(Sq)``
    over a ``Sk``-row cache whose first ``kv_len`` rows are valid; its
    dense attention takes K/V at q's heads, so a kv head's gradient is the
    sum over its group."""
    b, rep = 2, h // hkv
    q, k, v, g = attention_inputs(b, h, hkv, sq, sk, d, seed=sq + sk)
    q_pos = np.broadcast_to(q_offset + np.arange(sq), (b, sq))
    kv_pos = np.broadcast_to(np.arange(sk), (b, sk))

    def ref(q, k, v):   # [B,S,H,hd] layouts
        return _sdpa_dense(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
            q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
            kv_valid=jnp.asarray(kv_pos < kv_len), causal=True,
            window=window)

    def bshd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3))

    _, vjp = jax.vjp(ref, bshd(q), bshd(k), bshd(v))
    want = vjp(bshd(g))
    got = fa.flash_attention_bwd(t(q), t(k), t(v), t(g), causal=True,
                                 q_offset=q_offset, kv_len=kv_len,
                                 window=window)
    for a, w in zip(got, want):
        assert_scaled_close(a.numpy(), np.asarray(w).transpose(0, 2, 1, 3))


# --- the meta device: one op per backward launch ------------------------------


class OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, args))
        return func(*args, **(kwargs or {}))


def backward_ops(fn, leaves, cotangents):
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    with OpLog() as log:
        torch.autograd.grad(outs[:len(cotangents)], leaves, cotangents)
    return [(f.overloadpacket.__name__, a) for f, a in log.ops
            if f.namespace == "repro_torch"]


def test_meta_backward_is_one_op_each():
    """On meta (an abstract step) each backward is one op whose
    ``META_OPS`` entry is the backward's operation count; B4's counts
    the visible pairs only."""
    def meta(*shape):
        return torch.empty(*shape, device="meta", requires_grad=True)

    x, la, b, c, h0 = (meta(2, 130, 3, 8), meta(2, 130, 3), meta(2, 130, 16),
                       meta(2, 130, 16), meta(2, 3, 16, 8))
    ops = backward_ops(scan.ssd_scan, (x, la, b, c, h0),
                       (torch.empty(2, 130, 3, 8, device="meta"),
                        torch.empty(2, 3, 16, 8, device="meta")))
    assert [name for name, _ in ops] == ["ssd_scan_bwd"]
    assert META_OPS["ssd_scan_bwd"](ops[0][1], {}) == \
        scan.scan_bwd_ops(2, 130, 3, 8, 16) == \
        2 * scan.scan_ops(2, 130, 3, 8, 16)

    q, k, v = meta(2, 4, 40, 16), meta(2, 2, 90, 16), meta(2, 2, 90, 16)
    kw = dict(causal=True, q_offset=50, kv_len=80, window=24)
    ops = backward_ops(lambda q, k, v: fa.flash_attention(q, k, v, **kw),
                       (q, k, v), (torch.empty(2, 4, 40, 16, device="meta"),))
    assert [name for name, _ in ops] == ["flash_attention_bwd"]
    rows = np.arange(40)
    pairs = (np.minimum(80, 50 + rows + 1)
             - np.maximum(0, 50 + rows - 24 + 1)).sum()
    assert META_OPS["flash_attention_bwd"](ops[0][1], {}) == \
        fa.attention_bwd_ops(2, 4, 40, 16, **kw) == 10.0 * 16 * pairs * 8


def recorded_peak(fn, leaves, cotangents) -> int:
    """The peak live bytes of a recording of the backward alone."""
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return aten_trace.record(lambda: torch.autograd.grad(
        outs[:len(cotangents)], leaves, cotangents), {}).peak_bytes


@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention"])
def test_meta_backward_holds_the_kernels_scratch(kernel, monkeypatch):
    """A recording of a meta backward peaks with the backward kernel's f32
    scratch live beside its gradients, as the card holds them during the
    launch: without the scratch the peak is lower by exactly its bytes
    (B5: the states entering the chunks and the db/dc and ds partials of
    every block of 64 state columns; B4: each q row's two statistics)."""
    def meta(*shape):
        return torch.empty(*shape, device="meta", requires_grad=True)

    mod = importlib.import_module(f"repro_torch.kernels.{kernel}.{kernel}")
    if kernel == "ssd_scan":
        bsz, s, h, p, n = 2, 130, 3, 8, 16
        chunks, blocks = 3, 3
        scratch = 4 * (bsz * h * chunks * n * p
                       + 2 * bsz * blocks * chunks * 64 * n
                       + bsz * blocks * chunks * 64)
        args = ((meta(bsz, s, h, p), meta(bsz, s, h), meta(bsz, s, n),
                 meta(bsz, s, n), meta(bsz, h, n, p)),
                (torch.empty(bsz, s, h, p, device="meta"),
                 torch.empty(bsz, h, n, p, device="meta")))
        fn, name = scan.ssd_scan, "_bwd_scratch"
    else:
        scratch = 4 * 2 * 2 * 4 * 40
        args = ((meta(2, 4, 40, 16), meta(2, 2, 90, 16), meta(2, 2, 90, 16)),
                (torch.empty(2, 4, 40, 16, device="meta"),))
        fn, name = (lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
                    "_bwd_stats")
    with_scratch = recorded_peak(fn, *args)
    monkeypatch.setattr(mod, name, lambda *a: None)
    assert with_scratch - recorded_peak(fn, *args) == scratch
