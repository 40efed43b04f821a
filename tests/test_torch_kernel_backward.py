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
cases.  Also B4's log-sum-exp-and-Delta form (what the tensor-core
kernel computes from the forward's output and log-sum-exp) against the
closed form and the same references, the plain forward's log-sum-exp
against ``torch.logsumexp`` of the masked scores, and B5's phase form
(chunk increments, the two passes over chunks, chunk gradients) with b
and c in bf16 and at widths that are no multiple of 4.

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
# the module (its package exports functions of the same names)
FAM = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")


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


@pytest.mark.parametrize("bsz,s,h,p,n,with_h0,with_final", [
    (2, 130, 2, 6, 5, True, True),     # odd widths, ragged, both states
    (1, 191, 3, 10, 12, True, False),  # three chunks, the last 63 long
    (2, 65, 1, 3, 7, False, True),     # a one-step last chunk
], ids=["odd-widths", "three-chunks", "one-step-tail"])
def test_ssd_scan_bwd_plain_phases_match_jax_vjp(bsz, s, h, p, n, with_h0,
                                                 with_final):
    """The phase form at widths the kernel's column blocks and scratch
    pad (P and N no multiple of 4) and at chunk tails of 63 and 1 steps,
    against ``jax.vjp`` of ``ssd_chunked``."""
    x, la, b, c, h0, gy, gf = ssd_inputs(bsz, s, h, p, n, seed=s * n + p)
    h0 = h0 if with_h0 else None
    primals = (x, la, b, c) + ((h0,) if with_h0 else ())
    (_, final), vjp = jax.vjp(
        lambda x, la, b, c, *st: ssd_chunked(x, la, b, c, 64, *st),
        *map(jnp.asarray, primals))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf) if with_final
                else jnp.zeros_like(final)))
    got = scan.ssd_scan_bwd_plain(
        t(x), t(la), t(b), t(c), None if h0 is None else t(h0), t(gy),
        t(gf) if with_final else None)
    for g, w in zip([g for g in got if g is not None], want):
        assert_scaled_close(g.numpy(), np.asarray(w))


def test_ssd_scan_bwd_plain_carries_across_chunks():
    """la at 1 % of ``ssd_inputs``' (a chunk's decay ~0.6, not ~e^-45), so
    that the states and state gradients that the two passes carry from
    chunk to chunk set the gradients: the phase form against ``jax.vjp``
    of ``ssd_chunked``, with ``h0`` and a final-state cotangent."""
    x, la, b, c, h0, gy, gf = ssd_inputs(2, 300, 2, 8, 6, seed=5)
    la = la * 0.01
    _, vjp = jax.vjp(lambda *a: ssd_chunked(*a[:4], 64, a[4]),
                     *map(jnp.asarray, (x, la, b, c, h0)))
    want = vjp((jnp.asarray(gy), jnp.asarray(gf)))
    got = scan.ssd_scan_bwd_plain(*map(t, (x, la, b, c, h0, gy, gf)))
    for g, w in zip(got, want):
        assert_scaled_close(g.numpy(), np.asarray(w))


def test_ssd_scan_bwd_plain_with_bf16_b_and_c_matches_autograd():
    """b and c in bf16 (the train path's): the phase form widens them to
    f32 as the plain scan does; db and dc come back in bf16, one rounding
    of the f32 sums (one bf16 step, 2^-7 of a value, elementwise)."""
    x, la, b, c, h0, gy, gf = map(t, ssd_inputs(2, 150, 3, 8, 16, seed=11))
    b, c = b.to(torch.bfloat16), c.to(torch.bfloat16)
    leaves = [a.clone().requires_grad_() for a in (x, la, b, c, h0)]
    outs = scan.ssd_scan_plain(*leaves)
    want = torch.autograd.grad(outs, leaves, (gy, gf))
    got = scan.ssd_scan_bwd_plain(x, la, b, c, h0, gy, gf)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        w = w.float()
        step = 2.0 ** -7 * w.abs() if g.dtype == torch.bfloat16 else 0.0
        assert bool(((g.float() - w).abs()
                     <= TOL * float(w.abs().max()) + step).all())


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


ATTENTION_CASES = {   # b, h, hkv, sq, sk, d, kwargs
    "causal": (2, 4, 4, 96, 96, 16, dict(causal=True)),
    "gqa": (1, 8, 2, 130, 130, 32, dict(causal=True)),
    "noncausal-sq-ne-sk": (2, 4, 1, 40, 70, 64, dict(causal=False)),
    "window": (2, 4, 2, 100, 100, 16, dict(causal=True, window=20)),
    "offsets": (2, 4, 4, 9, 40, 32, dict(causal=True, q_offset=20,
                                         kv_len=29)),
    "window-offsets": (2, 4, 2, 30, 90, 16, dict(
        causal=True, q_offset=50, kv_len=80, window=24)),
}


def _lse_form(q, k, v, g, kw):
    """B4's gradient in the log-sum-exp-and-Delta form, from the plain
    forward's output and log-sum-exp."""
    out, lse = fa.flash_attention_plain(q, k, v, **kw, return_lse=True)
    return fa.flash_attention_bwd(q, k, v, g, **kw, out=out, lse=lse)


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_plain_forward_lse_is_the_logsumexp_of_the_masked_scores(case):
    b, h, hkv, sq, sk, d, kw = ATTENTION_CASES[case]
    q, k, v, _ = map(t, attention_inputs(b, h, hkv, sq, sk, d, seed=sq + d))
    out, lse = fa.flash_attention_plain(q, k, v, **kw, return_lse=True)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, **kw))
    s = (q * d ** -0.5) @ k.repeat_interleave(h // hkv, 1).transpose(-1, -2)
    mask = FAM._visible_mask(torch.arange(sq), torch.arange(sk),
                            causal=kw["causal"], q_offset=kw.get("q_offset", 0),
                            kv_len=kw.get("kv_len", sk),
                            window=kw.get("window"))
    want = torch.logsumexp(torch.where(mask, s, float("-inf")), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert_scaled_close(lse.numpy(), want.numpy(), 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_for_grad_on_the_cpu(dtype):
    """``_forward(..., for_grad=True)`` on the CPU, the card's launch in
    plain form: the output in q's dtype, the f32 log-sum-exp and the
    output's rounding residual, output + residual the f32 output (to
    ~16 bits in bf16, exactly in f32); the gradient's log-sum-exp-and-
    Delta form on them matches the closed form at 1e-6 (f32)."""
    b, h, hkv, sq, sk, d, kw = ATTENTION_CASES["window-offsets"]
    q, k, v, g = (x.to(dtype) for x in map(t, attention_inputs(
        b, h, hkv, sq, sk, d, seed=3)))
    args = (kw["causal"], None, kw["q_offset"], kw["kv_len"], kw["window"])
    out, lse, out_lo = FAM._forward(q, k, v, *args, for_grad=True)
    o32, want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                         **kw, return_lse=True)
    assert out.dtype == out_lo.dtype == dtype and torch.equal(lse, want)
    assert torch.equal(out, o32.to(dtype))
    err = float((out.float() + out_lo.float() - o32).abs().max())
    assert err <= (0.0 if dtype == torch.float32 else 2.0 ** -16) * float(
        o32.abs().max())
    if dtype == torch.float32:
        got = fa.flash_attention_bwd(q, k, v, g, **kw, out=out, lse=lse)
        for a, w in zip(got, fa.flash_attention_bwd(q, k, v, g, **kw)):
            assert_scaled_close(a.numpy(), w.numpy(), 1e-6)


@pytest.mark.parametrize("case", list(ATTENTION_CASES))
def test_flash_attention_bwd_lse_form_matches_the_closed_form(case):
    """The same gradient in f32, P from the log-sum-exp and rowsum(dP P)
    as rowsum(dO O): 1e-6 of each gradient's largest value."""
    b, h, hkv, sq, sk, d, kw = ATTENTION_CASES[case]
    q, k, v, g = map(t, attention_inputs(b, h, hkv, sq, sk, d, seed=sq + sk))
    closed = fa.flash_attention_bwd(q, k, v, g, **kw)
    for a, w in zip(_lse_form(q, k, v, g, kw), closed):
        assert_scaled_close(a.numpy(), w.numpy(), 1e-6)


@pytest.mark.parametrize("b,h,hkv,s,d,causal", [
    (2, 4, 4, 96, 16, True),
    (1, 8, 2, 130, 32, True),
    (2, 4, 1, 64, 64, False),
], ids=["causal", "gqa", "mqa-noncausal"])
def test_flash_attention_bwd_lse_form_matches_jax_vjp_of_attention_ref(
        b, h, hkv, s, d, causal):
    q, k, v, g = attention_inputs(b, h, hkv, s, s, d, seed=s + d)
    _, vjp = jax.vjp(lambda q, k, v: attention_ref(q, k, v, causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    got = _lse_form(t(q), t(k), t(v), t(g), dict(causal=causal))
    for a, w in zip(got, want):
        assert_scaled_close(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["window", "offsets", "window-offsets"])
def test_flash_attention_bwd_lse_form_matches_jax_vjp_of_sdpa_dense(case):
    """The reference's cache path (positions ``q_offset + arange(Sq)``,
    the first ``kv_len`` of ``Sk`` cache rows valid; K/V repeated to q's
    heads, a kv head's gradient summed over its group)."""
    b, h, hkv, sq, sk, d, kw = ATTENTION_CASES[case]
    rep, q_offset = h // hkv, kw.get("q_offset", 0)
    q, k, v, g = attention_inputs(b, h, hkv, sq, sk, d, seed=sq * sk)
    q_pos = np.broadcast_to(q_offset + np.arange(sq), (b, sq))
    kv_pos = np.broadcast_to(np.arange(sk), (b, sk))

    def ref(q, k, v):   # [B,S,H,hd] layouts
        return _sdpa_dense(
            q, jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2),
            q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
            kv_valid=jnp.asarray(kv_pos < kw.get("kv_len", sk)), causal=True,
            window=kw.get("window"))

    def bshd(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3))

    _, vjp = jax.vjp(ref, bshd(q), bshd(k), bshd(v))
    want = vjp(bshd(g))
    got = _lse_form(t(q), t(k), t(v), t(g), kw)
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


@pytest.mark.parametrize("kernel", ["ssd_scan", "flash_attention",
                                    "flash_attention_tc",
                                    "flash_attention_tc_f32"])
def test_meta_backward_holds_the_kernels_scratch(kernel, monkeypatch):
    """A recording of a meta backward peaks with the backward kernel's f32
    scratch live beside its gradients, as the card holds them during the
    launch: without the scratch the peak is lower by exactly its bytes
    (B5: every chunk's two increments, rewritten as the states entering
    the chunks and the gradients of those leaving them, each chunk's
    decay, and the db/dc and ds partials of every block of 64 state
    columns; B4: each q row's two statistics in the CUDA-core form, its
    Delta alone in the tensor-core forms, bf16 and f32, which read the
    log-sum-exp that the forward saved)."""
    def meta(*shape):
        return torch.empty(*shape, device="meta", requires_grad=True)

    name = "ssd_scan" if kernel == "ssd_scan" else "flash_attention"
    mod = importlib.import_module(f"repro_torch.kernels.{name}.{name}")
    if kernel == "ssd_scan":
        bsz, s, h, p, n = 2, 130, 3, 8, 16
        chunks, blocks = 3, 3
        scratch = 4 * (2 * bsz * h * chunks * n * p + bsz * h * chunks
                       + 2 * bsz * blocks * chunks * 64 * n
                       + bsz * blocks * chunks * 64)
        args = ((meta(bsz, s, h, p), meta(bsz, s, h), meta(bsz, s, n),
                 meta(bsz, s, n), meta(bsz, h, n, p)),
                (torch.empty(bsz, s, h, p, device="meta"),
                 torch.empty(bsz, h, n, p, device="meta")))
        fn, name = scan.ssd_scan, "_bwd_scratch"
    else:
        tc = kernel != "flash_attention"
        d = 64 if tc else 16
        dt = torch.bfloat16 if kernel.endswith("_tc") else torch.float32

        def meta(*shape):   # noqa: F811 -- B4's inputs in its dtype
            return torch.empty(*shape, device="meta", dtype=dt,
                               requires_grad=True)

        scratch = 4 * (1 if tc else 2) * 2 * 4 * 40
        args = ((meta(2, 4, 40, d), meta(2, 2, 90, d), meta(2, 2, 90, d)),
                (torch.empty(2, 4, 40, d, device="meta", dtype=dt),))
        fn, name = (lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
                    "_bwd_stats")
    with_scratch = recorded_peak(fn, *args)
    monkeypatch.setattr(mod, name, lambda *a: None)
    assert with_scratch - recorded_peak(fn, *args) == scratch


def test_meta_forward_keeps_the_lse_for_the_tensor_core_backward():
    """On meta, a bf16 forward at D 64 under grad is one op whose results
    are the output, each row's f32 log-sum-exp and the output's rounding
    residual; the backward op reads the three beside q, k, v and the
    output's gradient.  At D 16 (the CUDA-core form) none is kept."""
    def meta(*shape, d, dt=torch.bfloat16):
        return torch.empty(*shape, d, device="meta", dtype=dt,
                           requires_grad=True)

    for d, kept in ((64, True), (16, False)):
        q, k, v = meta(2, 4, 40, d=d), meta(2, 2, 90, d=d), meta(2, 2, 90, d=d)
        assert FAM.keeps_lse(q, k, v) == kept
        with OpLog() as log:
            out = fa.flash_attention(q, k, v, causal=True)
        [(func, args)] = [(f, a) for f, a in log.ops
                          if f.namespace == "repro_torch"]
        assert args[3] is kept     # for_grad
        ops = backward_ops(lambda q, k, v: fa.flash_attention(q, k, v,
                                                              causal=True),
                           (q, k, v), (torch.empty_like(out),))
        [(name, bargs)] = ops
        saved_out, out_lo, lse = bargs[4:7]
        assert name == "flash_attention_bwd"
        if kept:
            assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
            for t in (saved_out, out_lo):
                assert t.shape == q.shape and t.dtype == q.dtype
        else:
            assert lse is None and saved_out is None and out_lo is None


@pytest.mark.parametrize("d,kept", [(64, True), (128, True), (16, False)],
                         ids=["d64", "d128", "d16"])
def test_meta_forward_keeps_the_lse_for_the_tensor_core_f32_backward(d,
                                                                    kept):
    """On meta, an f32 forward at D 64 or 128 (more than 16 rows per kv
    head) under grad is one op whose results are the output and each
    row's f32 log-sum-exp, and no rounding residual (an empty tensor);
    the backward op reads the output and the log-sum-exp, its residual
    None.  At D 16 (the CUDA-core form) none is kept."""
    def meta(*shape):
        return torch.empty(*shape, d, device="meta", requires_grad=True)

    q, k, v = meta(2, 4, 40), meta(2, 2, 90), meta(2, 2, 90)
    assert FAM.keeps_lse(q, k, v) == kept
    assert FAM.backward_form(q, k, v) == ("tensor_core_f32" if kept
                                          else "simt")
    with OpLog() as log:
        out = fa.flash_attention(q, k, v, causal=True)
    [(func, args)] = [(f, a) for f, a in log.ops
                      if f.namespace == "repro_torch"]
    assert args[3] is kept     # for_grad
    ops = backward_ops(lambda q, k, v: fa.flash_attention(q, k, v,
                                                          causal=True),
                       (q, k, v), (torch.empty_like(out),))
    [(name, bargs)] = ops
    saved_out, out_lo, lse = bargs[4:7]
    assert name == "flash_attention_bwd" and out_lo is None
    if kept:
        assert lse.shape == (2, 4, 40) and lse.dtype == torch.float32
        assert saved_out.shape == q.shape and saved_out.dtype == q.dtype
    else:
        assert lse is None and saved_out is None
