"""B4's f32 tensor-core forms (3xTF32) before any card: a torch emulation
of the kernels' arithmetic held to the JAX package, on numpy-seeded
inputs.

The emulation does what ``csrc/flash_tc_f32.cuh`` and the third form of
``csrc/flash_bwd.cu`` do with their numbers: every f32 operand of a
product is split by bit mask into a TF32 high part and the rest, and the
tensor core reads the rest as TF32 too (its low 13 bits dropped); a
product is lo·hi + hi·lo + hi·hi with f32 sums.  The forward runs the
blocked online softmax over the kernel's KV tiles (64 columns at D 64, 32
at D 96 and 128) in natural units and writes the log-sum-exp m + ln l;
the backward runs the dQ pass (Delta0 = dO·O, the correction by one TF32
product P K to the products' own rowsum(dP P) and row sum of P, both
summed in f64) and the dK/dV pass with P = e^(scale s - lse).  The tensor core's own f32 sums, which round toward
zero, are not emulated: the kernels keep each tile's products in fresh
registers and add them in f32, so that the drift of a long chain of
``mma`` into one accumulator does not reach the gates (the card's runs
measure it).

Held to: the Pallas kernel ``_flash_kernel`` in interpret mode (as the
JAX package's own tests run it) and the dense oracle at 2e-5 in f32 (the
reference's bound); the reference's ``sdpa`` with its cache and window
masks where the Pallas kernel has neither; ``jax.vjp`` of
``attention_ref`` and ``_sdpa_dense`` at 1e-5 of each gradient's largest
value (``BWD_TOL`` in f32); and, row by row, the port's plain backward at
5e-4 of each row's rms (``BWD_ROW_TOL`` in f32, the card's gate), in f64
where |S| reaches ~20, which the backward without its Delta correction,
or at |S| ~ 20 with f32 sums, misses.  Cases: D 64/96/128,
GQA, a window, not causal with Sq != Sk, ``q_offset``/``kv_len``, and
inputs scaled so that |scale q k^T| reaches ~20.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as flash_ref
from repro.models.attention import _sdpa_dense
from repro_torch.kernels import flash_attention as fa

FWD_TOL = 2e-5        # FLASH_TOL in f32
BWD_TOL = 1e-5        # of each gradient's largest value
BWD_ROW_TOL = 5e-4    # of each row's rms, floored at 1e-3 of the whole's
LSE_TOL = 1e-4        # the forward's log-sum-exp, absolute
LOG2E = 1.4426950408889634
MASK_HI = -8192       # 0xffffe000 as int32: a float cut to TF32


# --- the kernels' arithmetic --------------------------------------------------


def tf32(x):
    """x as the tensor core reads it: the low 13 mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & MASK_HI).view(torch.float32)


def split(x):
    """``tf32x3.cuh::split_tf32``: hi = x cut to TF32, lo = x - hi (exact),
    read as TF32."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """a @ b as three TF32 products, lo·hi + hi·lo + hi·hi, f32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product (the dQ pass's correction)."""
    return tf32(a) @ tf32(b)


def visible(sq, sk, causal, q_offset, kv_len, window):
    rows = torch.arange(sq)[:, None] + q_offset
    cols = torch.arange(sk)[None, :]
    ok = cols < kv_len
    if causal:
        ok = ok & (cols <= rows)
    if window is not None:
        ok = ok & (cols > rows - window)
    return ok


def block_k(d):
    return 64 if d == 64 else 32


def emulate_forward(q, k, v, *, causal, q_offset=0, kv_len=None,
                    window=None):
    """``flash_tc_f32.cuh``'s arithmetic: ``(out, lse)``."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    ok = visible(sq, sk, causal, q_offset, kv_len, window)
    scale = d ** -0.5
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    bk = block_k(d)
    for j0 in range(0, sk, bk):
        x = mm3(q, k[:, :, j0:j0 + bk].transpose(-1, -2)) * scale
        x = torch.where(ok[:, j0:j0 + bk], x, float("-inf"))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((x - m_new) * LOG2E)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + mm3(p, v[:, :, j0:j0 + bk])
        m = m_new
    l = l.clamp_min(1e-30)
    return acc / l, (m + torch.log(l))[..., 0]


def emulate_backward(q, k, v, g, out, lse, *, causal, q_offset=0,
                     kv_len=None, window=None, design="kernel"):
    """``flash_bwd.cu``'s tensor-core f32 form: ``(dq, dk, dv)``.  The dQ
    pass's ``design``: ``"kernel"``, L = rowsum(P) and Delta1 =
    rowsum(P dP) summed in f64 and dq = scale (dQ0 + (Delta0 - Delta1 / L)
    P K) / L; ``"f32"``, Delta1 summed in f32 and P taken as normalised,
    dq = scale (dQ0 + (Delta0 - Delta1) P K); ``"uncorrected"``, Delta0 =
    dO·O for rowsum(dP P) (the designs the kernel's replaces)."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = h // hkv
    kv_len = sk if kv_len is None else kv_len
    kh = k.repeat_interleave(rep, dim=1)
    vh = v.repeat_interleave(rep, dim=1)
    ok = visible(sq, sk, causal, q_offset, kv_len, window)
    scale = d ** -0.5
    # dQ pass
    x = mm3(q, kh.transpose(-1, -2)) * scale
    p = torch.where(ok, torch.exp2((x - lse[..., None]) * LOG2E), 0.0)
    dp = mm3(g, vh.transpose(-1, -2))
    delta0 = (g * out).sum(-1, keepdim=True)
    dq = mm3(p * (dp - delta0), kh)
    if design == "kernel":
        l64 = p.double().sum(-1, keepdim=True)
        d64 = (p.double() * dp.double()).sum(-1, keepdim=True)
        c = ((delta0.double() * l64 - d64) / l64).float()
        dq = (dq + c * mm1(p, kh)) * (1.0 / l64).float()
        delta1 = d64.float()
    elif design == "f32":
        delta1 = (p * dp).sum(-1, keepdim=True)
        dq = dq + (delta0 - delta1) * mm1(p, kh)
    else:
        delta1 = delta0
    dq = dq * scale
    # dK/dV pass: S^T = K Q^T, dP^T = V dO^T, summed over a kv head's q heads
    ds = p * (dp - delta1)
    dk = mm3(ds.transpose(-1, -2), q) * scale
    dv = mm3(p.transpose(-1, -2), g)
    return (dq, dk.unflatten(1, (hkv, rep)).sum(2),
            dv.unflatten(1, (hkv, rep)).sum(2))


# --- inputs and references ------------------------------------------------------


def inputs(b, h, hkv, sq, sk, d, seed, s_max=None):
    """q, k, v, dO; with ``s_max`` q and k scaled so that the largest
    |scale q k^T| is ``s_max``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    if s_max is not None:
        s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, h // hkv, axis=1))
        c = np.float32(np.sqrt(s_max / (np.abs(s).max() * d ** -0.5)))
        q, k = q * c, k * c
    return q, k, v, g


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_scaled_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def row_err(got, want):
    """``chip_smoke.py::bwd_row_err``: max |got - want| of a row over that
    row's rms of ``want``, floored at 1e-3 of the whole's rms."""
    g, w = got.double(), want.double()
    rms = w.pow(2).mean(-1).sqrt()
    floor = 1e-3 * float(w.pow(2).mean().sqrt())
    return float(((g - w).abs().amax(-1) / rms.clamp_min(floor)).max())


def sdpa_ref(q, k, v, *, causal, q_offset, kv_len, window):
    """The reference's dense attention with its cache masks, ``[B, H, S,
    D]`` in and out (K/V repeated to q's heads)."""
    b, h, sq, _ = q.shape
    sk, rep = k.shape[2], h // k.shape[1]
    q_pos = np.broadcast_to(q_offset + np.arange(sq), (b, sq))
    kv_pos = np.broadcast_to(np.arange(sk), (b, sk))

    def swap(a):
        return jnp.swapaxes(a, 1, 2)

    return swap(_sdpa_dense(
        swap(q), jnp.repeat(swap(k), rep, axis=2),
        jnp.repeat(swap(v), rep, axis=2), q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < kv_len), causal=causal,
        window=window))


# cases the Pallas kernel takes (no window, no offsets; Sq and Sk
# multiples of its 128-row blocks, or shorter)
PALLAS_CASES = {   # b, h, hkv, sq, sk, d, causal, s_max
    "d64": (2, 4, 4, 256, 256, 64, True, None),
    "d96-gqa": (1, 4, 2, 256, 256, 96, True, None),
    "d128-mqa": (1, 4, 1, 128, 128, 128, True, None),
    "noncausal-sq-ne-sk-d64": (1, 4, 2, 64, 256, 64, False, None),
    "noncausal-sq-gt-sk-d128": (1, 2, 2, 128, 96, 128, False, None),
    "s20-d64": (1, 4, 4, 256, 256, 64, True, 20.0),
    "s20-d128-gqa": (1, 4, 2, 128, 128, 128, True, 20.0),
}
# the cache path and the window, against the reference's dense attention
MASK_CASES = {   # b, h, hkv, sq, sk, d, causal, q_offset, kv_len, window
    "window-d128": (1, 4, 2, 160, 160, 128, True, 0, 160, 37),
    "offsets-d96": (2, 4, 2, 40, 200, 96, True, 120, 160, None),
    "window-offsets-d64": (1, 4, 4, 70, 260, 64, True, 150, 220, 100),
    "s20-window-d64": (1, 4, 2, 130, 130, 64, True, 0, 130, 50),
}


def scores_max(q, k):
    h, hkv, d = q.shape[1], k.shape[1], q.shape[-1]
    s = np.einsum("bhqd,bhkd->bhqk", q, np.repeat(k, h // hkv, axis=1))
    return float(np.abs(s).max()) * d ** -0.5


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_emulated_forward_matches_the_pallas_kernel(case):
    """The forward's arithmetic against ``_flash_kernel`` in interpret
    mode and the dense oracle at 2e-5; its log-sum-exp against the plain
    version's at the card's ``LSE_TOL`` (1e-4: at |S| ~ 20 the scores'
    own 3xTF32 error, ~2^-20 of |q| |k| a term, reaches ~1e-5)."""
    b, h, hkv, sq, sk, d, causal, s_max = PALLAS_CASES[case]
    q, k, v, _ = inputs(b, h, hkv, sq, sk, d, seed=sq + d, s_max=s_max)
    if s_max is not None:
        assert 19.0 <= scores_max(q, k) <= 21.0
    out, lse = emulate_forward(t(q), t(k), t(v), causal=causal)
    kernel = np.asarray(flash_ref(q, k, v, causal=causal, interpret=True))
    np.testing.assert_allclose(out.numpy(), kernel, atol=FWD_TOL)
    if sq == sk or not causal:   # the oracle's alignment (ROADMAP C1)
        ref = np.asarray(attention_ref(q, k, v, causal=causal))
        np.testing.assert_allclose(out.numpy(), ref, atol=FWD_TOL)
    _, want = fa.flash_attention_plain(t(q), t(k), t(v), causal=causal,
                                       return_lse=True)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), atol=LSE_TOL)


@pytest.mark.parametrize("case", list(MASK_CASES))
def test_emulated_forward_matches_the_reference_masks(case):
    """Window and cache path against the reference's dense attention at
    2e-5."""
    b, h, hkv, sq, sk, d, causal, off, kvl, win = MASK_CASES[case]
    s_max = 20.0 if case.startswith("s20") else None
    q, k, v, _ = inputs(b, h, hkv, sq, sk, d, seed=sq + sk, s_max=s_max)
    kw = dict(causal=causal, q_offset=off, kv_len=kvl, window=win)
    out, _ = emulate_forward(t(q), t(k), t(v), **kw)
    want = np.asarray(sdpa_ref(q, k, v, **kw))
    np.testing.assert_allclose(out.numpy(), want, atol=FWD_TOL)


def _backward_case(case):
    if case in PALLAS_CASES:
        b, h, hkv, sq, sk, d, causal, s_max = PALLAS_CASES[case]
        kw = dict(causal=causal, q_offset=0, kv_len=sk, window=None)
    else:
        b, h, hkv, sq, sk, d, causal, off, kvl, win = MASK_CASES[case]
        s_max = 20.0 if case.startswith("s20") else None
        kw = dict(causal=causal, q_offset=off, kv_len=kvl, window=win)
    return inputs(b, h, hkv, sq, sk, d, seed=sq + sk + 1, s_max=s_max), kw


@pytest.mark.parametrize("case", [*PALLAS_CASES, *MASK_CASES])
def test_emulated_backward_matches_jax_vjp(case):
    """The backward's arithmetic, from the emulated forward's output and
    log-sum-exp, against ``jax.vjp`` of the reference's dense attention
    (``attention_ref``'s top-left causal rows where Sq = Sk, else
    ``_sdpa_dense`` with the cache masks) at 1e-5 of each gradient's
    largest value."""
    (q, k, v, g), kw = _backward_case(case)
    out, lse = emulate_forward(t(q), t(k), t(v), **kw)
    got = emulate_backward(t(q), t(k), t(v), t(g), out, lse, **kw)
    if kw["causal"] and q.shape[2] != k.shape[2] or kw["window"] \
            or kw["q_offset"] or kw["kv_len"] != k.shape[2]:
        fn = lambda q, k, v: sdpa_ref(q, k, v, **kw)  # noqa: E731
    else:
        fn = lambda q, k, v: attention_ref(  # noqa: E731
            q, k, v, causal=kw["causal"])
    _, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, w in zip(got, vjp(jnp.asarray(g))):
        assert_scaled_close(a.numpy(), np.asarray(w), BWD_TOL)


ROW_CASES = ["d64", "d96-gqa", "d128-mqa", "noncausal-sq-ne-sk-d64",
             "window-d128", "offsets-d96", "window-offsets-d64"]
SHARP_CASES = ["s20-d64", "s20-d128-gqa", "s20-window-d64"]


@pytest.mark.parametrize("case", ROW_CASES + SHARP_CASES)
def test_emulated_backward_rows_meet_the_card_gate(case):
    """Row by row against the port's plain backward (what the card's gate
    compares) at ``BWD_ROW_TOL``.  Where |S| reaches ~20 (``s20``) the
    plain version runs in f64: a row whose softmax is that sharp has a dq
    that is a difference of nearly equal terms, and the plain version in
    f32 is itself up to ~1.7e-3 of its row floor from its f64 evaluation.
    There the kernel's arithmetic is held to be no further from f64 than
    the plain f32 version, and the dQ pass with Delta1 in f32 and P taken
    as normalised (the log-sum-exp, an f32 of ~20, leaves rowsum(P) 1 +
    ~1e-6) misses the gate.  On the unscaled cases the backward with
    Delta0 = dO·O uncorrected misses it on the causal cases: dq of row 0,
    which sees one column, is exactly 0 in the plain versions and ~1e-6
    (7e-3 of the row floor) without the correction."""
    (q, k, v, g), kw = _backward_case(case)
    sharp = case in SHARP_CASES
    out, lse = emulate_forward(t(q), t(k), t(v), **kw)
    want = fa.flash_attention_bwd(
        *(t(a).double() if sharp else t(a) for a in (q, k, v, g)), **kw)
    got = emulate_backward(t(q), t(k), t(v), t(g), out, lse, **kw)
    errs = [row_err(a, w) for a, w in zip(got, want)]
    assert max(errs) <= BWD_ROW_TOL, errs
    if sharp:
        plain = fa.flash_attention_bwd(t(q), t(k), t(v), t(g), **kw)
        assert errs[0] <= row_err(plain[0], want[0])
        f32 = emulate_backward(t(q), t(k), t(v), t(g), out, lse, **kw,
                               design="f32")
        assert row_err(f32[0], want[0]) > BWD_ROW_TOL
    elif kw["causal"] and kw["q_offset"] == 0 and kw["window"] is None:
        plain = emulate_backward(t(q), t(k), t(v), t(g), out, lse, **kw,
                                 design="uncorrected")
        assert row_err(plain[0], want[0]) > BWD_ROW_TOL
