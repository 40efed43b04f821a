"""Kernel B4 (flash attention): the port's plain version — what its
wrapper runs on the CPU — against the reference's Pallas kernel in
interpret mode and its dense oracle, on the same numpy-seeded inputs.

Bounds are the reference's own (``tests/kernels/
test_flash_attention_kernel.py``): atol 2e-5 in f32, 3e-2 in bf16.  The
offset form (``q_offset``/``kv_len``, the model's cache path) is held
against ``models/attention.py::_sdpa_dense`` with the reference's cache
masks.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as flash_ref
from repro.models.attention import _sdpa_dense
from repro_torch.kernels import flash_attention as fa

SHAPES = [
    (1, 1, 1, 128, 64),
    (2, 4, 2, 256, 64),
    (1, 8, 1, 128, 128),   # MQA
    (1, 4, 4, 384, 32),    # MHA
]


def make(b, h, hkv, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return fa.flash_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,hkv,s,d", SHAPES)
def test_plain_matches_reference_f32(b, h, hkv, s, d, causal):
    q, k, v = make(b, h, hkv, s, s, d)
    got = port(q, k, v, causal=causal)
    kernel = np.asarray(flash_ref(q, k, v, causal=causal, interpret=True))
    ref = np.asarray(attention_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(got, kernel, atol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_bf16_inputs():
    q, k, v = make(1, 2, 1, 128, 128, 64, seed=1)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(attention_ref(qb, kb, vb, causal=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (qb, kb, vb))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=3e-2)


def test_longer_kv_and_scale_override():
    q, k, v = make(1, 2, 2, 128, 512, 64, seed=2)
    np.testing.assert_allclose(
        port(q, k, v, causal=False),
        np.asarray(attention_ref(q, k, v, causal=False)), atol=2e-5)
    q, k, v = make(1, 1, 1, 128, 128, 64, seed=3)
    np.testing.assert_allclose(
        port(q, k, v, causal=False, scale=0.25),
        np.asarray(attention_ref(q, k, v, scale=0.25)), atol=2e-5)


def test_causal_rows_are_top_left_aligned_as_in_the_kernel():
    """ROADMAP C1: at Sq != Sk without offsets the port follows
    ``_flash_kernel`` (col <= row), not ``attention_ref``."""
    q, k, v = make(1, 2, 2, 128, 256, 64, seed=4)
    got = port(q, k, v, causal=True)
    kernel = np.asarray(flash_ref(q, k, v, causal=True, interpret=True))
    np.testing.assert_allclose(got, kernel, atol=2e-5)
    ref = np.asarray(attention_ref(q, k, v, causal=True))
    assert np.abs(got - ref).max() > 0.1


def cache_case(b, h, hkv, d, length, s_new, max_len, seed):
    """The reference's cache path: new keys written at ``length`` of a
    ``max_len`` cache, positions ``length + arange(s_new)``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_new, h, d)).astype(np.float32)
    k = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    new_len = length + s_new
    q_pos = np.broadcast_to(length + np.arange(s_new), (b, s_new))
    kv_pos = np.broadcast_to(np.arange(max_len), (b, max_len))
    rep = h // hkv
    want = _sdpa_dense(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)), q_positions=jnp.asarray(q_pos),
        kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < new_len), causal=True, window=None)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True, q_offset=length,
                             kv_len=new_len)
    return got.transpose(1, 2).numpy(), np.asarray(want)


@pytest.mark.parametrize("length,s_new,max_len", [
    (0, 9, 16),      # prefill into an empty cache, ragged
    (7, 1, 16),      # decode step
    (40, 1, 97),     # decode step, long cache
    (5, 6, 13),      # Sq != Sk chunk into a partly filled cache
], ids=["prefill", "decode", "decode-long", "chunk"])
def test_offset_form_matches_the_reference_cache_masks(length, s_new,
                                                       max_len):
    got, want = cache_case(2, 4, 2, 16, length, s_new, max_len, seed=length)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_wrapper_rejects_bad_arguments():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        fa.flash_attention(q, k, k, causal=True)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="kv_len"):
        fa.flash_attention(q, k, k, causal=True, kv_len=0)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention(q, k, k, causal=True, q_offset=-1)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, k.double(), k, causal=True)


def test_cpu_path_counts_no_launch():
    q, k, v = make(1, 2, 1, 64, 64, 64)
    before = dict(fa.LAUNCHES)
    port(q, k, v, causal=True)
    assert fa.LAUNCHES == before
