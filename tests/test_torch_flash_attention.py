"""Kernel B4 (flash attention): the port's plain version — what its
wrapper runs on the CPU — against the reference's Pallas kernel in
interpret mode and its dense oracle, on the same numpy-seeded inputs.

Bounds are the reference's own (``tests/kernels/
test_flash_attention_kernel.py``): atol 2e-5 in f32, 3e-2 in bf16.  The
offset form (``q_offset``/``kv_len``, the model's cache path) is held
against ``models/attention.py::_sdpa_dense`` with the reference's cache
masks, and the sliding window (mixtral; the port's B4 has it, the Pallas
kernel has not) against the reference's ``sdpa``, dense and in its
banded ``impl="blocked"`` form, at 2e-5 in f32.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as flash_ref
from repro.models.attention import _sdpa_dense, sdpa
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


@pytest.mark.parametrize("causal,b,h,hkv,sq,sk,d", [
    (False, 1, 4, 4, 1, 256, 64),     # cross-attention decode: one row
    (False, 2, 4, 2, 1, 384, 96),     # the same at D 96, GQA
    (False, 1, 4, 4, 64, 384, 64),    # cross-attention prefill, Sq < Sk
    (False, 1, 2, 2, 384, 128, 96),   # Sq > Sk
    (False, 2, 4, 4, 256, 256, 96),   # an encoder at phi-3's D 96
    (True, 1, 4, 2, 256, 256, 96),    # phi-3's causal prefill, GQA
], ids=["cross-decode", "cross-decode-d96", "cross-prefill",
        "cross-sq-gt-sk", "encoder-d96", "causal-d96"])
def test_non_causal_and_d96_match_reference(causal, b, h, hkv, sq, sk, d):
    """Bidirectional and cross-attention calls (Sq != Sk, Sq = 1 too)
    and head dim 96 against the Pallas kernel in interpret mode and the
    dense oracle (they agree here: no causal mask at Sq != Sk)."""
    q, k, v = make(b, h, hkv, sq, sk, d, seed=sq + d)
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


# --- the kernel's forms: dispatch, and the split-KV decomposition ------------


def decode_case(b, h, hkv, sq, sk, d, seed):
    q, k, v = make(b, h, hkv, sq, sk, d, seed=seed)
    return [torch.from_numpy(a) for a in (q, k, v)]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,q_offset,kv_len", [
    (2, 8, 8, 1, 300, 64, 255, 256),     # decode, kv_len a multiple of 128
    (2, 8, 8, 1, 300, 64, 199, 200),     # ragged last split
    (2, 32, 8, 1, 400, 128, 386, 387),   # GQA 4:1, D 128
    (1, 4, 1, 4, 300, 64, 126, 130),     # 16 rows; rows 0-1 see none of
                                         # the second split
    (1, 2, 2, 1, 8, 64, 0, 1),           # kv_len 1
], ids=["decode", "ragged", "gqa", "masked-split", "kv1"])
def test_split_kv_model_equals_plain(b, h, hkv, sq, sk, d, q_offset, kv_len):
    q, k, v = decode_case(b, h, hkv, sq, sk, d, seed=kv_len)
    kw = dict(causal=True, q_offset=q_offset, kv_len=kv_len)
    got = fa.split_kv_plain(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,h,hkv,sq,sk,causal,q_offset,kv_len", [
    (2, 8, 8, 1, 2080, True, 2047, 2048),   # phi-3's decode step
    (1, 16, 4, 4, 300, True, 126, 130),     # 16 rows per kv head
    (2, 4, 4, 1, 330, False, 0, 330),       # cross-attention decode
], ids=["decode", "16-rows", "cross-decode"])
def test_split_kv_model_at_head_dim_96(b, h, hkv, sq, sk, causal, q_offset,
                                       kv_len):
    q, k, v = decode_case(b, h, hkv, sq, sk, 96, seed=kv_len)
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = fa.split_kv_plain(q, k, v, **kw)
    assert fa.split_range(sq, causal, q_offset, kv_len) == (
        0, -(-kv_len // fa.SPLIT_COLUMNS))
    torch.testing.assert_close(got, fa.flash_attention_plain(q, k, v, **kw),
                               atol=2e-5, rtol=0)


def test_split_kv_model_with_a_small_split_and_without_causality():
    """Many splits (the last one small: kv_len 1041 is 8 full splits of
    128 and 17 columns), with and without the causal mask."""
    q, k, v = decode_case(1, 4, 2, 3, 1100, 64, seed=7)
    for causal in (True, False):
        kw = dict(causal=causal, q_offset=1030, kv_len=1041)
        torch.testing.assert_close(fa.split_kv_plain(q, k, v, **kw),
                                   fa.flash_attention_plain(q, k, v, **kw),
                                   atol=2e-5, rtol=0)


def test_split_kv_model_matches_the_reference_cache_masks():
    """The decomposition against the reference's dense cache path."""
    rng = np.random.default_rng(11)
    b, h, hkv, d, length, max_len = 2, 8, 2, 64, 150, 200
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(max_len), (b, max_len))
    want = _sdpa_dense(
        jnp.asarray(q), jnp.asarray(np.repeat(k, h // hkv, axis=2)),
        jnp.asarray(np.repeat(v, h // hkv, axis=2)),
        q_positions=jnp.asarray(np.full((b, 1), length)),
        kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < length + 1), causal=True, window=None)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = fa.split_kv_plain(tq, tk, tv, causal=True, q_offset=length,
                            kv_len=length + 1)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=2e-5)


DISPATCH_CASES = [   # dtype, h, hkv, sq, d, form
    (torch.bfloat16, 32, 32, 1, 64, "split_kv"),      # zamba2 decode step
    (torch.bfloat16, 32, 8, 4, 128, "split_kv"),      # 16 rows per kv head
    (torch.bfloat16, 32, 8, 5, 128, "tensor_core"),   # 20 rows
    (torch.bfloat16, 32, 32, 17, 64, "tensor_core"),  # 17 rows
    (torch.bfloat16, 4, 4, 2048, 64, "tensor_core"),  # prefill
    (torch.float32, 4, 4, 2048, 64, "tensor_core_f32"),  # 3xTF32
    (torch.float32, 4, 4, 1, 64, "split_kv_f32"),     # an f32 decode step
    (torch.bfloat16, 4, 4, 64, 32, "simt"),           # D 32
    (torch.bfloat16, 4, 4, 1, 8, "simt"),             # D 8
    (torch.bfloat16, 32, 32, 1, 96, "split_kv"),      # phi-3 decode step
    (torch.bfloat16, 32, 32, 2048, 96, "tensor_core"),  # phi-3 prefill
    (torch.float32, 32, 32, 2048, 96, "tensor_core_f32"),
    # what stays on the CUDA-core form in f32: D 8-32; at most 16 rows per
    # kv head (decode steps, short chunks) go to the f32 split-KV form
    (torch.float32, 4, 4, 2048, 16, "simt"),
    (torch.float32, 4, 4, 2048, 32, "simt"),
    (torch.float32, 32, 8, 4, 128, "split_kv_f32"),   # 16 rows per kv head
    (torch.float32, 32, 8, 5, 128, "tensor_core_f32"),  # 20 rows
    (torch.float32, 32, 32, 17, 64, "tensor_core_f32"),  # 17 rows
    (torch.float32, 32, 8, 2048, 128, "tensor_core_f32"),  # llama3 GQA
    (torch.float32, 32, 8, 1, 128, "split_kv_f32"),   # llama3 decode step
    (torch.float32, 32, 32, 1, 96, "split_kv_f32"),   # phi-3 decode step
    (torch.float32, 4, 4, 1, 16, "simt"),             # the reduced D 16
    (torch.float32, 4, 4, 1, 8, "simt"),
    (torch.float32, 4, 4, 1, 32, "simt"),
]


# the first twelve keep the ids they had when f32 always took the
# CUDA-core form ("simt" in dtype5's, dtype6's and dtype11's now names their
# old form; so does "f32-16-rows"'s)
@pytest.mark.parametrize("dtype,h,hkv,sq,d,form", DISPATCH_CASES, ids=[
    "dtype0-32-32-1-64-split_kv", "dtype1-32-8-4-128-split_kv",
    "dtype2-32-8-5-128-tensor_core", "dtype3-32-32-17-64-tensor_core",
    "dtype4-4-4-2048-64-tensor_core", "dtype5-4-4-2048-64-simt",
    "dtype6-4-4-1-64-simt", "dtype7-4-4-64-32-simt", "dtype8-4-4-1-8-simt",
    "dtype9-32-32-1-96-split_kv", "dtype10-32-32-2048-96-tensor_core",
    "dtype11-32-32-2048-96-simt",
    "f32-d16-prefill", "f32-d32-prefill", "f32-16-rows", "f32-20-rows",
    "f32-17-rows", "f32-gqa-d128", "f32-decode-gqa-d128", "f32-decode-d96",
    "f32-decode-d16", "f32-decode-d8", "f32-decode-d32"])
def test_kernel_form_dispatch(dtype, h, hkv, sq, d, form):
    q = torch.zeros(1, sq, h, d, dtype=dtype).transpose(1, 2)
    k = torch.zeros(1, 40, hkv, d, dtype=dtype).transpose(1, 2)
    assert fa.kernel_form(q, k, k) == form


def test_kernel_form_sends_unaligned_rows_to_the_cuda_core_form():
    base = torch.zeros(1, 4, 4 * 64 + 4, dtype=torch.bfloat16)
    q = base[:, :, :4 * 64].unflatten(-1, (4, 64)).transpose(1, 2)
    assert q.stride(2) % 8 == 4 and q.stride(-1) == 1
    k = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fa.kernel_form(q, k, k) == "simt"
    assert fa.kernel_form(q.contiguous(), k, k) == "split_kv"


@pytest.mark.parametrize("pad,sq", [(2, 64), (1, 64), (2, 1)],
                         ids=["8-bytes-off", "4-bytes-off", "decode"])
def test_kernel_form_sends_unaligned_f32_rows_to_the_cuda_core_form(pad, sq):
    """f32 rows are copied in 16-byte pieces (4 elements) by the
    tensor-core and split-KV f32 forms: a row stride that is no multiple
    of 4 takes the CUDA-core form, forward and backward.  Aligned, a
    decode step takes the f32 split-KV form forward and the CUDA-core
    form backward."""
    base = torch.zeros(2, sq, 4 * 64 + pad)
    q = base[:, :, :4 * 64].unflatten(-1, (4, 64)).transpose(1, 2)
    assert any(st % 4 for st in q.stride()[:3]) and q.stride(-1) == 1
    k = torch.zeros(2, 300, 4, 64).transpose(1, 2)
    assert fa.kernel_form(q, k, k) == fa.backward_form(q, k, k) == "simt"
    few = sq * 4 // 4 <= fa.SPLIT_MAX_ROWS
    assert fa.kernel_form(q.contiguous(), k, k) == (
        "split_kv_f32" if few else "tensor_core_f32")
    assert fa.backward_form(q.contiguous(), k, k) == (
        "simt" if few else "tensor_core_f32")


def test_forms_count_nothing_on_the_cpu():
    q, k, v = decode_case(1, 2, 2, 1, 64, 64, seed=3)
    before = dict(fa.LAUNCHES_BY_FORM)
    fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), causal=True,
                       q_offset=10, kv_len=11)
    fa.flash_attention(q, k, v, causal=True, q_offset=10, kv_len=11)
    assert fa.LAUNCHES_BY_FORM == before
    assert set(before) == {"tensor_core", "split_kv", "tensor_core_f32",
                           "split_kv_f32", "simt"}


@pytest.mark.parametrize("dtype,sq,d,form", [
    (torch.bfloat16, 40, 64, "tensor_core"),
    (torch.bfloat16, 1, 64, "tensor_core"),       # after a split-KV forward
    (torch.float32, 40, 64, "tensor_core_f32"),
    (torch.float32, 40, 128, "tensor_core_f32"),
    (torch.float32, 4, 64, "simt"),               # 8 rows per kv head
    (torch.float32, 40, 16, "simt"),
    (torch.bfloat16, 40, 16, "simt"),
    # f32 decode steps: the split-KV f32 forward writes no log-sum-exp
    (torch.float32, 1, 64, "simt"),
    (torch.float32, 1, 128, "simt"),
    (torch.float32, 1, 8, "simt"),
    (torch.float32, 1, 16, "simt"),
    (torch.float32, 1, 32, "simt"),
])
def test_backward_form_follows_the_forward(dtype, sq, d, form):
    """The backward's form after each forward form: bf16 tensor-core and
    split-KV forwards write the log-sum-exp the tensor-core backward
    reads, the f32 tensor-core forward the one its f32 backward reads;
    every other call (the f32 split-KV form's too) keeps the CUDA-core
    form backward (on meta, where ``keeps_lse`` is decided as on the
    card)."""
    q = torch.empty(2, 4, sq, d, dtype=dtype, device="meta")
    k = torch.empty(2, 2, 90, d, dtype=dtype, device="meta")
    assert fa.backward_form(q, k, k) == form
    module = importlib.import_module(fa.flash_attention.__module__)
    assert module.keeps_lse(q, k, k) == (form != "simt")


# --- the sliding window ------------------------------------------------------


def window_case(b, h, hkv, d, length, s_new, max_len, window, seed,
                impl="dense", block_q=1024):
    """The reference's ``sdpa`` with a window on the cache path (new
    tokens at positions ``length + arange(s_new)`` over the first
    ``length + s_new`` of ``max_len`` columns); returns the port's
    inputs in its ``[B, H, S, D]`` layout and the reference's output in
    ``[B, S, H, D]``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_new, h, d)).astype(np.float32)
    k = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, max_len, hkv, d)).astype(np.float32)
    q_pos = np.broadcast_to(length + np.arange(s_new), (b, s_new))
    kv_pos = np.broadcast_to(np.arange(max_len), (b, max_len))
    rep = h // hkv
    want = sdpa(
        jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=2)),
        jnp.asarray(np.repeat(v, rep, axis=2)),
        q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < length + s_new), causal=True,
        window=window, impl=impl, block_q=block_q)
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    return t, np.asarray(want)


@pytest.mark.parametrize("impl", ["dense", "blocked"])
@pytest.mark.parametrize("window", [20, 37])
def test_window_self_attention_matches_reference_sdpa(impl, window):
    """Sq = Sk = 96 with block_q 16: the reference's blocked form is its
    banded one (window + block_q < Sk); the band's lower edge falls
    mid-tile of every port form's 64 columns."""
    (q, k, v), want = window_case(2, 4, 2, 16, 0, 96, 96, window, seed=window,
                                  impl=impl, block_q=16)
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=2e-5)


@pytest.mark.parametrize("length,s_new,max_len,window", [
    (40, 9, 64, 20),      # chunk into a cache, edges 21..29 mid-tile
    (300, 1, 320, 130),   # decode step, edge 171 past the first split
    (150, 20, 200, 16),   # the reduced configs' window, 20 rows
    (30, 1, 40, 100),     # window wider than the cache: no effect
], ids=["chunk", "decode", "reduced-window", "wide"])
def test_window_cache_path_matches_reference_sdpa(length, s_new, max_len,
                                                  window):
    (q, k, v), want = window_case(2, 8, 2, 16, length, s_new, max_len,
                                  window, seed=length)
    kw = dict(causal=True, q_offset=length, kv_len=length + s_new,
              window=window)
    for fn in (fa.flash_attention_plain, fa.split_kv_plain):
        got = fn(q, k, v, **kw)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   atol=2e-5)


@pytest.mark.parametrize("sq,q_offset,kv_len,window,causal,splits", [
    (1, 1000, 1001, 300, True, (5, 3)),     # edge 701: splits 5..7
    (4, 1000, 1004, 128, True, (6, 2)),     # edge 873 at split 6
    (3, 600, 700, 100, False, (3, 3)),      # not causal: to kv_len
    (2, 127, 129, 1, True, (0, 2)),         # W 1: each row its own column
], ids=["decode", "16-rows", "non-causal", "w1"])
def test_window_split_kv_model_visits_only_the_band(sq, q_offset, kv_len,
                                                    window, causal, splits):
    q, k, v = decode_case(1, 8, 2, sq, kv_len + 5, 64, seed=kv_len)
    assert fa.split_range(sq, causal, q_offset, kv_len, window) == splits
    kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
    torch.testing.assert_close(fa.split_kv_plain(q, k, v, **kw),
                               fa.flash_attention_plain(q, k, v, **kw),
                               atol=2e-5, rtol=0)


def test_window_of_one_sees_the_diagonal_only():
    q, k, v = make(1, 2, 2, 70, 70, 16, seed=5)
    got = port(q, k, v, causal=True, window=1)
    np.testing.assert_allclose(got, v, atol=1e-6)


def test_plain_version_in_row_blocks_equals_one_block(monkeypatch):
    q, k, v = decode_case(1, 4, 2, 100, 100, 16, seed=9)
    kw = dict(causal=True, window=30)
    whole = fa.flash_attention_plain(q, k, v, **kw)
    module = importlib.import_module(fa.flash_attention.__module__)
    monkeypatch.setattr(module, "PLAIN_BLOCK_ELEMENTS", 4 * 100 * 7)
    assert fa.flash_attention_plain.__module__ == module.__name__
    torch.testing.assert_close(fa.flash_attention_plain(q, k, v, **kw),
                               whole, atol=1e-6, rtol=0)


def test_wrapper_rejects_bad_windows():
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 2, 20, 16)
    with pytest.raises(ValueError, match="window must be >= 1"):
        fa.flash_attention(q, k, k, causal=True, window=0)
    # non-causal, rows 8 past the cache end: the last sees no column
    with pytest.raises(ValueError, match="sees no column"):
        fa.flash_attention(q, k, k, causal=False, q_offset=20, kv_len=20,
                           window=4)
    fa.flash_attention(q, k, k, causal=False, q_offset=15, kv_len=20,
                       window=4)


# --- the f32 split-KV form's decomposition (64-column splits) ----------------


@pytest.mark.parametrize("b,h,hkv,sq,sk,d", [
    (2, 8, 2, 2, 384, 64),     # GQA 4:1, 8 rows a kv head
    (1, 4, 4, 1, 256, 96),     # cross-attention decode at D 96
], ids=["gqa", "non-causal-d96"])
def test_split_kv_f32_model_matches_the_pallas_kernel(b, h, hkv, sq, sk, d):
    """Without causality every row sees all Sk columns: the Pallas kernel
    in interpret mode computes that function (Sk a multiple of its
    128-column tile)."""
    q, k, v = make(b, h, hkv, sq, sk, d, seed=sk + d)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = fa.split_kv_plain(*t, causal=False, columns=fa.SPLIT_COLUMNS_F32)
    assert fa.split_range(sq, False, 0, sk, None, fa.SPLIT_COLUMNS_F32) == (
        0, -(-sk // 64))
    kernel = np.asarray(flash_ref(q, k, v, causal=False, interpret=True))
    np.testing.assert_allclose(got.numpy(), kernel, atol=2e-5)


@pytest.mark.parametrize("h,hkv,d,length,max_len", [
    (8, 2, 128, 150, 200),     # GQA at D 128, a decode step
    (4, 4, 64, 1999, 2010),    # kv_len 2000: 31 full splits and 16 columns
    (4, 4, 96, 70, 80),        # D 96
], ids=["gqa-d128", "kv2000", "d96"])
def test_split_kv_f32_model_matches_the_reference_cache_masks(h, hkv, d,
                                                              length,
                                                              max_len):
    (q, k, v), _ = window_case(1, h, hkv, d, length, 1, max_len, None,
                               seed=length)
    rep = h // hkv
    kv_pos = np.broadcast_to(np.arange(max_len), (1, max_len))
    qn, kn, vn = (a.transpose(1, 2).numpy() for a in (q, k, v))
    want = _sdpa_dense(
        jnp.asarray(qn), jnp.asarray(np.repeat(kn, rep, axis=2)),
        jnp.asarray(np.repeat(vn, rep, axis=2)),
        q_positions=jnp.asarray(np.full((1, 1), length)),
        kv_positions=jnp.asarray(kv_pos),
        kv_valid=jnp.asarray(kv_pos < length + 1), causal=True, window=None)
    got = fa.split_kv_plain(q, k, v, causal=True, q_offset=length,
                            kv_len=length + 1, columns=fa.SPLIT_COLUMNS_F32)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=2e-5)


def test_split_kv_f32_model_with_a_window_matches_reference_sdpa():
    """mixtral's decode step past its window, at 64-column splits: the
    splits wholly below the band are left out."""
    (q, k, v), want = window_case(2, 8, 2, 64, 1000, 1, 1010, 300, seed=3)
    kw = dict(causal=True, q_offset=1000, kv_len=1001, window=300)
    assert fa.split_range(1, True, 1000, 1001, 300,
                          fa.SPLIT_COLUMNS_F32) == (10, 6)
    got = fa.split_kv_plain(q, k, v, columns=fa.SPLIT_COLUMNS_F32, **kw)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, atol=2e-5)
    assert fa.split_columns(torch.float32) == fa.SPLIT_COLUMNS_F32 == 64
    assert fa.split_columns(torch.bfloat16) == fa.SPLIT_COLUMNS == 128
