"""Kernel B5 (SSD chunked scan): the port's plain version — what its
wrapper runs on the CPU — against the reference's Pallas kernel in
interpret mode, its sequential oracle, and ``models/ssm.py::
ssd_chunked`` (initial state and final state, prime lengths), on the
same numpy-seeded inputs.

Bound: the reference's own, atol 5e-6 on outputs scaled by their max
(``tests/kernels/test_ssd_scan_kernel.py``); 5e-2 for bf16 x.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as ssd_ref
from repro.kernels.ssd_scan import ssd_scan_ref
from repro.models.ssm import ssd_chunked as ssd_chunked_ref
from repro_torch.kernels import ssd_scan as scan
from repro_torch.models.ssm import ssd_chunked


def make(bh, s, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bh, s, p)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((bh, s))).astype(np.float32)
    b = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bh, s, n)) * 0.3).astype(np.float32)
    return x, la, b, c


def port_bh(x, la, b, c, dtype=torch.float32):
    """The TPU signature [BH, S, ...] as the port's H = 1 layout."""
    y, _ = scan.ssd_scan(torch.from_numpy(x).to(dtype)[:, :, None],
                         torch.from_numpy(la)[..., None],
                         torch.from_numpy(b), torch.from_numpy(c))
    return y[:, :, 0].float().numpy()


def assert_scaled_close(got, want, atol=5e-6):
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.parametrize("bh,s,p,n", [(1, 128, 16, 8), (3, 256, 32, 16),
                                      (2, 512, 64, 64), (2, 200, 16, 8)])
def test_plain_matches_reference(bh, s, p, n):
    x, la, b, c = make(bh, s, p, n)
    got = port_bh(x, la, b, c)
    assert_scaled_close(got, np.asarray(ssd_scan_ref(x, la, b, c)))
    if s % 64 == 0:
        kernel = ssd_ref(x, la, b, c, chunk=64, interpret=True)
        assert_scaled_close(got, np.asarray(kernel))


def test_bf16_x():
    x, la, b, c = make(2, 128, 32, 16, seed=1)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    got = port_bh(xb, la, b, c, dtype=torch.bfloat16)
    ref = np.asarray(ssd_scan_ref(jnp.asarray(xb, jnp.bfloat16), la, b, c),
                     np.float32)
    assert_scaled_close(got, ref, atol=5e-2)


def test_decay_isolation():
    """With la = -40 (full decay) each step only sees itself."""
    x, _, b, c = make(1, 128, 8, 4, seed=5)
    la = np.full((1, 128), -40.0, np.float32)
    expect = np.einsum("bsn,bsn->bs", c, b)[..., None] * x
    np.testing.assert_allclose(port_bh(x, la, b, c), expect, atol=1e-5)


@pytest.mark.parametrize("s,chunk", [(37, 8), (131, 128), (64, 16)],
                         ids=["prime-37", "prime-131", "even"])
def test_state_in_and_out_match_ssd_chunked(s, chunk):
    """The model layout [B, S, H, P] with shared b, c [B, S, N], a
    nonzero state0, and the final state, against the reference's
    ``ssd_chunked`` (which shrinks its chunk to a divisor of S: 1 at a
    prime S)."""
    rng = np.random.default_rng(s)
    bsz, h, p, n = 2, 3, 8, 16
    xh = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((bsz, s, h))).astype(
        np.float32)
    b = (rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, s, n)) * 0.3).astype(np.float32)
    h0 = rng.standard_normal((bsz, h, n, p)).astype(np.float32)
    y_ref, f_ref = ssd_chunked_ref(xh, la, b, c, chunk, jnp.asarray(h0))
    y, f = ssd_chunked(*(torch.from_numpy(a) for a in (xh, la, b, c, h0)))
    assert y.dtype == torch.float32 and f.shape == (bsz, h, n, p)
    assert_scaled_close(y.numpy(), np.asarray(y_ref))
    assert_scaled_close(f.numpy(), np.asarray(f_ref))


def test_split_scan_equals_whole_scan():
    """Scanning a prefix, then the rest from its final state, gives the
    whole scan: the state handoff the serving caches rely on."""
    rng = np.random.default_rng(9)
    t = [torch.from_numpy(a) for a in (
        rng.standard_normal((1, 150, 2, 8)).astype(np.float32),
        -np.logaddexp(0.0, rng.standard_normal((1, 150, 2))).astype(
            np.float32),
        rng.standard_normal((1, 150, 4)).astype(np.float32) * 0.3,
        rng.standard_normal((1, 150, 4)).astype(np.float32) * 0.3)]
    y, f = scan.ssd_scan(*t)
    y1, f1 = scan.ssd_scan(*(a[:, :70] for a in t))
    y2, f2 = scan.ssd_scan(*(a[:, 70:] for a in t), h0=f1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(f2, f, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_bad_arguments():
    x = torch.zeros(1, 8, 2, 4)
    la, bc = torch.zeros(1, 8, 2), torch.zeros(1, 8, 3)
    with pytest.raises(ValueError, match="la must have shape"):
        scan.ssd_scan(x, la[:, :4], bc, bc)
    with pytest.raises(TypeError, match="b must be float32"):
        scan.ssd_scan(x, la, bc.double(), bc)
    with pytest.raises(ValueError, match="h0 must have shape"):
        scan.ssd_scan(x, la, bc, bc, h0=torch.zeros(1, 2, 3, 5))
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        scan.ssd_scan(torch.zeros(1, 8, 4, 2).transpose(2, 3), la, bc, bc)
    before = dict(scan.LAUNCHES)
    scan.ssd_scan(x, la, bc, bc)
    assert scan.LAUNCHES == before  # the CPU path counts no launch


def test_plain_takes_bf16_b_and_c_as_their_f32_values():
    """bf16 b, c widen to f32 exactly: the same result, bit for bit, as
    the f32-cast streams."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 100, 3, 8)).astype(
        np.float32))
    la = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((2, 100, 3)).astype(np.float32)))
    b, c = (torch.from_numpy(rng.standard_normal((2, 100, 16)).astype(
        np.float32) * 0.3).bfloat16() for _ in range(2))
    h0 = torch.from_numpy(rng.standard_normal((2, 3, 16, 8)).astype(
        np.float32))
    y, f = scan.ssd_scan_plain(x, la, b, c, h0)
    y32, f32 = scan.ssd_scan_plain(x, la, b.float(), c.float(), h0)
    assert torch.equal(y, y32) and torch.equal(f, f32)
    y_w, f_w = scan.ssd_scan(x, la, b, c, h0)   # the wrapper, CPU path
    assert torch.equal(y_w, y) and torch.equal(f_w, f)


@pytest.mark.parametrize("s", [64, 131], ids=["even", "prime"])
def test_ssd_chunked_with_bf16_b_c_matches_the_reference(s):
    """The model path: f32 x, bf16 b and c (as the served models hold
    them), against the reference's ``ssd_chunked`` given the same bf16
    streams."""
    rng = np.random.default_rng(s + 1)
    bsz, h, p, n = 2, 3, 8, 16
    xh = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((bsz, s, h))).astype(
        np.float32)
    b, c = (jnp.asarray(rng.standard_normal((bsz, s, n)) * 0.3, jnp.bfloat16)
            for _ in range(2))
    h0 = rng.standard_normal((bsz, h, n, p)).astype(np.float32)
    y_ref, f_ref = ssd_chunked_ref(xh, la, b, c, 64, jnp.asarray(h0))
    tb, tc = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in (b, c))
    y, f = ssd_chunked(torch.from_numpy(xh), torch.from_numpy(la), tb, tc,
                       torch.from_numpy(h0))
    assert y.dtype == torch.float32
    assert_scaled_close(y.numpy(), np.asarray(y_ref))
    assert_scaled_close(f.numpy(), np.asarray(f_ref))


def test_wrapper_checks_the_b_c_dtypes():
    x = torch.zeros(1, 8, 2, 4)
    la, bc = torch.zeros(1, 8, 2), torch.zeros(1, 8, 3)
    with pytest.raises(TypeError, match="b and c dtypes differ"):
        scan.ssd_scan(x, la, bc.bfloat16(), bc)
    with pytest.raises(TypeError, match="c must be float32 or bfloat16"):
        scan.ssd_scan(x, la, bc, bc.half())
    with pytest.raises(TypeError, match="la must be float32"):
        scan.ssd_scan(x, la.bfloat16(), bc, bc)
    y, f = scan.ssd_scan(x.bfloat16(), la, bc.bfloat16(), bc.bfloat16())
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32
