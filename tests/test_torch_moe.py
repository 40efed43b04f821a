"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's ``moe_apply(..., drop=False)`` — the routing every serving
path of the reference takes — on carried weights and the same
numpy-seeded inputs, in f32 at rtol/atol 2e-4 (the model tests' bound),
on the CPU.  Token counts include ones that are not a multiple of
``tokens_per_group`` (the reference then shrinks its groups; with no
drop the groups do not change the result).

``torch.topk`` does not promise JAX's tie order, so each case first
checks that its inputs leave a clear gap between the k-th and the next
router probability.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.layers import unzip_params
from repro_torch.interop import copy_params
from repro_torch.kernels import moe as kmoe
from repro_torch.models import moe

TOL = dict(rtol=2e-4, atol=2e-4)
GAP = 1e-4   # least margin between the k-th and (k+1)-th probability


def carried(d, d_ff, cfg_kw, seed, dtype=jnp.float32):
    rcfg = ref_moe.MoEConfig(**cfg_kw)
    vals = jax.tree.map(np.asarray, unzip_params(ref_moe.moe_init(
        jax.random.key(seed), d, d_ff, rcfg, dtype))[0])
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    mod = moe.moe_init(d, d_ff, moe.MoEConfig(**cfg_kw), tdt, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    copy_params(mod, vals)
    return rcfg, vals, moe.MoEConfig(**cfg_kw), mod


def assert_no_ties(mod, x, cfg):
    probs, _, _ = moe.route(mod, x.reshape(-1, x.shape[-1]), cfg)
    top = torch.sort(probs, dim=-1, descending=True).values
    k = cfg.top_k
    assert float((top[:, k - 1] - top[:, k]).min()) > GAP


@pytest.mark.parametrize("b,s,cfg_kw", [
    (2, 16, dict(num_experts=4, top_k=2, tokens_per_group=32)),
    (3, 7, dict(num_experts=4, top_k=2, tokens_per_group=8)),    # 21 tokens
    (1, 37, dict(num_experts=8, top_k=2, tokens_per_group=16)),  # prime
    (2, 9, dict(num_experts=6, top_k=1, tokens_per_group=5)),
    (2, 5, dict(num_experts=4, top_k=3, tokens_per_group=1024)),
], ids=["groups-of-32", "21-tokens", "prime-37", "top-1", "top-3"])
def test_moe_apply_matches_the_reference(b, s, cfg_kw):
    d, d_ff = 32, 48
    rcfg, vals, cfg, mod = carried(d, d_ff, cfg_kw, seed=b * s)
    x = np.random.default_rng(b * s).standard_normal(
        (b, s, d)).astype(np.float32)
    assert_no_ties(mod, torch.from_numpy(x), cfg)
    want, want_aux = jax.jit(lambda v, x: ref_moe.moe_apply(
        v, x, rcfg, drop=False))(vals, x)
    got, aux = moe.moe_apply(mod, torch.from_numpy(x), cfg, drop=False)
    assert got.dtype == torch.float32 and got.shape == (b, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_bf16_keeps_the_router_in_f32_and_rounds_the_gate():
    """In bf16 the router stays f32 (as in the reference); the result
    is in x's dtype.  Against the reference in bf16 the two frameworks
    round the expert products at other places, so the bound is bf16's:
    1e-2 of the output's largest value."""
    d, d_ff = 32, 48
    cfg_kw = dict(num_experts=4, top_k=2, tokens_per_group=16)
    rcfg, vals, cfg, mod = carried(d, d_ff, cfg_kw, seed=5,
                                   dtype=jnp.bfloat16)
    assert mod.router.dtype == torch.float32
    assert mod.wi.dtype == torch.bfloat16
    x32 = np.random.default_rng(5).standard_normal((2, 12, d))
    x = torch.from_numpy(x32.astype(np.float32)).bfloat16()
    assert_no_ties(mod, x, cfg)
    got, _ = moe.moe_apply(mod, x, cfg, drop=False)
    assert got.dtype == torch.bfloat16
    want, _ = ref_moe.moe_apply(vals, jnp.asarray(x.float().numpy(),
                                                  jnp.bfloat16),
                                rcfg, drop=False)
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max()


def test_every_token_reaches_its_experts():
    """Weighted sum of each token's top-k experts' SwiGLU outputs,
    written out token by token."""
    d, d_ff = 16, 24
    cfg = moe.MoEConfig(num_experts=4, top_k=2)
    mod = moe.moe_init(d, d_ff, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 10, d, generator=torch.Generator().manual_seed(2))
    got, _ = moe.moe_apply(mod, x, cfg, drop=False)
    _, gate, idx = moe.route(mod, x[0], cfg)
    for t in range(10):
        want = torch.zeros(d)
        for g, e in zip(gate[t], idx[t]):
            h = (torch.nn.functional.silu(x[0, t] @ mod.wg[e])
                 * (x[0, t] @ mod.wi[e]))
            want += g * (h @ mod.wo[e])
        torch.testing.assert_close(got[0, t], want, atol=1e-5, rtol=1e-5)


def test_capacity_drop_routing_raises():
    """Capacity-drop routing (the default, ``drop=True``) is ported: with
    every token routed to experts 0 then 1 and 4 slots an expert (8
    tokens a group, capacity factor 1), the first four tokens keep both
    choices and the last four lose both, so their output is 0; with
    ``drop=False`` every token is served (``tests/test_torch_moe_drop.py``,
    against the reference's ``moe_apply``, holds the general case)."""
    d = 8
    cfg = moe.MoEConfig(num_experts=4, top_k=2, tokens_per_group=8,
                        capacity_factor=1.0)
    mod = moe.moe_init(d, 8, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        mod.router.zero_()
        mod.router[0] = torch.tensor([3.0, 2.0, 0.0, 0.0])
    x = torch.ones(1, 8, d) + 0.1 * torch.randn(
        1, 8, d, generator=torch.Generator().manual_seed(1))
    keep = moe.capacity_keep(moe.route(mod, x[0], cfg)[2], cfg)
    assert keep.tolist() == [[True, True]] * 4 + [[False, False]] * 4
    y, _ = moe.moe_apply(mod, x, cfg)
    full, _ = moe.moe_apply(mod, x, cfg, drop=False)
    assert torch.equal(y[0, 4:], torch.zeros(4, d))
    torch.testing.assert_close(y[0, :4], full[0, :4], rtol=0, atol=0)
    assert bool((full[0, 4:] != 0).any())


# --- the grouped pipeline (kernels/moe) and the path choice ------------------

def reduced_layer(e=4, k=2, d=64, f=128, seed=0):
    """A reduced MoE layer in f32 on the CPU (mixtral's reduced widths by
    default) with its config."""
    cfg = moe.MoEConfig(num_experts=e, top_k=k)
    mod = moe.moe_init(d, f, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed))
    return cfg, mod


def routing_case(case: str, t: int, e: int, k: int, seed: int = 0):
    """Seeded ``(idx [t, k], gate [t, k])``: distinct experts a token,
    renormalised gates; ``empty``: expert 2 chosen by none; ``one``:
    every pair on expert 0 (k = 1); ``uneven``: expert 0 chosen by
    every token."""
    g = torch.Generator().manual_seed(seed)
    pool = [x for x in range(e) if not (case == "empty" and x == 2)]
    idx = torch.stack([torch.tensor(pool)[torch.randperm(len(pool),
                                                         generator=g)[:k]]
                       for _ in range(t)])
    if case == "one":
        idx = torch.zeros(t, k, dtype=torch.long)
    if case == "uneven":
        idx[:, 0] = 0
        idx[:, 1:] = 1 + torch.stack([torch.randperm(e - 1, generator=g)[
            :k - 1] for _ in range(t)])
    gate = torch.rand(t, k, generator=g) + 0.1
    return idx.long(), gate / gate.sum(-1, keepdim=True)


@pytest.mark.parametrize("case,t,e,k", [
    ("uneven", 40, 4, 2), ("empty", 40, 4, 2), ("one", 37, 4, 1),
    ("decode", 1, 4, 2), ("ragged", 131, 8, 2), ("top-3", 29, 6, 3),
])
def test_the_grouped_pipeline_equals_the_loop(case, t, e, k):
    """The grouped pipeline's plain version (dispatch, the two grouped
    products, the combine) against the host loop at the reduced widths,
    in f32: every expert's rows in the loop's order and the sum in the
    loop's order, so the two agree to f32 rounding.  Cases: one expert
    chosen by every token, an expert with no pairs, every pair on one
    expert, one token (decode), a token count that is no multiple of any
    tile, three choices a token."""
    cfg, mod = reduced_layer(e=e, k=k)
    idx, gate = routing_case(case, t, e, k, seed=t)
    xt = torch.randn(t, 64, generator=torch.Generator().manual_seed(1))
    weights = (mod.wi, mod.wg, mod.wo)
    want = moe._experts(xt, gate, idx, cfg, False, t, 0, weights)
    got, offs = kmoe.experts_plain(xt, gate, idx, *weights)
    counts = torch.bincount(idx.flatten(), minlength=e)
    assert offs.tolist() == [0] + counts.cumsum(0).tolist()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # the wrappers take the plain version for CPU tensors
    got_w, _ = kmoe.experts(xt, gate, idx, *weights)
    assert torch.equal(got_w, got)


def test_the_dispatch_is_stable_and_the_combine_sums_in_expert_order():
    """Slots put an expert's pairs in token order; the combine's sum runs
    over a token's pairs in expert order, whatever their choice order."""
    idx = torch.tensor([[2, 0], [0, 1], [1, 2], [0, 2]])
    offs, slot, xs = kmoe.dispatch_plain(torch.arange(4.)[:, None], idx, 3)
    assert offs.tolist() == [0, 3, 5, 8]
    assert slot.tolist() == [5, 0, 1, 3, 4, 6, 2, 7]
    assert xs.flatten().tolist() == [0, 1, 3, 1, 2, 0, 2, 3]
    yp = torch.tensor([[1.0], [2.0], [3.0], [4.0], [5.0], [6.0], [7.0],
                       [8.0]])
    gate = torch.tensor([[0.25, 0.75]] * 4)
    y = kmoe.combine_plain(yp, slot, gate, idx)
    # token 0: expert 0 (slot 0, gate 0.75) then expert 2 (slot 5, 0.25)
    assert y[0].item() == 0.75 * 1.0 + 0.25 * 6.0


class _CudaLike:
    """What :func:`moe.grouped_path` reads of x: a plain CUDA tensor."""

    is_cuda = True

    def __init__(self, dtype, requires_grad=False):
        self.dtype, self.requires_grad = dtype, requires_grad


class DTensor(_CudaLike):
    device_mesh = None


@pytest.mark.parametrize("kind,drop,want", [
    ("cuda-bf16", False, True),
    ("cuda-bf16-recorded", False, False),
    ("cuda-bf16-no-grad-mode", False, True),
    ("drop", True, False),
    ("dtensor", False, False),
    ("meta", False, False),
    ("cpu", False, False),
    ("cuda-f32", False, False),
])
def test_the_path_choice_by_input_kind(kind, drop, want):
    """The grouped path serves ``drop=False`` for a plain CUDA tensor in
    bf16 with no gradient recorded; training routing, a recorded gradient,
    a DTensor, the meta device, the CPU and f32 keep the loop."""
    cfg, mod = reduced_layer()
    x = {"cuda-bf16": _CudaLike(torch.bfloat16),
         "cuda-bf16-recorded": _CudaLike(torch.bfloat16, requires_grad=True),
         "cuda-bf16-no-grad-mode": _CudaLike(torch.bfloat16,
                                             requires_grad=True),
         "drop": _CudaLike(torch.bfloat16),
         "dtensor": DTensor(torch.bfloat16),
         "meta": torch.empty(1, 4, 64, dtype=torch.bfloat16, device="meta"),
         "cpu": torch.zeros(1, 4, 64, dtype=torch.bfloat16),
         "cuda-f32": _CudaLike(torch.float32)}[kind]
    with torch.set_grad_enabled(kind != "cuda-bf16-no-grad-mode"):
        assert moe.grouped_path(mod, x, cfg, drop) is want


def test_the_path_choice_needs_shapes_the_kernels_take():
    cfg, mod = reduced_layer(d=96, f=128)
    assert not moe.grouped_path(mod, _CudaLike(torch.bfloat16), cfg, False)
    assert not kmoe.supports(96, 128, 4, 2)
    assert kmoe.supports(4096, 14336, 8, 2)
    assert not kmoe.supports(4096, 14336, kmoe.MAX_EXPERTS + 1, 2)


def test_the_path_choice_limits_are_the_kernels_table_sizes():
    """``supports`` decides on the sizes of the kernels' shared-memory
    tables, which the CUDA source states."""
    import re
    from pathlib import Path

    src = (Path(kmoe.__file__).parent / "csrc" / "moe.cu").read_text()
    sizes = dict(re.findall(r"constexpr int (kMax\w+) = (\d+);", src))
    assert (int(sizes["kMaxExperts"]), int(sizes["kMaxK"])) == (
        kmoe.MAX_EXPERTS, kmoe.MAX_K)


def _traced_layer(monkeypatch, grouped: bool):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import tracing

    cfg, mod = reduced_layer(e=4, k=2)
    x = torch.randn(2, 21, 64, generator=torch.Generator().manual_seed(3))
    monkeypatch.setattr(moe, "grouped_path", lambda *a: grouped)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]):
        y, _ = moe.moe_apply(mod, x, cfg, drop=False)
    return y, tracing.take()[1]


def test_the_grouped_path_counts_a_device_dispatch_and_no_host_sync(
        monkeypatch):
    """A grouped call records ``moe.device_dispatch`` once and no
    ``host_sync.moe_counts``; the loop records the counts' syncs and no
    device dispatch; both give the same y."""
    y, counts = _traced_layer(monkeypatch, True)
    names = [c[0] for c in counts]
    assert names.count("moe.device_dispatch") == 1
    assert "host_sync.moe_counts" not in names
    y_loop, counts_loop = _traced_layer(monkeypatch, False)
    names = [c[0] for c in counts_loop]
    assert "moe.device_dispatch" not in names
    assert names.count("host_sync.moe_counts") == 1
    torch.testing.assert_close(y, y_loop, rtol=1e-6, atol=1e-6)


def test_a_tensor_expert_load_is_read_as_the_loops_float(monkeypatch):
    """The grouped path keeps ``moe.expert_load`` as a 0-dim tensor (no
    read inside the window); ``tracing.take`` returns it as a float equal
    to the loop's."""
    from repro_torch.runtime import tracing

    tracing.take()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.count("probe", torch.tensor(2.5, dtype=torch.float64))
        assert isinstance(tracing._counts[-1][2], torch.Tensor)
    assert tracing.take()[1][0][2] == 2.5
    _, counts = _traced_layer(monkeypatch, True)
    _, counts_loop = _traced_layer(monkeypatch, False)
    load = [c[2] for c in counts if c[0] == "moe.expert_load"]
    load_loop = [c[2] for c in counts_loop if c[0] == "moe.expert_load"]
    assert len(load) == 1 and type(load[0]) is float
    assert load == load_loop
