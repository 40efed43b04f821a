"""The port's training pieces (``repro_torch.train``, every family's
``loss_fn``, ``runtime.straggler``) against the JAX package's, on the
CPU, inputs from numpy seeds, in f32:

* ``constant`` and ``warmup_cosine`` within 1e-7 at every step of a
  schedule;
* ``adamw`` and ``adafactor`` given identical gradients and state: new
  parameters and moments within 1e-6 relative, for leaves of rank 1, 2
  and 3 (Adafactor factors the last two dimensions of a rank >= 2 leaf),
  from zero and from a non-zero state;
* ``synthetic_batch`` bit for bit, bf16 inputs included;
* each of the 10 reduced architectures' ``loss_fn`` with every
  parameter carried across (``interop.model_from_reference``): the loss
  within rtol/atol 2e-4 (the models' ``TOL``) and each gradient leaf (the
  port's per-layer gradients stacked as the reference's leaf) within
  2e-4 of the reference's, relative to the leaf's largest |g|; the
  reference's ``jax.value_and_grad`` is compiled once per architecture
  for the module (a fixture);
* the kernel wrappers' ``autograd.Function``s: B4's closed-form backward
  and B5's recomputed one against autograd through the plain versions,
  and the launches a remat'ed training step makes (each Mamba2 layer's
  B5 twice, each shared-attention site's B4 once);
* ``StragglerMonitor`` against the reference on one scripted heartbeat
  sequence.

The one-step parity of ``build_train_step`` is in
``tests/test_torch_train_step.py``, the MoE capacity drop in
``tests/test_torch_moe_drop.py``.
"""
from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import list_archs
from repro.configs.reduced import SMOKE_SHAPE as REF_SMOKE
from repro.configs.reduced import reduced_arch as ref_reduced_arch
from repro.models.layers import unzip_params
from repro.runtime.straggler import StragglerMonitor as RefMonitor
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro.train import schedule as ref_sched
from repro_torch.configs.reduced import SMOKE_SHAPE, reduced_arch
from repro_torch.interop import model_from_reference
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as scan
from repro_torch.launch.serve import with_config
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import data, optimizer, schedule
from repro_torch.train.optimizer import leaf_path, leaf_tensors, param_leaves

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = 2e-4      # each gradient leaf, relative to its largest |g|
OPT_RTOL = 1e-6
ARCHS = list_archs()


def f32_specs(arch_id):
    """The reduced spec of each package with its config in f32."""
    rspec, pspec = ref_reduced_arch(arch_id), reduced_arch(arch_id)
    if hasattr(rspec.config, "backbone"):
        rcfg = dataclasses.replace(rspec.config, backbone=dataclasses.replace(
            rspec.config.backbone, dtype=jnp.float32))
    else:
        rcfg = dataclasses.replace(rspec.config, dtype=jnp.float32)
    return (dataclasses.replace(rspec, config=rcfg),
            dataclasses.replace(pspec, config=with_config(
                pspec.config, dtype=torch.float32)))


def seeded_batch(rspec, seed=3):
    """A train batch at the smoke shape, numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sds in rspec.input_specs(REF_SMOKE).items():
        if jnp.issubdtype(sds.dtype, jnp.integer):
            out[name] = rng.integers(0, rspec.vocab, sds.shape,
                                     dtype=np.int32)
        else:
            out[name] = rng.standard_normal(sds.shape).astype(np.float32)
    return out


def ref_leaf(tree, leaf: str):
    for key in leaf.split("."):
        tree = tree[key]
    return np.asarray(tree)


# --- schedules ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["constant", "warmup_cosine"])
def test_schedules_equal_the_reference(kind):
    if kind == "constant":
        got, want = schedule.constant(3e-4), ref_sched.constant(3e-4)
    else:
        got = schedule.warmup_cosine(3e-4, 50, 400, final_fraction=0.1)
        want = ref_sched.warmup_cosine(3e-4, 50, 400, final_fraction=0.1)
    for step in list(range(0, 60)) + list(range(60, 420, 7)):
        g = float(got(torch.tensor(step, dtype=torch.int32)))
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(g - w) <= 1e-7, (step, g, w)


# --- optimizers ---------------------------------------------------------------

SHAPES = {"bias": (7,), "w": (6, 5), "stack": (3, 4, 6)}


def leaf_values(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("start", ["zero", "warm"])
def test_optimizer_update_equals_the_reference(name, start):
    """One update from identical params, gradients and state (zero, or
    the state after three earlier updates) at step 0 / 3."""
    make = {"adamw": (optimizer.adamw, ref_opt.adamw),
            "adafactor": (optimizer.adafactor, ref_opt.adafactor)}[name]
    sched = (schedule.warmup_cosine(1e-2, 2, 10),
             ref_sched.warmup_cosine(1e-2, 2, 10))
    port, ref = make[0](sched[0]), make[1](sched[1])
    params = leaf_values(0)
    rstate = ref.init({k: jnp.asarray(v) for k, v in params.items()})
    rparams = {k: jnp.asarray(v) for k, v in params.items()}
    step0 = 0
    if start == "warm":
        for step0 in range(3):
            g = {k: jnp.asarray(v) for k, v in leaf_values(10 + step0).items()}
            rparams, rstate = ref.update(g, rstate, rparams,
                                         jnp.asarray(step0, jnp.int32))
        step0 = 3
    # carry the reference's state and params across
    pparams = {k: torch.from_numpy(np.array(v)) for k, v in rparams.items()}
    if name == "adamw":
        pstate = {k: {m: torch.from_numpy(np.array(rstate[m][k]))
                      for m in ("m", "v")} for k in SHAPES}
    else:
        pstate = {k: {m: torch.from_numpy(np.array(v))
                      for m, v in rstate[k].items()} for k in SHAPES}
    assert set(pstate) == set(port.init(pparams))
    grads = leaf_values(99, scale=0.5)
    new_p, new_s = port.update({k: torch.from_numpy(v)
                                for k, v in grads.items()}, pstate, pparams,
                               torch.tensor(step0, dtype=torch.int32))
    want_p, want_s = ref.update({k: jnp.asarray(v) for k, v in grads.items()},
                                rstate, rparams,
                                jnp.asarray(step0, jnp.int32))
    for k in SHAPES:
        np.testing.assert_allclose(new_p[k].numpy(), np.asarray(want_p[k]),
                                   rtol=OPT_RTOL, atol=0)
        assert not np.array_equal(new_p[k].numpy(), pparams[k].numpy())
        for m, v in new_s[k].items():
            want = (want_s[m][k] if name == "adamw" else want_s[k][m])
            np.testing.assert_allclose(v.numpy(), np.asarray(want),
                                       rtol=OPT_RTOL, atol=0)
    if name == "adafactor":
        assert set(new_s["bias"]) == {"v"}
        assert set(new_s["w"]) == set(new_s["stack"]) == {"vr", "vc"}
        assert new_s["stack"]["vr"].shape == (3, 4)
        assert new_s["stack"]["vc"].shape == (3, 6)


def test_param_leaves_follow_the_reference_stacking():
    """A port parameter's leaf is its reference path without its layer
    indices; the leaves of every reduced model are the reference's."""
    assert leaf_path("groups.1.4.wx") == (("groups", "wx"), (1, 4))
    assert leaf_path("backbone.blocks.0.attn.wq") == (
        ("backbone", "blocks", "attn", "wq"), (0,))
    for arch in ARCHS:
        rspec, pspec = f32_specs(arch)
        values, _ = unzip_params(jax.eval_shape(
            lambda k: rspec.family.init(k, rspec.config), jax.random.key(0)))
        model = pspec.family.init(pspec.config, device="cpu")
        leaves = param_leaves(model)
        ref = {".".join(str(getattr(k, "key", k)) for k in path): v.shape
               for path, v in jax.tree_util.tree_flatten_with_path(values)[0]}
        assert set(leaves) == set(ref), arch
        for leaf, info in leaves.items():
            shape = dict(model.named_parameters())[info.names[0]].shape
            assert info.lead + tuple(shape) == tuple(ref[leaf]), (arch, leaf)


# --- data ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3-8b", "seamless-m4t-medium",
                                  "phi-3-vision-4.2b"])
def test_synthetic_batch_is_bit_identical(arch):
    """Token ids, labels and the float inputs (bf16 frames or patches at
    the reduced configs' dtype) equal the reference's, for two steps."""
    rspec, pspec = ref_reduced_arch(arch), reduced_arch(arch)
    rstream = ref_data.SyntheticStream(rspec.input_specs(REF_SMOKE),
                                       rspec.vocab, seed=7)
    pstream = data.SyntheticStream(pspec.input_shapes(SMOKE_SHAPE),
                                   pspec.vocab, seed=7)
    for step in (0, 5):
        got, want = pstream.batch(step), rstream.batch(step)
        assert list(got) == list(want)
        for k in want:
            w = np.asarray(want[k])
            g = got[k]
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
            if w.dtype.name == "bfloat16":
                g, w = g.float().numpy(), w.astype(np.float32)
            else:
                g = g.numpy()
            assert np.array_equal(g, w), (arch, step, k)
    assert not torch.equal(pstream.batch(0)["tokens"],
                           pstream.batch(1)["tokens"])


# --- loss and gradients ---------------------------------------------------------


def reference_value_and_grad(arch):
    rspec, pspec = f32_specs(arch)
    values, _ = unzip_params(rspec.family.init(jax.random.key(2),
                                               rspec.config))
    values = jax.tree.map(np.asarray, values)
    batch = seeded_batch(rspec)
    fam, cfg = rspec.family, rspec.config
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: fam.loss_fn(p, b, cfg)))(values, batch)
    return values, batch, float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def reference():
    return {arch: reference_value_and_grad(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_the_reference(reference, arch):
    values, batch, ref_loss, ref_grads = reference[arch]
    _, pspec = f32_specs(arch)
    model = model_from_reference(pspec.family_name, pspec.config, values,
                                 device="cpu")
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = pspec.family.loss_fn(model, tb, pspec.config)
    np.testing.assert_allclose(float(loss.detach()), ref_loss, **TOL)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = {k: v.numpy() for k, v in leaf_tensors(model, grads).items()}
    worst = 0.0
    for leaf, g in got.items():
        want = ref_leaf(ref_grads, leaf)
        scale = float(np.abs(want).max())
        assert scale > 0, (arch, leaf)
        err = float(np.abs(g - want).max()) / scale
        worst = max(worst, err)
        assert err <= GRAD_TOL, (arch, leaf, err)
    print(f"{arch}: loss {float(loss.detach()):.6f}, worst leaf {worst:.2e}")


def test_tied_embeddings_take_both_gradients(reference):
    """A tied table is one Parameter: its gradient is the embedding's and
    the logits head's together, as the reference's one leaf."""
    values, batch, _, ref_grads = reference["mamba2-780m"]
    _, pspec = f32_specs("mamba2-780m")
    model = model_from_reference("ssm", pspec.config, values, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert "embed.table" in names and not any("unembed" in n for n in names)
    assert model.embed.table is dict(model.named_parameters())["embed.table"]
    model.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = pspec.family.loss_fn(model, tb, pspec.config)
    (g,) = torch.autograd.grad(loss, [model.embed.table])
    want = ref_grads["embed"]["table"]
    assert float(np.abs(g.numpy() - want).max()) <= \
        GRAD_TOL * float(np.abs(want).max())
    # the head's share alone is most of it: without it the rows of
    # tokens never seen in the batch would have no gradient
    unseen = np.setdiff1d(np.arange(pspec.config.vocab), batch["tokens"])
    assert np.abs(g.numpy()[unseen]).max() > 0


def test_serving_builds_no_autograd_graph():
    """``prefill`` and ``decode_step`` run without grad even when the
    parameters require it."""
    _, pspec = f32_specs("zamba2-1.2b")
    fam, cfg = pspec.family, pspec.config
    model = fam.init(cfg, device="cpu").requires_grad_(True)
    caches = fam.init_caches(cfg, 1, 8, device="cpu")
    logits, caches = fam.prefill(model, {"tokens": torch.arange(4)[None]},
                                 cfg, caches)
    assert logits.grad_fn is None and not logits.requires_grad
    logits, _ = fam.decode_step(model, {"token": torch.tensor([[1]])}, cfg,
                                caches, 4)
    assert logits.grad_fn is None


# --- the kernels' autograd functions --------------------------------------------


@pytest.mark.parametrize("case", [
    dict(b=2, h=4, hkv=2, sq=16, sk=16, d=8, causal=True),
    dict(b=1, h=4, hkv=4, sq=8, sk=24, d=16, causal=True, q_offset=10,
         kv_len=18),
    dict(b=1, h=4, hkv=2, sq=20, sk=20, d=8, causal=True, window=5),
    dict(b=2, h=4, hkv=2, sq=7, sk=30, d=8, causal=False),
], ids=["gqa_causal", "offset", "window", "cross"])
def test_flash_attention_gradient_is_the_plain_versions(case, monkeypatch):
    """The wrapper under grad returns an output with a ``grad_fn`` (B4's
    Function); its closed-form backward equals autograd through the
    plain version, also with the rows taken in blocks."""
    case = dict(case)
    b, h, hkv, sq, sk, d = (case.pop(k) for k in ("b", "h", "hkv", "sq",
                                                  "sk", "d"))
    gen = torch.Generator().manual_seed(4)
    q = torch.randn(b, h, sq, d, generator=gen).requires_grad_()
    k = torch.randn(b, hkv, sk, d, generator=gen).requires_grad_()
    v = torch.randn(b, hkv, sk, d, generator=gen).requires_grad_()
    plain = fa.flash_attention_plain(q, k, v, **case)
    g = torch.randn(plain.shape, generator=gen)
    want = torch.autograd.grad(plain, (q, k, v), g)
    module = sys.modules[fa.flash_attention.__module__]
    for block in (module.PLAIN_BLOCK_ELEMENTS, 2 * h * b * sk):
        monkeypatch.setattr(module, "PLAIN_BLOCK_ELEMENTS", block)
        out = fa.flash_attention(q, k, v, **case)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-6)
        got = torch.autograd.grad(out, (q, k, v), g)
        for a, w in zip(got, want):
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
    with torch.no_grad():
        assert fa.flash_attention(q, k, v, **case).grad_fn is None


@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_scan_gradient_is_the_plain_versions(with_h0):
    gen = torch.Generator().manual_seed(5)
    bsz, s, h, p, n = 2, 70, 3, 4, 5
    x = torch.randn(bsz, s, h, p, generator=gen).requires_grad_()
    la = (-torch.rand(bsz, s, h, generator=gen)).requires_grad_()
    b = torch.randn(bsz, s, n, generator=gen).requires_grad_()
    c = torch.randn(bsz, s, n, generator=gen).requires_grad_()
    h0 = (torch.randn(bsz, h, n, p, generator=gen).requires_grad_()
          if with_h0 else None)
    y, final = scan.ssd_scan(x, la, b, c, h0)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    inputs = [t for t in (x, la, b, c, h0) if t is not None]
    gy = torch.randn(y.shape, generator=gen)
    gf = torch.randn(final.shape, generator=gen)
    for outs, gouts in (((y, final), (gy, gf)), ((y,), (gy,))):
        got = torch.autograd.grad(outs, inputs, gouts, retain_graph=True)
        py, pf = scan.ssd_scan_plain(x, la, b, c, h0)
        want = torch.autograd.grad((py, pf)[:len(outs)], inputs, gouts)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0)


def test_training_step_kernel_calls_follow_the_remat_placement(monkeypatch):
    """One loss and gradient of the reduced zamba2 (5 Mamba2 layers, 2
    shared-attention sites): each Mamba2 layer's scan runs in the forward
    and again in the backward's recomputation, the shared attention once
    (not remat'ed); with ``remat=False`` each runs once."""
    _, pspec = f32_specs("zamba2-1.2b")
    cfg = pspec.config
    calls = {"flash": 0, "scan": 0}
    fa_mod = sys.modules[fa.flash_attention.__module__]
    sc_mod = sys.modules[scan.ssd_scan.__module__]
    own_fa, own_sc = fa_mod._forward, sc_mod._forward

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(fa_mod, "_forward", count("flash", own_fa))
    monkeypatch.setattr(sc_mod, "_forward", count("scan", own_sc))
    batch = {k: torch.from_numpy(v) for k, v in
             seeded_batch(ref_reduced_arch("zamba2-1.2b")).items()}
    for remat, scans in ((True, 2 * cfg.layers), (False, cfg.layers)):
        c = dataclasses.replace(cfg, remat=remat)
        model = pspec.family.init(c, device="cpu").requires_grad_(True)
        calls.update(flash=0, scan=0)
        loss = pspec.family.loss_fn(model, batch, c)
        torch.autograd.grad(loss, list(model.parameters()))
        assert calls == {"flash": c.num_groups, "scan": scans}, (remat,
                                                                 calls)


# --- straggler monitor -----------------------------------------------------------


def test_straggler_monitor_equals_the_reference():
    """One scripted run of heartbeats and checks on a fake clock: every
    decision and deadline equal."""
    script = [("hb", 0, 0), ("hb", 1, 0), ("hb", 2, 0), ("tick", 1.0),
              ("check",)]
    for step in range(1, 12):
        script += [("tick", 1.0 + 0.1 * step), ("hb", 0, step),
                   ("hb", 1, step)]
        if step < 6:
            script.append(("hb", 2, step))
        script.append(("check",))
    script += [("tick", 40.0), ("check",), ("remove", 2), ("check",)]

    def run(cls):
        now = [0.0]
        mon = cls(num_workers=3, predicted_step_s=2.0, slack=3.0,
                  fail_factor=5.0, clock=lambda: now[0])
        out = []
        for ev in script:
            if ev[0] == "tick":
                now[0] += ev[1]
            elif ev[0] == "hb":
                mon.heartbeat(ev[1], ev[2])
            elif ev[0] == "remove":
                mon.remove(ev[1])
            else:
                d = mon.check()
                out.append((d.stragglers, d.failed, d.deadline_s))
        return out, mon.durations

    got, want = run(StragglerMonitor), run(RefMonitor)
    assert got == want
    assert any(s for s, _, _ in got[0]) and any(f for _, f, _ in got[0])
    with pytest.raises(ValueError):
        StragglerMonitor(1, 0.0)
