"""The port's sharding rules, meshes and cell builders against the JAX
package's, on the CPU, nothing allocated (the port's abstract arguments
live on the meta device, the reference's are ``ShapeDtypeStruct``s on a
``jax.sharding.AbstractMesh``):

* every full-size cell (10 archs x 4 shapes, less the 7 skips) on the
  16x16 ``pod`` and 2x16x16 ``multipod`` meshes: ``build_cell``'s kind,
  ``donate_argnums``, in/out shardings and abstract shapes and dtypes,
  leaf by leaf by the reference's tree paths (the port's cache lengths
  are Python ints where the reference holds int32 arrays: their
  shardings are compared, their shapes are not);
* ``param_shardings``' fallbacks over each arch's parameters and
  optimizer state;
* the logical axes of every parameter, cache and optimizer moment;
* ROADMAP C10: the rule overrides that name mesh axes no mesh has
  ("tp", "dp", "dp+tp") replicate, in both packages, case by case;
* ``ShardingRules``, ``pspec_for``, ``shard`` and the meshes.
"""
from __future__ import annotations

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as RefNamedSharding

from repro.configs import REGISTRY as REF_REGISTRY
from repro.configs import SHAPES as REF_SHAPES
from repro.dist import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.models.layers import unzip_params
from repro_torch.configs import REGISTRY, SHAPES
from repro_torch.dist import sharding
from repro_torch.dist.tree import keystr, leaves_with_path, nest
from repro_torch.launch import steps
from repro_torch.launch.mesh import (
    Mesh, make_device_mesh, make_host_mesh, make_production_mesh,
)
from repro_torch.models.layers import param_axes
from repro_torch.runtime.checkpoint import _as_tree, _nest_opt
from repro_torch.train.train_step import TrainState

ARCHS = sorted(REGISTRY)
CELLS = [(a, s) for a in ARCHS for s in SHAPES if s not in REGISTRY[a].skip]
MESHES = ("pod", "multipod")


def ref_mesh(name: str) -> AbstractMesh:
    if name == "multipod":
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def port_mesh(name: str) -> Mesh:
    return make_production_mesh(multi_pod=name == "multipod")


def ref_flat(tree) -> dict:
    """``{keystr: leaf}`` of a reference tree (NamedShardings as leaves)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefNamedSharding))[0]
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def port_flat(tree) -> dict:
    return {keystr(p): leaf for p, leaf in leaves_with_path(tree)}


def reference_form(kind: str, args: tuple) -> tuple:
    """A port cell's arguments or shardings in the reference's tree shape:
    a train state as ``TrainState(step, nested params, opt_state tree)``,
    a model's ``{leaf: x}`` nested."""
    first, *rest = args
    if kind == "train":
        if isinstance(first, TrainState):
            first = _as_tree(first)
        return (first, *rest)
    if isinstance(first, torch.nn.Module):
        first = steps.stacked_params(first)
    if isinstance(first, dict):     # parameters (not a logits sharding)
        first = nest(first)
    return (first, *rest)


def test_the_cell_list_is_the_references():
    ref = [(a, s) for a in sorted(REF_REGISTRY) for s in REF_SHAPES
           if s not in REF_REGISTRY[a].skip]
    assert CELLS == ref and len(CELLS) == 33


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_build_cell_equals_the_reference(arch, shape, mesh_name):
    rc = ref_steps.build_cell(REF_REGISTRY[arch], REF_SHAPES[shape],
                              ref_mesh(mesh_name))
    pc = steps.build_cell(REGISTRY[arch], SHAPES[shape],
                          port_mesh(mesh_name))
    assert pc.kind == rc.kind
    assert pc.donate_argnums == rc.donate_argnums
    for which in ("in_shardings", "out_shardings"):
        want = {k: tuple(v.spec)
                for k, v in ref_flat(getattr(rc, which)).items()}
        got = {k: v.spec for k, v in port_flat(reference_form(
            pc.kind, getattr(pc, which))).items()}
        assert got == want, which
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in ref_flat(rc.abstract_args).items()}
    got = port_flat(reference_form(pc.kind, pc.abstract_args))
    assert set(got) == set(want)
    for key, leaf in got.items():
        if isinstance(leaf, torch.Tensor):
            assert leaf.device.type == "meta"
            assert (tuple(leaf.shape),
                    str(leaf.dtype).removeprefix("torch.")) == want[key], key
        else:   # a cache length: an int here, an int32 array there
            assert isinstance(leaf, int) and want[key][1] == "int32", key


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_fallbacks_equal_the_reference(arch, mesh_name):
    rspec, pspec = REF_REGISTRY[arch], REGISTRY[arch]
    rrules = ref_steps.build_rules(ref_mesh(mesh_name), rspec, "train")
    prules = steps.build_rules(port_mesh(mesh_name), pspec, "train")
    rvals, raxes = ref_steps.abstract_params(rspec)
    model, paxes = steps.abstract_params(pspec)
    leaves = steps.stacked_params(model)
    _, want = ref_sharding.param_shardings(rvals, raxes, rrules)
    _, got = sharding.param_shardings(leaves, paxes, prules)
    assert got == want
    ropt = ref_steps.make_optimizer(rspec)
    popt = steps.make_optimizer(pspec)
    _, want = ref_sharding.param_shardings(
        jax.eval_shape(ropt.init, rvals), ropt.state_axes(raxes), rrules)
    state = popt.init(leaves)
    _, got = sharding.param_shardings(state, popt.state_axes(paxes), prules)
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_axes_equal_the_reference(arch):
    """Every parameter's, cache's and optimizer moment's logical axes,
    from models built on meta (the reference's through ``eval_shape``)."""
    rspec, pspec = REF_REGISTRY[arch], REGISTRY[arch]
    _, raxes = unzip_params(jax.eval_shape(
        lambda k: rspec.family.init(k, rspec.config), jax.random.key(0)))
    paxes = param_axes(pspec.family.init(pspec.config, device="meta"))
    is_axes = lambda t: isinstance(t, tuple) and all(    # noqa: E731
        isinstance(a, (str, type(None))) for a in t)
    flat = jax.tree_util.tree_flatten_with_path(raxes, is_leaf=is_axes)[0]
    assert paxes == {".".join(k.key for k in p): a for p, a in flat}
    got = pspec.family.cache_axes(pspec.config)
    want = rspec.family.cache_axes(rspec.config)
    assert got == want and type(got).__name__ == type(want).__name__
    ropt = ref_steps.make_optimizer(rspec).state_axes(raxes)
    popt = steps.make_optimizer(pspec).state_axes(paxes)
    want = {jax.tree_util.keystr(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(ropt, is_leaf=is_axes)[0]}
    assert {keystr(p): a for p, a in leaves_with_path(
        _nest_opt(popt), is_leaf=is_axes)} == want


# --- ROADMAP C10: rule overrides naming mesh axes no mesh has ----------------

C10 = [
    # (arch, kind, logical axis, what the arch's comment intends)
    ("mamba2-780m", "train", "act_batch", "flat 256-way DP"),
    ("codeqwen1.5-7b", "decode", "kv_heads", "kv heads over tp"),
    ("phi-3-vision-4.2b", "decode", "kv_heads", "kv heads over tp"),
    ("seamless-m4t-medium", "decode", "kv_heads", "kv heads over tp"),
    ("zamba2-1.2b", "decode", "kv_heads", "kv heads over tp"),
    ("arctic-480b", "decode", "embed", "weights fully sharded"),
    ("mamba2-780m", "decode", "act_batch", "decode batch over dp"),
]


@pytest.mark.parametrize("arch,kind,logical,intent", C10,
                         ids=[f"{c[0]}-{c[2]}" for c in C10])
def test_c10_unknown_mesh_axes_replicate_in_both(arch, kind, logical,
                                                 intent):
    rrules = ref_steps.build_rules(ref_mesh("pod"), REF_REGISTRY[arch], kind)
    prules = steps.build_rules(port_mesh("pod"), REGISTRY[arch], kind)
    assert rrules.mesh_axes_for(logical) == () == \
        prules.mesh_axes_for(logical)
    # the rule names an axis, and the mesh has none of that name
    assert REGISTRY[arch].rules_for(kind)[logical] in ("tp", "dp", "dp+tp")


def test_c10_mamba2_decode_batch_is_replicated():
    shape = "decode_32k"
    rc = ref_steps.build_cell(REF_REGISTRY["mamba2-780m"], REF_SHAPES[shape],
                              ref_mesh("pod"))
    pc = steps.build_cell(REGISTRY["mamba2-780m"], SHAPES[shape],
                          port_mesh("pod"))
    assert tuple(rc.in_shardings[1]["token"].spec) == () == \
        pc.in_shardings[1]["token"].spec


# --- rules, pspec_for, shard, meshes ------------------------------------------


@pytest.mark.parametrize("mesh_name", ("pod", "multipod", "host"))
def test_rules_equal_the_reference(mesh_name):
    if mesh_name == "host":
        rmesh, pmesh = AbstractMesh((1,), ("data",)), make_host_mesh("cpu")
    else:
        rmesh, pmesh = ref_mesh(mesh_name), port_mesh(mesh_name)
    assert dict(rmesh.shape) == pmesh.shape and rmesh.size == pmesh.size
    r = ref_sharding.ShardingRules(rmesh, {"mlp": ("data", "model")})
    p = sharding.ShardingRules(pmesh, {"mlp": ("data", "model")})
    assert p.rules == r.rules
    assert p.dp_axes == r.dp_axes
    for axes in (("pod", "data"), "model", None, ("x", "data")):
        assert p.axis_size(axes) == r.axis_size(axes)
    o = p.with_overrides(heads=None)
    assert o.rules["heads"] is None and p.rules["heads"] == "model"
    for shape, axes in (((32, 4096), ("act_batch", "mlp")),
                        ((30, 56), ("mlp", "heads")),
                        ((8, 16, 16), ("heads", "mlp", "embed")),
                        ((16,), ("layers",)), ((6, 8), (None, "vocab"))):
        rf, pf = [], []
        assert sharding.pspec_for(shape, axes, p, pf) == tuple(
            ref_sharding.pspec_for(shape, axes, r, rf))
        assert pf == rf


def test_shard_is_the_identity_on_one_device():
    x = torch.ones(4, 8)
    assert sharding.shard(x, "act_batch", None) is x
    with sharding.use_sharding(sharding.ShardingRules(make_host_mesh("cpu"))):
        assert sharding.current_rules() is not None
        assert sharding.shard(x, "act_batch", None) is x
    assert sharding.current_rules() is None
    # a production mesh: the constraint places the tensor on the mesh's
    # DeviceMesh (a plain tensor taken as replicated), a DTensor is
    # redistributed, and a dim the mesh does not divide stays whole
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_device_mesh

    pod = port_mesh("pod")
    rules = sharding.ShardingRules(pod)
    with fake_device_mesh(pod) as dm, sharding.use_sharding(rules, dm):
        y = sharding.shard(torch.ones(32, 8), "act_batch", None)
        assert y.placements == (Shard(0), Replicate())
        assert tuple(y.to_local().shape) == (2, 8)
        z = sharding.shard(y, "act_batch", "act_vocab")
        assert z.placements == (Shard(0), Replicate())     # 8 % 16
        w = sharding.shard(sharding.shard(torch.ones(32, 32), None, None),
                           "act_batch", "act_vocab")
        assert w.placements == (Shard(0), Shard(1))
        assert tuple(w.to_local().shape) == (2, 2)
        assert sharding.shard(w, "act_batch", "act_vocab") is w
        with pytest.raises(RuntimeError, match="device mesh"):
            with sharding.use_sharding(rules):
                sharding.shard(x, "act_batch", None)


def test_meshes():
    pod, multi = port_mesh("pod"), port_mesh("multipod")
    assert pod.shape == {"data": 16, "model": 16} and pod.devices is None
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512
    host = make_host_mesh("cpu")
    assert host.shape == {"data": 1}
    assert host.devices == (torch.device("cpu"),)


def test_host_mesh_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()


def test_device_mesh_is_the_one_device_of_the_run(monkeypatch):
    """The mesh a resume restores onto and the dry-run records for: one
    device, a CUDA one with its index explicit (the state's tensors
    report theirs), never every visible card."""
    assert make_device_mesh("cpu") == make_host_mesh("cpu")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    mesh = make_device_mesh("cuda")
    assert mesh.shape == {"data": 1}
    assert mesh.devices == (torch.device("cuda", 3),)
    assert make_device_mesh("cuda:1").devices == (torch.device("cuda", 1),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_device_mesh()
