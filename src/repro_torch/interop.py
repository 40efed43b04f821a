"""Build the port's objects from plain arrays and dicts.

The JAX package's artifacts — traces, reuse profiles, hardware tables,
model weights — are carried across as numpy arrays and plain dicts
(this module imports nothing of that package): a test hands the
reference's own profiles to the port's SDCM stage, or its weights to
the port's models, so the two are compared on identical inputs,
independent of the upstream stages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.incore import ClassTiming, InCoreTimings
from repro_torch.core.levels import CacheLevelConfig
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.hw.targets import CPUTarget, InstrTimings, TPUTarget


def trace_from_arrays(addresses, bb_ids, shared_mask, inst_ids=None,
                      bb_names=None) -> LabeledTrace:
    """A :class:`LabeledTrace` from its arrays (``inst_ids`` None =
    maximal runs of equal bb ids, as in the reference)."""
    return LabeledTrace(
        np.asarray(addresses), np.asarray(bb_ids), np.asarray(shared_mask),
        None if inst_ids is None else np.asarray(inst_ids),
        {int(k): str(v) for k, v in (bb_names or {}).items()},
    )


def profile_from_arrays(distances, counts, total=None) -> ReuseProfile:
    """A :class:`ReuseProfile` from its distinct distances and counts."""
    d = np.asarray(distances, dtype=np.int64)
    c = np.asarray(counts, dtype=np.int64)
    if d.shape != c.shape or d.ndim != 1:
        raise ValueError("distances and counts must be equal-length 1-D")
    if len(d) > 1 and not (np.diff(d) > 0).all():
        raise ValueError("distances must be sorted and distinct")
    total = int(c.sum()) if total is None else int(total)
    if total != int(c.sum()):
        raise ValueError(f"total {total} != counts.sum() {int(c.sum())}")
    return ReuseProfile(d, c, total)


def _level(spec: dict) -> CacheLevelConfig:
    """One cache level from ``{name, line_size, assoc}`` plus either
    ``size_bytes``, ``num_lines`` or ``sets``."""
    line, assoc = int(spec["line_size"]), int(spec["assoc"])
    if "size_bytes" in spec:
        size = int(spec["size_bytes"])
    elif "num_lines" in spec:
        size = int(spec["num_lines"]) * line
    elif "sets" in spec:
        size = int(spec["sets"]) * assoc * line
    else:
        raise ValueError(f"level {spec.get('name')!r} needs size_bytes, "
                         "num_lines or sets")
    return CacheLevelConfig(str(spec["name"]), size, line, assoc)


def target_from_fields(name: str, levels: list[dict], **fields):
    """A hardware target from plain fields.

    ``levels`` are dicts as :func:`_level` reads them; a CPU/GPU target
    (``freq_hz`` among ``fields``) also takes each level's
    ``latency_cy``/``beta_cy`` from its dict unless ``level_latency_cy``
    /``level_beta_cy`` are given, ``instr`` as a dict and ``incore`` as
    ``{class: {delta, beta, ports}}``.  Without ``freq_hz`` the fields
    are a TPU target's, whose one VMEM level must match ``levels``.
    """
    lvls = tuple(_level(s) for s in levels)
    if "freq_hz" not in fields:
        tpu = TPUTarget(name=name, **fields)
        if tpu.levels != lvls:
            raise ValueError(
                f"TPU target {name!r}: levels {lvls} disagree with the "
                f"VMEM fields {tpu.levels}"
            )
        return tpu
    f = dict(fields)
    if "level_latency_cy" not in f:
        f["level_latency_cy"] = tuple(float(s["latency_cy"]) for s in levels)
    if "level_beta_cy" not in f:
        f["level_beta_cy"] = tuple(float(s["beta_cy"]) for s in levels)
    f["level_latency_cy"] = tuple(f["level_latency_cy"])
    f["level_beta_cy"] = tuple(f["level_beta_cy"])
    instr = f.pop("instr")
    f["instr"] = instr if isinstance(instr, InstrTimings) else InstrTimings(**instr)
    incore = f.pop("incore", None)
    if isinstance(incore, dict):
        incore = InCoreTimings(**{
            cls: ClassTiming(**t) for cls, t in incore.items()
        })
    f["incore"] = incore
    return CPUTarget(name=name, levels=lvls, **f)


def _tensor(arr) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 upcast to f32, which is exact)
    as a CPU tensor."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr))


def copy_params(module: torch.nn.Module, values: dict, lead=()) -> None:
    """Copy the nested dict ``values`` into ``module``'s parameters of
    the same names, taking index ``lead`` of each array's leading
    (stacked-layer) axes."""
    for name, val in values.items():
        sub = getattr(module, name)
        if isinstance(val, dict):
            copy_params(sub, val, lead)
            continue
        arr = _tensor(np.asarray(val)[lead])
        if tuple(arr.shape) != tuple(sub.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} "
                             f"vs port {tuple(sub.shape)}")
        with torch.no_grad():
            sub.copy_(arr)


def _at(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def _leaf_paths(tree: dict, prefix=()) -> set:
    out = set()
    for key, val in tree.items():
        if isinstance(val, dict):
            out |= _leaf_paths(val, prefix + (key,))
        else:
            out.add(prefix + (key,))
    return out


def model_from_reference(family_name: str, cfg, values: dict, *,
                         device) -> torch.nn.Module:
    """The port's model of any family holding the reference's parameter
    values: ``unzip_params(fam.init(key, cfg))[0]`` mapped to numpy (a
    nested dict of arrays).  A port parameter's name is its reference
    path with the layer indices of its stack (``blocks.3.attn.wq`` is
    ``values["blocks"]["attn"]["wq"][3]``, ``groups.1.4.wx`` is
    ``values["groups"]["wx"][1, 4]``;
    :func:`repro_torch.train.optimizer.leaf_path`).  Every reference leaf
    must be used: a tied embedding is one parameter, which the logits
    head reads, as in the reference."""
    from repro_torch.models.api import get_family
    from repro_torch.train.optimizer import leaf_path

    model = get_family(family_name).init(cfg, device=device)
    used = set()
    for name, param in model.named_parameters():
        path, index = leaf_path(name)
        used.add(path)
        arr = _tensor(np.asarray(_at(values, path))[index])
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} "
                             f"vs port {tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(arr)
    if used != _leaf_paths(values):
        raise ValueError(f"reference leaves {_leaf_paths(values) - used} "
                         f"have no port parameter")
    return model


def train_state_from_reference(family_name: str, cfg, state, *,
                               device):
    """The port's :class:`~repro_torch.train.train_step.TrainState` from
    the reference's ``TrainState(step, params, opt_state)`` mapped to
    numpy: the model of :func:`model_from_reference`, its parameters set
    to require grad, the step, and the optimizer state by leaf (AdamW's
    ``{"m": tree, "v": tree}``, Adafactor's tree of ``{"vr", "vc"}`` or
    ``{"v"}``, each leaf's arrays as the reference stacks them)."""
    from repro_torch.train.optimizer import param_leaves
    from repro_torch.train.train_step import TrainState

    model = model_from_reference(family_name, cfg, state.params,
                                 device=device)
    model.requires_grad_(True)
    opt = state.opt_state
    moments = set(opt) == {"m", "v"}     # AdamW's; Adafactor's mirrors params
    out = {}
    for leaf in param_leaves(model):
        path = tuple(leaf.split("."))
        own = ({k: _at(opt[k], path) for k in ("m", "v")} if moments
               else _at(opt, path))
        out[leaf] = {k: _tensor(v).to(device=device, dtype=torch.float32)
                     for k, v in own.items()}
    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                        device=device)
    return TrainState(step, model, out)
