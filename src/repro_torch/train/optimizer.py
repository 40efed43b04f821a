"""Optimizers as functions over leaves (no external deps).  Port of
``repro/train/optimizer.py``, the reference's arithmetic (not
``torch.optim``'s, whose bias correction and decay order differ).

* AdamW — f32 moments, decoupled weight decay.
* Adafactor — factored second moment for leaves of rank >= 2; the
  memory-fit choice for arctic-480b.

A leaf is one of the reference's parameter arrays: the port's modules
hold one ``Parameter`` per layer where the reference stacks the layers,
so :func:`param_leaves` groups the parameters of a model into the
reference's leaves (a name's layer indices dropped), and the train step
hands the optimizer each leaf stacked as the reference holds it.  That
matters to Adafactor, whose factoring and update clipping see the whole
stacked leaf.  ``update`` is pure: ``update(grads, state, params, step)
-> (new_params, new_state)`` over dicts ``{leaf: tensor}`` (any subset
of the leaves, so the step can update one leaf at a time); each update
runs in f32 and casts back to the parameter's dtype.  The state is
``{leaf: {name: f32 tensor}}``: AdamW's ``m`` and ``v``, Adafactor's
``vr`` and ``vc`` (rank >= 2) or ``v``.  ``state_axes(param_axes)``
maps the parameters' ``{leaf: logical axes}`` to the state's ``{leaf:
{name: axes}}``: the reference's axes for each moment (the sharding
rules and the checkpoint's manifest read them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import nn

Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict, torch.Tensor], tuple[dict, dict]]
    # update(grads, opt_state, params, step) -> (new_params, new_state)
    state_axes: Callable[[dict], dict] = None
    # state_axes({leaf: axes}) -> {leaf: {name: axes}} matching init()


class Leaf(NamedTuple):
    """The parameters that the reference stacks into one array, in its
    order, and the stacked (layer) dimensions ahead of their shape."""

    names: tuple[str, ...]
    lead: tuple[int, ...]


def leaf_path(name: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """``"groups.1.4.wx"`` -> ``(("groups", "wx"), (1, 4))``: the
    reference's path of a parameter's leaf and its index there."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def param_leaves(model: nn.Module) -> dict[str, Leaf]:
    """``{leaf: Leaf}`` of ``model``'s parameters (a tied parameter
    once), leaves by their dotted path."""
    found: dict[str, list] = {}
    for name, _ in model.named_parameters():
        path, index = leaf_path(name)
        found.setdefault(".".join(path), []).append((index, name))
    out = {}
    for leaf, items in found.items():
        items.sort()
        lead = tuple(max(i[d] for i, _ in items) + 1
                     for d in range(len(items[0][0])))
        out[leaf] = Leaf(tuple(n for _, n in items), lead)
    return out


def stack_leaf(tensors: list, lead: tuple) -> torch.Tensor:
    """One leaf as the reference holds it: the layers' tensors stacked
    into its lead dimensions (a lone tensor as it is)."""
    if not lead:
        return tensors[0]
    return torch.stack(tensors).reshape(lead + tensors[0].shape)


def leaf_tensors(model: nn.Module, tensors=None) -> dict[str, torch.Tensor]:
    """``{leaf: stacked tensor}`` of ``model``'s parameters, or of
    ``tensors`` given in ``model.parameters()``'s order (gradients)."""
    names = [n for n, _ in model.named_parameters()]
    by_name = dict(zip(names, model.parameters() if tensors is None
                       else tensors))
    return {leaf: stack_leaf([by_name[n] for n in info.names], info.lead)
            for leaf, info in param_leaves(model).items()}


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return {k: {"m": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device),
                    "v": torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device)}
                for k, p in params.items()}

    def update(grads, state, params, step):
        t = step.float() + 1.0
        lr_t = sched(step)
        c1 = 1.0 - b1 ** t
        c2 = 1.0 - b2 ** t
        new_params, new_state = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state[k]["m"] + (1 - b1) * g
            v = b2 * state[k]["v"] + (1 - b2) * g * g
            upd = (m / c1) / (torch.sqrt(v / c2) + eps)
            upd = upd + weight_decay * p.float()
            new_params[k] = (p.float() - lr_t * upd).to(p.dtype)
            new_state[k] = {"m": m, "v": v}
        return new_params, new_state

    def state_axes(param_axes):
        return {k: {"m": ax, "v": ax} for k, ax in param_axes.items()}

    return Optimizer("adamw", init, update, state_axes)


def adafactor(lr, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018), no first moment, factored second
    moment for rank >= 2 leaves: O(n + m) state instead of O(n m)."""
    sched = _as_schedule(lr)

    def init(params):
        def leaf(p):
            zeros = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **zeros),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **zeros)}
            return {"v": torch.zeros(p.shape, **zeros)}

        return {k: leaf(p) for k, p in params.items()}

    def update(grads, state, params, step):
        t = step.float() + 1.0
        beta = 1.0 - t ** (-decay)
        lr_t = sched(step)
        new_params, new_state = {}, {}
        for k, p in params.items():
            g = grads[k].float()
            s = state[k]
            g2 = g * g + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
                vc = beta * s["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / (torch.mean(vr, dim=-1, keepdim=True)[..., None] + eps))
                upd = g / (denom + eps)
                new_state[k] = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = g / (torch.sqrt(v) + eps)
                new_state[k] = {"v": v}
            rms = torch.sqrt(torch.mean(upd * upd) + eps)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            new_params[k] = (p.float() - lr_t * upd).to(p.dtype)
        return new_params, new_state

    def state_axes(param_axes):
        def leaf(ax):
            if len(ax) >= 2:
                return {"vr": ax[:-1], "vc": ax[:-2] + ax[-1:]}
            return {"v": ax}

        return {k: leaf(ax) for k, ax in param_axes.items()}

    return Optimizer("adafactor", init, update, state_axes)
