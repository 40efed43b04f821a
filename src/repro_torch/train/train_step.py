"""The train step: loss -> grads (with microbatch accumulation) ->
global-norm clip -> optimizer update.  Port of
``repro/train/train_step.py`` on one device, eagerly: the reference's
``lax.scan`` over microbatches is a Python loop, its pure parameter tree
the model's ``Parameter``s, updated in place leaf by leaf.

``TrainState.params`` is the model (an ``nn.Module`` whose parameters
require grad); ``opt_state`` the optimizer's state by leaf
(:mod:`repro_torch.train.optimizer`); ``step`` an int32 scalar tensor on
the model's device.  ``step_fn(state, batch)`` returns the next state
(the same model, its parameters updated) and the metrics ``loss``,
``grad_norm`` (before clipping) and ``param_norm`` (after the update),
f32 scalar tensors.  The step's parts are spans named in :data:`RANGES`
(:mod:`repro_torch.runtime.tracing`), so a profile of a step splits its
device time into the forward, the backward and the optimizer.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import nn

from repro_torch.dist.sharding import is_dtensor, like, microbatches
from repro_torch.runtime.tracing import span
from repro_torch.train.optimizer import (
    Optimizer, leaf_tensors, param_leaves, stack_leaf,
)


#: ``torch.profiler`` ranges of a step: the loss (forward), its gradient
#: (backward, remat recomputation included) and clipping plus the update.
RANGES = ("train_step.forward", "train_step.backward",
          "train_step.optimizer")


class TrainState(NamedTuple):
    step: torch.Tensor
    params: nn.Module
    opt_state: dict


def init_state(model: nn.Module, optimizer: Optimizer) -> TrainState:
    """Parameters set to require grad; the optimizer's state for each
    leaf; step 0."""
    model.requires_grad_(True)
    with torch.no_grad():
        opt_state = optimizer.init(leaf_tensors(model))
    device = next(model.parameters()).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=device),
                      model, opt_state)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """Microbatch ``i`` takes rows ``[i B/n, (i+1) B/n)`` of every entry;
    a DTensor's microbatches are placed as it is (:func:`microbatches`)."""
    split = {k: microbatches(x, n) for k, x in batch.items()}
    return [{k: split[k][i] for k in batch} for i in range(n)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


def build_train_step(
    loss_fn: Callable[[nn.Module, dict], torch.Tensor],
    optimizer: Optimizer,
    *,
    grad_accum: int = 1,
    grad_clip: float = 1.0,
    accum_dtype: torch.dtype = torch.float32,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """``loss_fn(model, batch) -> scalar``.  Returns ``step_fn(state,
    batch) -> (state, metrics)``.  ``accum_dtype=torch.bfloat16`` halves
    the accumulators (arctic-480b's memory-fit knob)."""

    def value_and_grad(model: nn.Module, params: list, batch: dict):
        with span(RANGES[0]):
            loss = loss_fn(model, batch)
        with span(RANGES[1]):
            return loss, torch.autograd.grad(loss, params)

    def compute_grads(model: nn.Module, batch: dict):
        params = list(model.parameters())
        if grad_accum == 1:
            loss, grads = value_and_grad(model, params, batch)
            return loss.detach().float(), grads
        acc = [torch.zeros_like(p, dtype=accum_dtype) if is_dtensor(p) else
               torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for p in params]    # a DTensor's accumulator placed as it
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=params[0].device)
        for mb in _split_microbatches(batch, grad_accum):
            loss, grads = value_and_grad(model, params, mb)
            for a, g in zip(acc, grads):
                a.add_((g / grad_accum).to(accum_dtype))
            loss_sum = loss_sum + loss.detach().float() / grad_accum
        return loss_sum, acc

    # the model's leaves, worked out on its first step
    memo: dict = {}

    def leaves_of(model: nn.Module) -> dict:
        if memo.get("model") is not model:
            memo.update(model=model, leaves=param_leaves(model))
        return memo["leaves"]

    def step_fn(state: TrainState, batch: dict):
        model = state.params
        names = [n for n, _ in model.named_parameters()]
        loss, grads = compute_grads(model, batch)
        with torch.no_grad(), span(RANGES[2]):
            grads = [like(g, p) for g, p in zip(grads, model.parameters())]
            gnorm = global_norm(grads)
            grads = dict(zip(names, grads))
            scale = None
            if grad_clip:
                scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
            params = dict(model.named_parameters())
            new_opt = {}
            for k, leaf in leaves_of(model).items():
                g = stack_leaf([grads.pop(n) for n in leaf.names], leaf.lead)
                if scale is not None:
                    g = g.float() * scale
                p = stack_leaf([params[n] for n in leaf.names], leaf.lead)
                new_p, new_s = optimizer.update(
                    {k: g}, {k: state.opt_state[k]}, {k: p}, state.step)
                new_opt[k] = {n: like(v, state.opt_state[k][n])
                              for n, v in new_s[k].items()}
                flat = like(new_p[k], p).reshape(
                    (-1,) + params[leaf.names[0]].shape)
                for n, v in zip(leaf.names, flat):
                    params[n].copy_(v)
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "param_norm": global_norm(model.parameters())}
        return TrainState(state.step + 1, model, new_opt), metrics

    return step_fn
