"""Top-level explore driver: search + trajectory persistence — port of
``repro/explore/runner.py``.

`run_explore` keys each (workload fingerprint, space, agent, budget,
seed, objective) search by a stable hash and persists the full result —
best config, top-k table, round-by-round trajectory, sweep stats —
under the ArtifactStore's ``explore`` kind.  A warm re-run with the
same key returns the stored result with ZERO recomputation: no profile
builds, no kernel dispatches, no agent rounds.

The result's schema and the store kind are the reference's, and
:func:`explore_key` without a stamp is the reference's key.  The port's
own searches are stamped (:data:`KEY_STAMP`): its runtime chain runs in
float64 where the reference's runs in float32, so configs whose scores
lie within float32 rounding of each other (common: an inert axis, a
compute-bound workload) tie in the reference and are ordered in the
port, and the two packages' agents can walk different trajectories to
equally good configs.  Neither package is served the other's search
(ROADMAP queue C, C5).
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from repro_torch.api.session import Session

from .agents import ScoreCache, Trajectory, make_agent
from .engine import FusedSweepEvaluator
from .space import CandidateConfig, SearchSpace

TOP_K = 10

#: Joins the port's explore keys, so a store never serves a search of one
#: package to the other (ROADMAP queue C, C5).
KEY_STAMP = "repro_torch/float64"


def explore_key(fingerprint: str, space: SearchSpace, agent: str,
                agent_params: dict, budget: int, seed: int,
                objective: str, mode: str, inner: str,
                stamp: str | None = None) -> str:
    """Stable store key over everything that determines the result; the
    reference's key when ``stamp`` is None."""
    fields = {
        "fingerprint": fingerprint,
        "space": space.to_json(),
        "agent": agent,
        "agent_params": agent_params,
        "budget": budget,
        "seed": seed,
        "objective": objective,
        "mode": mode,
        "inner": inner,
    }
    if stamp is not None:
        fields["stamp"] = stamp
    blob = json.dumps(fields, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:20]


def run_explore(source, space: SearchSpace, *, agent: str = "hillclimb",
                agent_params: dict | None = None, budget: int = 128,
                seed: int = 0, session=None, device=None, counts=None,
                mode: str = "throughput", objective: str | None = None,
                inner: str = "vmap", workload: str | None = None,
                refresh: bool = False) -> dict:
    """Search ``space`` for the best config of ``source``.

    Returns a JSON-serializable result dict; ``result["cached"]`` says
    whether it came straight from the ArtifactStore.  Without a
    ``session`` it runs on ``Session(cache_model="batched",
    device=device)``: the card unless ``device="cpu"`` is asked for.
    """
    if session is None:
        session = Session(cache_model="batched", device=device)
    agent_obj = make_agent(agent, agent_params)
    fingerprint = session.identify(source)
    evaluator = FusedSweepEvaluator(
        source, space, session=session, counts=counts, mode=mode,
        objective=objective, inner=inner, seed=seed,
    )
    key = explore_key(
        fingerprint, space, agent_obj.name, agent_obj.params(),
        budget, seed, evaluator.objective, mode, inner, stamp=KEY_STAMP,
    )
    store = session.store
    if store is not None and not refresh:
        cached = store.get_json("explore", key)
        if cached is not None:
            return {**cached, "cached": True}

    trajectory = Trajectory(agent=agent_obj.name, seed=seed)
    cache = ScoreCache(evaluator.scores, budget, trajectory)
    agent_obj.search(space, cache, np.random.default_rng(seed))

    best = trajectory.best_config
    if best is None:
        raise RuntimeError("explore finished without scoring any config")
    detail = evaluator.evaluate([best])
    level_names = [lvl.name for lvl in evaluator.base.levels]
    result = {
        "key": key,
        "workload": workload or getattr(source, "name", type(source).__name__),
        "fingerprint": fingerprint,
        "space": space.to_json(),
        "space_size": space.size,
        "agent": agent_obj.name,
        "agent_params": agent_obj.params(),
        "budget": budget,
        "seed": seed,
        "objective": evaluator.objective,
        "mode": mode,
        "inner": inner,
        "best": {
            "config": best.to_json(),
            "score": trajectory.best_score,
            "hit_rates": dict(zip(level_names, detail.rates[0].tolist())),
            "t_pred_s": (float(detail.t_pred_s[0])
                         if detail.t_pred_s is not None else None),
        },
        "top": [
            {"config": CandidateConfig(*k).to_json(), "score": s}
            for k, s in cache.top(TOP_K)
        ],
        "trajectory": trajectory.to_json(),
        "stats": evaluator.stats.to_json(),
    }
    if store is not None:
        store.put_json("explore", key, result)
    return {**result, "cached": False}


__all__ = ["KEY_STAMP", "TOP_K", "explore_key", "run_explore"]
