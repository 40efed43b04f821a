"""Search agents over a `SearchSpace` — port of
``repro/explore/agents.py``: the ArchGym pattern with the analytical
model as the fitness function.  The agents draw from the same
``np.random.default_rng(seed)`` in the same order as the reference's,
so under one score function they propose the same configs.

Agents are batch-oriented: each round proposes a LIST of candidate
configs and scores them through one fused-sweep call, so the device
amortizes an entire generation/neighborhood at once.  All agents run
against a `ScoreCache`, which dedups re-proposed configs (an evaluation
budget counts *unique* configs), enforces the budget, and logs every
round into the `Trajectory` that `repro.explore` persists.

* `RandomAgent`    — uniform search without replacement; the unbiased
  baseline and the exhaustive oracle when the budget covers the space.
* `HillClimbAgent` — score all single-axis neighbor moves of the
  incumbent in one batch, take the best strict improvement,
  random-restart at local optima.
* `GAAgent`        — generational GA (elitism + tournament selection +
  uniform crossover + per-axis mutation) over the axis index vectors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from .space import CandidateConfig, SearchSpace


@dataclasses.dataclass
class Trajectory:
    """Round-by-round search log (persisted via the ArtifactStore)."""

    agent: str
    seed: int
    rounds: list[dict] = dataclasses.field(default_factory=list)
    evaluations: int = 0
    best_score: float = math.inf
    best_config: CandidateConfig | None = None

    def to_json(self) -> dict:
        return {
            "agent": self.agent,
            "seed": self.seed,
            "evaluations": self.evaluations,
            "best_score": self.best_score,
            "best_config": (self.best_config.to_json()
                            if self.best_config else None),
            "rounds": self.rounds,
        }


class ScoreCache:
    """Budgeted, deduping front end to the fused evaluator."""

    def __init__(self, evaluate: Callable[[list[CandidateConfig]], np.ndarray],
                 budget: int, trajectory: Trajectory):
        self._evaluate = evaluate
        self.budget = int(budget)
        self.trajectory = trajectory
        self._scores: dict[tuple, float] = {}

    @property
    def remaining(self) -> int:
        return max(self.budget - self.trajectory.evaluations, 0)

    @property
    def exhausted(self) -> bool:
        return self.remaining == 0

    def known(self, cfg: CandidateConfig) -> bool:
        return cfg.key() in self._scores

    def score_of(self, cfg: CandidateConfig) -> float:
        return self._scores[cfg.key()]

    def top(self, k: int) -> list[tuple[tuple, float]]:
        return sorted(self._scores.items(), key=lambda kv: kv[1])[:k]

    def score(self, configs: list[CandidateConfig],
              tag: str) -> dict[tuple, float]:
        """Score a proposal batch; unseen configs beyond the remaining
        budget are silently dropped (the round records how many ran).
        Returns scores for every *scored* config in the proposal."""
        fresh: list[CandidateConfig] = []
        seen_keys: set[tuple] = set()
        for cfg in configs:
            k = cfg.key()
            if k in self._scores or k in seen_keys:
                continue
            seen_keys.add(k)
            fresh.append(cfg)
        fresh = fresh[: self.remaining]
        if fresh:
            scores = np.asarray(self._evaluate(fresh), dtype=np.float64)
            traj = self.trajectory
            for cfg, s in zip(fresh, scores):
                self._scores[cfg.key()] = float(s)
                traj.evaluations += 1
                if float(s) < traj.best_score:
                    traj.best_score = float(s)
                    traj.best_config = cfg
        self.trajectory.rounds.append({
            "tag": tag,
            "proposed": len(configs),
            "evaluated": len(fresh),
            "best_score": (None if math.isinf(self.trajectory.best_score)
                           else self.trajectory.best_score),
        })
        return {
            cfg.key(): self._scores[cfg.key()]
            for cfg in configs if cfg.key() in self._scores
        }


class Agent:
    """Base: subclasses drive `cache.score` until the budget is spent."""

    name = "agent"

    def params(self) -> dict:
        return {}

    def search(self, space: SearchSpace, cache: ScoreCache,
               rng: np.random.Generator) -> None:
        raise NotImplementedError


class RandomAgent(Agent):
    name = "random"

    def __init__(self, batch_size: int = 64):
        self.batch_size = int(batch_size)

    def params(self) -> dict:
        return {"batch_size": self.batch_size}

    def search(self, space, cache, rng) -> None:
        pool = space.configs()
        order = rng.permutation(len(pool))
        for lo in range(0, len(order), self.batch_size):
            if cache.exhausted:
                return
            batch = [pool[i] for i in order[lo:lo + self.batch_size]]
            cache.score(batch, tag=f"random[{lo // self.batch_size}]")


def _random_indices(space: SearchSpace,
                    rng: np.random.Generator) -> tuple[int, ...]:
    """One VALID index vector, rejection-sampled (spaces guarantee at
    least one valid config, and ways<=sets rejects at most a corner)."""
    sizes = space.axis_sizes()
    while True:
        idx = tuple(int(rng.integers(n)) for n in sizes)
        if space.config_from_indices(idx) is not None:
            return idx


def _neighbors(space: SearchSpace, idx: tuple[int, ...]) -> list[tuple]:
    out = []
    sizes = space.axis_sizes()
    for ax, n in enumerate(sizes):
        for step in (-1, 1):
            j = idx[ax] + step
            if 0 <= j < n:
                out.append(idx[:ax] + (j,) + idx[ax + 1:])
    return out


class HillClimbAgent(Agent):
    name = "hillclimb"

    def __init__(self, max_rounds: int = 1000):
        self.max_rounds = int(max_rounds)

    def params(self) -> dict:
        return {"max_rounds": self.max_rounds}

    def search(self, space, cache, rng) -> None:
        current = _random_indices(space, rng)
        restarts = 0
        for rnd in range(self.max_rounds):
            if cache.exhausted:
                return
            cur_cfg = space.config_from_indices(current)
            moves = [
                (idx, space.config_from_indices(idx))
                for idx in _neighbors(space, current)
            ]
            moves = [(idx, cfg) for idx, cfg in moves if cfg is not None]
            cache.score(
                [cur_cfg] + [cfg for _idx, cfg in moves],
                tag=f"climb[{rnd}]r{restarts}",
            )
            scored = [
                (cache.score_of(cfg), idx)
                for idx, cfg in moves if cache.known(cfg)
            ]
            here = (cache.score_of(cur_cfg)
                    if cache.known(cur_cfg) else math.inf)
            better = [(s, idx) for s, idx in scored if s < here]
            if better:
                current = min(better)[1]
            else:
                current = _random_indices(space, rng)
                restarts += 1


class GAAgent(Agent):
    name = "ga"

    def __init__(self, population: int = 24, elite: int = 4,
                 mutation: float = 0.2, tournament: int = 3,
                 max_generations: int = 1000):
        self.population = int(population)
        self.elite = int(elite)
        self.mutation = float(mutation)
        self.tournament = int(tournament)
        self.max_generations = int(max_generations)

    def params(self) -> dict:
        return {
            "population": self.population, "elite": self.elite,
            "mutation": self.mutation, "tournament": self.tournament,
            "max_generations": self.max_generations,
        }

    def _select(self, pop, fitness, rng) -> tuple[int, ...]:
        picks = rng.integers(len(pop), size=self.tournament)
        return pop[min(picks, key=lambda i: fitness[i])]

    def search(self, space, cache, rng) -> None:
        sizes = space.axis_sizes()
        pop = [_random_indices(space, rng) for _ in range(self.population)]
        for gen in range(self.max_generations):
            if cache.exhausted:
                return
            cfgs = [space.config_from_indices(i) for i in pop]
            cache.score([c for c in cfgs if c is not None],
                        tag=f"ga[{gen}]")
            fitness = [
                cache.score_of(c) if c is not None and cache.known(c)
                else math.inf
                for c in cfgs
            ]
            ranked = sorted(range(len(pop)), key=lambda i: fitness[i])
            nxt = [pop[i] for i in ranked[: self.elite]]
            while len(nxt) < self.population:
                pa = self._select(pop, fitness, rng)
                pb = self._select(pop, fitness, rng)
                child = tuple(
                    (pa if rng.random() < 0.5 else pb)[ax]
                    for ax in range(len(sizes))
                )
                child = tuple(
                    int(rng.integers(n)) if rng.random() < self.mutation
                    else child[ax]
                    for ax, n in enumerate(sizes)
                )
                if space.config_from_indices(child) is None:
                    child = _random_indices(space, rng)
                nxt.append(child)
            pop = nxt


AGENTS: dict[str, type[Agent]] = {
    RandomAgent.name: RandomAgent,
    HillClimbAgent.name: HillClimbAgent,
    GAAgent.name: GAAgent,
}


def make_agent(name: str, params: dict | None = None) -> Agent:
    if name not in AGENTS:
        raise ValueError(f"unknown agent {name!r} (known: {sorted(AGENTS)})")
    return AGENTS[name](**(params or {}))


__all__ = [
    "AGENTS",
    "Agent",
    "GAAgent",
    "HillClimbAgent",
    "RandomAgent",
    "ScoreCache",
    "Trajectory",
    "make_agent",
]
