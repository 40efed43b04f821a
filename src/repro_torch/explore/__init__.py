"""`repro_torch.explore` — design-space autotuning over the fused
SDCM+ECM sweep (`repro_torch.api.batched.sweep_grid`), port of
``repro.explore``.

    from repro_torch.explore import SearchSpace, run_explore
    result = run_explore(workload, SearchSpace(sets=(1024, 4096)),
                         agent="hillclimb", budget=256)

Runs on the card unless ``device="cpu"`` (or a CPU ``session``) is
given.  CLI: ``python -m repro_torch.explore --workload polybench/atx
...``.
"""
from .agents import AGENTS, GAAgent, HillClimbAgent, RandomAgent, make_agent
from .engine import OBJECTIVES, FusedSweepEvaluator, SweepStats
from .runner import explore_key, run_explore
from .space import INTERLEAVE_STRATEGIES, CandidateConfig, SearchSpace

__all__ = [
    "AGENTS",
    "CandidateConfig",
    "FusedSweepEvaluator",
    "GAAgent",
    "HillClimbAgent",
    "INTERLEAVE_STRATEGIES",
    "OBJECTIVES",
    "RandomAgent",
    "SearchSpace",
    "SweepStats",
    "explore_key",
    "make_agent",
    "run_explore",
]
