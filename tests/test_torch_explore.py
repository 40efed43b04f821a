"""The port's autotuner (``repro_torch.explore``) against the JAX
package's ``repro.explore``: the search space enumerates the same
configs with the same payload; under one seeded score function every
agent proposes exactly what the reference's proposes; end to end, on
``SMOKE_SPACE``, the best config is one the reference scores as its own
best, at its score; results have the reference's schema; a warm re-run
is served from the store; the CLI's ``--smoke`` passes on the CPU.

The port's searches carry a key stamp (ROADMAP queue C, C5): on
``SMOKE_SPACE`` the reference's float32 runtime chain ties configs that
the port's float64 chain orders (they lie 1e-14 apart), so the two
packages' agents walk different trajectories to equally good configs.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.api import Session as RefSession
from repro.explore import SearchSpace as RefSpace
from repro.explore import explore_key as ref_explore_key
from repro.explore import make_agent as ref_make_agent
from repro.explore import run_explore as ref_run_explore
from repro.explore.__main__ import SMOKE_SPACE as REF_SMOKE_SPACE
from repro.explore.agents import ScoreCache as RefScoreCache
from repro.explore.agents import Trajectory as RefTrajectory
from repro.validate.store import ArtifactStore as RefStore
from repro.workloads import registry as ref_registry

from repro_torch.api import Session
from repro_torch.explore import (
    AGENTS,
    SearchSpace,
    explore_key,
    make_agent,
    run_explore,
)
from repro_torch.explore import report
from repro_torch.explore.__main__ import SMOKE_SPACE, main
from repro_torch.explore.agents import ScoreCache, Trajectory
from repro_torch.explore.runner import KEY_STAMP
from repro_torch.workloads import registry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SPACE = dict(sets=(256, 1024, 4096, 16384), ways=(2, 4, 8),
             latency_cy=(20.0, 36.0, 60.0), cores=(1, 2))
REF_T_RTOL = 1e-5      # the reference's float32 runtime chain


def landscape(configs):
    """A deterministic fitness with one global optimum and exact ties
    (the latency axis below 36 cycles is inert)."""
    return np.asarray([
        abs(np.log2(c.sets * c.ways) - np.log2(4096 * 8))
        + 0.01 * max(c.latency_cy, 36.0)
        + (0.5 if c.cores == 1 else 0.0)
        for c in configs
    ])


def search(make, space, trajectory_cls, cache_cls, name, seed, budget):
    """Run one agent; returns its trajectory and every proposal batch."""
    proposals = []

    def scored(configs):
        proposals.append([c.key() for c in configs])
        return landscape(configs)

    traj = trajectory_cls(agent=name, seed=seed)
    cache = cache_cls(scored, budget=budget, trajectory=traj)
    make(name).search(space, cache, np.random.default_rng(seed))
    return traj.to_json(), proposals


# --- space ---------------------------------------------------------------------


def test_space_enumerates_the_references_configs():
    for kw in (SPACE, SMOKE_SPACE, {}, dict(
            sets=(2, 64, 4096), ways=(4, 8), line_sizes=(64, 128),
            cores=(1, 4), strategies=("round_robin", "uniform"),
            min_size_bytes=1 << 14, max_size_bytes=1 << 22)):
        port, ref = SearchSpace(**kw), RefSpace(**kw)
        assert [c.key() for c in port.configs()] == \
            [c.key() for c in ref.configs()]
        assert port.to_json() == ref.to_json()
        assert [c.to_json() for c in port.configs()] == \
            [c.to_json() for c in ref.configs()]
        assert SearchSpace.from_json(port.to_json()) == port
    assert SMOKE_SPACE == REF_SMOKE_SPACE
    with pytest.raises(ValueError, match="unknown search-space keys"):
        SearchSpace.from_json({"bogus": 1})
    with pytest.raises(ValueError, match="unknown interleave"):
        SearchSpace(strategies=("zigzag",))


def test_applied_config_is_the_references():
    from repro.hw.targets import resolve_target as ref_target

    from repro_torch.hw.targets import resolve_target

    port, ref = SearchSpace(**SPACE), RefSpace(**SPACE)
    base, ref_base = resolve_target(port.target), ref_target(ref.target)
    li = port.level_index(base)
    for pc, rc in zip(port.configs()[::7], ref.configs()[::7]):
        a, b = pc.apply(base, li), rc.apply(ref_base, li)
        assert a.name == b.name
        assert [(l.size_bytes, l.line_size, l.assoc) for l in a.levels] == \
            [(l.size_bytes, l.line_size, l.assoc) for l in b.levels]
        assert (a.level_latency_cy, a.level_beta_cy) == \
            (b.level_latency_cy, b.level_beta_cy)


# --- agents --------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 7])
@pytest.mark.parametrize("name", sorted(AGENTS))
def test_agents_propose_what_the_reference_proposes(name, seed):
    port = search(make_agent, SearchSpace(**SPACE), Trajectory, ScoreCache,
                  name, seed, budget=40)
    ref = search(ref_make_agent, RefSpace(**SPACE), RefTrajectory,
                 RefScoreCache, name, seed, budget=40)
    assert port == ref


@pytest.mark.parametrize("name", sorted(AGENTS))
def test_agents_recover_the_known_best(name):
    space = SearchSpace(**SPACE)
    traj, _ = search(make_agent, space, Trajectory, ScoreCache, name, 3,
                     budget=space.size)
    assert traj["best_score"] == pytest.approx(
        float(np.min(landscape(space.configs()))))
    assert traj["evaluations"] <= space.size


def test_score_cache_budget_and_dedup():
    calls = []

    def counted(configs):
        calls.append(len(configs))
        return landscape(configs)

    pool = SearchSpace(**SPACE).configs()
    traj = Trajectory(agent="x", seed=0)
    cache = ScoreCache(counted, budget=5, trajectory=traj)
    got = cache.score([pool[0], pool[0], pool[1]], tag="a")
    assert len(got) == 2 and calls == [2]
    cache.score([pool[0], pool[2]], tag="b")
    assert calls == [2, 1] and traj.evaluations == 3
    cache.score(pool[3:10], tag="c")
    assert traj.evaluations == 5 and cache.exhausted
    cache.score(pool[10:12], tag="d")
    assert [r["evaluated"] for r in traj.rounds] == [2, 1, 2, 0]
    top = cache.top(3)
    assert [s for _k, s in top] == sorted(s for _k, s in top)
    with pytest.raises(ValueError, match="unknown agent"):
        make_agent("anneal")


# --- end to end --------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_scores():
    """The reference's own score of every SMOKE_SPACE config."""
    from repro.explore import FusedSweepEvaluator as RefEvaluator

    space = RefSpace.from_json(REF_SMOKE_SPACE)
    ev = RefEvaluator(ref_registry.resolve("polybench/atx", "smoke"), space,
                      session=RefSession(cache_model="batched"))
    configs = space.configs()
    return dict(zip((c.key() for c in configs), ev.evaluate(configs).scores))


@pytest.mark.parametrize("agent", ["random", "hillclimb"])
def test_best_config_on_smoke_space_is_the_references(agent,
                                                      reference_scores):
    """What ``--smoke`` runs, in both packages: the port's best config is
    one the reference scores as its own best (exactly, in its own float32
    chain), and the two best scores agree within that chain's bound."""
    space = SearchSpace.from_json(SMOKE_SPACE)
    budget = space.size if agent == "random" else space.size // 2
    kw = dict(agent=agent, budget=budget, seed=0, workload="polybench/atx")
    got = run_explore(registry.resolve("polybench/atx", "smoke"), space,
                      session=Session(device="cpu", cache_model="batched"),
                      **kw)
    want = ref_run_explore(
        ref_registry.resolve("polybench/atx", "smoke"),
        RefSpace.from_json(REF_SMOKE_SPACE),
        session=RefSession(cache_model="batched"), **kw)
    key = tuple(got["best"]["config"][k] for k in (
        "sets", "ways", "line_size", "latency_cy", "beta_cy", "cores",
        "strategy"))
    assert reference_scores[key] == min(reference_scores.values())
    assert reference_scores[key] == want["best"]["score"]
    assert got["best"]["score"] == pytest.approx(want["best"]["score"],
                                                 rel=REF_T_RTOL)
    assert got["trajectory"]["evaluations"] == \
        want["trajectory"]["evaluations"]


def keys_of(obj, prefix=""):
    """Every key path of a JSON value (list items by their first item)."""
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            out |= {f"{prefix}/{k}"} | keys_of(v, f"{prefix}/{k}")
        return out
    if isinstance(obj, list) and obj:
        return keys_of(obj[0], prefix + "[]")
    return set()


def test_result_schema_and_keys_are_the_references(tmp_path):
    space = SearchSpace(**SPACE)
    kw = dict(agent="ga", agent_params={"population": 6, "elite": 2},
              budget=12, seed=4, workload="polybench/atx")
    got = run_explore(registry.resolve("polybench/atx", "smoke"), space,
                      session=Session(device="cpu", cache_model="batched",
                                      artifact_dir=tmp_path), **kw)
    want = ref_run_explore(ref_registry.resolve("polybench/atx", "smoke"),
                           RefSpace(**SPACE),
                           session=RefSession(cache_model="batched",
                                              artifact_dir=tmp_path), **kw)
    assert keys_of(got) == keys_of(want)
    assert got["fingerprint"] == want["fingerprint"]
    args = (got["fingerprint"], space, "ga", got["agent_params"], 12, 4,
            got["objective"], "throughput", "vmap")
    ref_args = (want["fingerprint"], RefSpace(**SPACE)) + args[2:]
    assert explore_key(*args) == ref_explore_key(*ref_args)   # unstamped
    assert got["key"] == explore_key(*args, stamp=KEY_STAMP)
    assert got["key"] != want["key"]         # C5: not shared
    # both results sit in one store under the ``explore`` kind and read
    # in the other package
    assert sorted(RefStore(tmp_path).keys("explore")) == sorted(
        [got["key"], want["key"]])
    assert RefStore(tmp_path).get_json("explore", got["key"])["best"] == \
        json.loads(json.dumps(got["best"]))


def test_warm_rerun_recomputes_nothing(tmp_path):
    space = SearchSpace(**SPACE)
    kw = dict(agent="hillclimb", budget=10, seed=2, workload="unit/test")
    cold = Session(device="cpu", cache_model="batched", artifact_dir=tmp_path)
    first = run_explore(registry.resolve("polybench/atx", "smoke"), space,
                        session=cold, **kw)
    assert first["cached"] is False
    warm = Session(device="cpu", cache_model="batched", artifact_dir=tmp_path)
    again = run_explore(registry.resolve("polybench/atx", "smoke"), space,
                        session=warm, **kw)
    assert again["cached"] is True
    assert again["best"] == json.loads(json.dumps(first["best"]))
    assert again["trajectory"] == json.loads(json.dumps(first["trajectory"]))
    assert warm.stats.profile_builds == warm.stats.rd_builds == 0
    assert warm.stats.kernel_shapes == warm.stats.trace_builds == 0
    other = run_explore(registry.resolve("polybench/atx", "smoke"), space,
                        session=warm, agent="hillclimb", budget=11, seed=2)
    assert other["cached"] is False
    refreshed = run_explore(registry.resolve("polybench/atx", "smoke"),
                            space, session=warm, refresh=True, **kw)
    assert refreshed["cached"] is False


def test_run_explore_without_a_session_takes_a_device():
    res = run_explore(registry.resolve("polybench/atx", "smoke"),
                      SearchSpace(**SPACE), agent="random", budget=4,
                      device="cpu")
    assert res["cached"] is False and res["trajectory"]["evaluations"] == 4
    with pytest.raises(TypeError):
        run_explore(registry.resolve("polybench/atx", "smoke"),
                    SearchSpace(**SPACE), agent="ga",
                    agent_params={"swarm": 1}, budget=4, device="cpu")


# --- report and CLI ----------------------------------------------------------


def test_report_renders_and_updates_a_named_document(tmp_path):
    res = run_explore(registry.resolve("polybench/atx", "smoke"),
                      SearchSpace(**SPACE), agent="random", budget=6,
                      device="cpu", workload="polybench/atx")
    text = report.render_markdown([res])
    assert "`polybench/atx` | random" in text
    doc = tmp_path / "doc.md"
    doc.write_text(f"head\n{report.GENERATED_BEGIN}\nold\n"
                   f"{report.GENERATED_END}\ntail\n")
    report.update_doc(doc, [res])
    assert doc.read_text() == (f"head\n{report.GENERATED_BEGIN}\n{text}"
                               f"{report.GENERATED_END}\ntail\n")
    path = report.write_result(res, tmp_path / "out")
    assert path.name.startswith("explore_polybench-atx__random__")
    assert json.loads(path.read_text())["key"] == res["key"]


def test_cli_writes_away_from_tracked_files(tmp_path, monkeypatch, capsys):
    """``--out`` defaults to ``experiments/results/torch`` (git-ignored),
    and ``--update-doc`` needs an explicit ``--doc``."""
    monkeypatch.chdir(tmp_path)
    assert main(["--agent", "random", "--budget", "4", "--device", "cpu",
                 "--sizes", "smoke", "--artifact-dir", "none", "--space",
                 json.dumps({"sets": [256, 1024], "ways": [2, 4]})]) == 0
    written = list((tmp_path / "experiments" / "results" / "torch")
                   .glob("explore_*.json"))
    assert len(written) == 1
    with pytest.raises(SystemExit):
        main(["--update-doc", "--device", "cpu"])
    assert "--update-doc needs --doc" in capsys.readouterr().err


def test_cli_smoke_passes_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.explore", "--smoke",
         "--device", "cpu", "--artifact-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "warm re-run cached=True" in out.stdout
    assert "OK: agents recover the known best" in out.stdout
