"""The port stands alone: no JAX and nothing of the JAX package in
``src/repro_torch/`` or ``chip_smoke.py``; CUDA is the default device
and its absence is an error; unported options raise, ported ones run
(the store options, the last unported Session options, now construct
a store)."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import (
    AnalyticalSDCM,
    ExactLRU,
    MimicProfileBuilder,
    PredictionRequest,
    Session,
)
from repro_torch.core.trace.types import trace_from_blocks

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_neither_jax_nor_reference():
    code = (
        "import sys, repro_torch.api, repro_torch.interop, "
        "repro_torch.workloads.polybench, repro_torch.core.reuse, "
        "repro_torch.core.trace, repro_torch.kernels.reuse_hist, "
        "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan, "
        "repro_torch.models.api, repro_torch.configs.reduced, "
        "repro_torch.launch.serve, repro_torch.dist.sharding, "
        "repro_torch.workloads.registry, repro_torch.core.cachesim, "
        "repro_torch.core.reuse.sampled, repro_torch.core.reuse.crd, "
        "repro_torch.core.tasklist, repro_torch.core.predictor, "
        "repro_torch.validate, repro_torch.explore, "
        "repro_torch.explore.__main__, repro_torch.service, "
        "repro_torch.service.__main__, repro_torch.validate.__main__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_session_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MimicProfileBuilder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AnalyticalSDCM(backend="batched").hit_rates_grid([])


def test_session_binds_its_device_to_its_stages():
    s = Session(device="cpu", cache_model="batched")
    assert s.device == torch.device("cpu")
    assert s.builder.device == torch.device("cpu")
    assert s.cache_model.device == torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    dict(artifact_dir="store"),
    dict(store=object()),
], ids=lambda kw: next(iter(kw)))
def test_unported_session_options_raise(kwargs, tmp_path):
    """The store options raised until the store was ported; now
    ``artifact_dir`` constructs an ``ArtifactStore`` there and ``store``
    is taken as given, as in the reference, and nothing is written until
    a cell is built."""
    from repro_torch.validate import ArtifactStore

    if "artifact_dir" in kwargs:
        kwargs = dict(artifact_dir=tmp_path / kwargs["artifact_dir"])
    s = Session(device="cpu", **kwargs)
    if "artifact_dir" in kwargs:
        assert isinstance(s.store, ArtifactStore)
        assert s.store.root == kwargs["artifact_dir"]
        assert not kwargs["artifact_dir"].exists()
    else:
        assert s.store is kwargs["store"]


@pytest.mark.parametrize("kwargs", [
    dict(sampled=0.5),
    dict(verify_fingerprints=True),
], ids=lambda kw: next(iter(kw)))
def test_ported_session_options_run(kwargs):
    """Sampled profiles and fingerprint verification construct and
    predict on the CPU (without a store, ``verify_fingerprints`` has
    nothing to check, as in the reference)."""
    s = Session(device="cpu", **kwargs)
    assert s.builder.sampled == kwargs.get("sampled")
    assert s.verify_fingerprints == kwargs.get("verify_fingerprints", False)
    out = s.predict(_trace(), PredictionRequest(targets=("i7-5960X",),
                                                core_counts=(1, 2)))
    assert len(out) == 2
    assert s.artifacts(_trace(), 2).sampled == kwargs.get("sampled")


def _trace():
    return trace_from_blocks([("b", np.arange(0, 64, 8), True)] * 4)


@pytest.mark.parametrize("kwargs", [
    dict(sampled_rate=0.5),
], ids=lambda kw: next(iter(kw)))
def test_ported_request_options_run(kwargs):
    req = PredictionRequest(targets=("i7-5960X",), core_counts=(1, 2),
                            **kwargs)
    s = Session(device="cpu")
    assert len(s.predict(_trace(), req)) == 2
    assert s.artifacts(_trace(), 2, sampled=0.5).sampled == 0.5


def test_binned_and_window_session_options_construct():
    """The options of the second slice run on the CPU: each session
    builds profiles in its own mode and predicts."""
    req = PredictionRequest(targets=("i7-5960X",), core_counts=(1, 2))
    for kw in (dict(window_size=16), dict(binned=True),
               dict(binned=True, window_size=16)):
        s = Session(device="cpu", **kw)
        assert s.builder.binned == kw.get("binned", False)
        assert s.builder.window_size == kw.get("window_size")
        out = s.predict(_trace(), req)
        assert len(out) == 2
        art = s.artifacts(_trace(), 2)
        assert art.binned == kw.get("binned", False)
        assert art.window_size == kw.get("window_size")
    out = Session(device="cpu").predict(
        _trace(), PredictionRequest(targets=("i7-5960X",), window_size=16))
    assert len(out) == 1


def test_unported_stages_raise():
    s = Session(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A: A-11"):
        s.predict("model/llama3_8b/decode",
                  PredictionRequest(targets=("i7-5960X",)))


def test_ported_stages_run():
    """ExactLRU, the ground truth and registry names run on the CPU."""
    s = Session(device="cpu")
    rates = s.ground_truth_hit_rates(_trace(), "i7-5960X", 1)
    assert set(rates) == {"L1", "L2", "L3"}
    assert all(0.0 <= r <= 1.0 for r in rates.values())
    assert ExactLRU(device="cpu").name == "exact-lru"
    out = Session(device="cpu", cache_model=ExactLRU()).predict(
        _trace(), PredictionRequest(targets=("i7-5960X",)))
    assert out.predictions[0].hit_rates == rates
    for name in ("polybench/atx", "atx", "synthetic/stride"):
        assert len(s.predict(name, PredictionRequest(
            targets=("i7-5960X",)))) == 1


def test_window_size_zero_is_the_in_memory_path():
    req = PredictionRequest(targets=("i7-5960X",), window_size=0)
    out = Session(device="cpu").predict(_trace(), req)
    assert len(out) == 1
