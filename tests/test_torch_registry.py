"""The workload registry: the port's roster, aliases and declared
fingerprints against the JAX package's (model cells are keyed apart:
ROADMAP C8), and registry names as trace sources of the port's
Session."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro.api.stages import trace_content_id as ref_trace_content_id
from repro.workloads import registry as ref_registry

from repro_torch.api import PredictionRequest, Session
from repro_torch.api.stages import as_trace_source, trace_content_id
from repro_torch.workloads import registry
from repro_torch.workloads.polybench import MAKERS, SIZE_PRESETS, make_workload

torch.set_num_threads(1)

PRESETS = (None, "smoke", "validation", "validation-xl", "validation-xxl")


def ref_roster() -> list[str]:
    """The reference's names whose fingerprints the port shares."""
    return [n for n in ref_registry.workload_names()
            if not n.startswith("model/")]


def test_names_and_aliases_equal_reference():
    assert registry.workload_names() == ref_registry.workload_names()
    assert len(registry.workload_names()) == 16 + 10 * 3
    assert registry.workload_aliases() == ref_registry.workload_aliases()
    for abbr in MAKERS:
        assert registry.canonical_name(abbr) == f"polybench/{abbr}"
    assert registry.workload_names("synthetic") == [
        "synthetic/stream", "synthetic/stride"]
    assert len(registry.workload_names("model")) == 30
    assert registry.GENERATOR_VERSION == ref_registry.GENERATOR_VERSION


@pytest.mark.parametrize("sizes", PRESETS)
def test_model_fingerprints_keyed_apart_from_reference(sizes):
    """C8: every preset of a model cell shares one fingerprint, which is
    not the reference's (its trace comes from another graph)."""
    for name in registry.workload_names("model"):
        fp = registry.declared_fingerprint(name, sizes)
        assert fp == registry.declared_fingerprint(name, None)
        assert fp != ref_registry.declared_fingerprint(name, sizes), name


def test_model_op_counts_from_warm_store(tmp_path, monkeypatch):
    """A cell resolved with a store records once; a second resolution on
    the warm store answers ``op_counts`` without recording."""
    from repro_torch.validate.store import ArtifactStore
    from repro_torch.workloads.model_trace import ModelTraceSource

    store = ArtifactStore(tmp_path)
    first = registry.resolve("model/llama3_8b/decode", "smoke", store=store)
    counts = first.op_counts
    assert counts.fp_ops > 0 and counts.total_bytes > 0

    def no_recording(self):
        raise AssertionError("a warm store must not record")

    monkeypatch.setattr(ModelTraceSource, "record", no_recording)
    warm = registry.resolve("model/llama3-8b/decode", "smoke", store=store)
    assert warm.op_counts == counts


@pytest.mark.parametrize("sizes", PRESETS)
def test_declared_fingerprints_equal_reference(sizes):
    for name in ref_roster():
        assert registry.declared_fingerprint(name, sizes) == \
            ref_registry.declared_fingerprint(name, sizes), name
    fps = {registry.declared_fingerprint("polybench/atx", s) for s in PRESETS}
    assert len(fps) == 1 + len(SIZE_PRESETS)


@pytest.mark.parametrize("name", [
    "polybench/atx", "polybench/mvt", "polybench/blk", "polybench/dgn",
    "synthetic/stream", "synthetic/stride", "lu"])
def test_resolved_traces_equal_reference(name):
    src = registry.resolve(name, "smoke")
    ref = ref_registry.resolve(name, "smoke")
    assert src.declared_fingerprint == ref.declared_fingerprint
    assert src.workload_name == ref.workload_name
    t, rt = src.trace(), ref.trace()
    assert np.array_equal(t.addresses, rt.addresses)
    assert np.array_equal(t.shared_mask, rt.shared_mask)
    assert np.array_equal(t.bb_ids, rt.bb_ids)
    assert trace_content_id(t) == ref_trace_content_id(rt)
    assert vars(src.op_counts) == vars(ref.op_counts)


def test_model_names_and_unknown_names_raise():
    """Every model cell resolves; a ``train`` cell's counts, trace and
    info come from the recording of the training step (its loss and
    gradient), a larger program than the prefill's."""
    for fn in (registry.resolve, registry.canonical_name,
               registry.declared_fingerprint):
        assert fn("model/llama3_8b/train")
    src = registry.resolve("model/llama3_8b/train")
    assert all(v > 0 for v in vars(src.op_counts).values())
    assert src.info["touched_bytes"] > 0
    prefill = registry.resolve("model/llama3_8b/prefill")
    assert len(src.trace()) > 2 * len(prefill.trace())
    assert src.op_counts.fp_ops > 2 * prefill.op_counts.fp_ops
    with pytest.raises(KeyError, match="unknown workload"):
        registry.resolve("polybench/nope")
    with pytest.raises(ValueError, match="unknown size preset"):
        registry.resolve("polybench/atx", "huge")


def test_registry_round_trip_and_errors():
    def spec(name="test/unit", aliases=(), version="1"):
        return registry.WorkloadSpec(
            name=name, build=lambda sizes: types.SimpleNamespace(),
            size_kwargs=lambda sizes: {"sizes": sizes or "default"},
            presets=("smoke",), aliases=aliases, version=version)

    reg = registry.WorkloadRegistry()
    reg.register(spec(aliases=("tu",)))
    assert reg.names() == ["test/unit"] and reg.canonical("tu") == "test/unit"
    src = reg.resolve("tu", "smoke")
    assert src.workload_name == "test/unit"
    ref_spec = ref_registry.WorkloadSpec(
        name="test/unit", build=lambda sizes: None,
        size_kwargs=lambda sizes: {"sizes": sizes or "default"})
    assert src.declared_fingerprint == ref_spec.fingerprint("smoke")
    with pytest.raises(ValueError, match="namespaced"):
        reg.register(spec(name="flat"))
    with pytest.raises(ValueError, match="already registered"):
        reg.register(spec())
    with pytest.raises(ValueError, match="already taken"):
        reg.register(spec(name="test/other", aliases=("tu",)))
    assert spec(version="2").fingerprint("smoke") != \
        spec().fingerprint("smoke")


def test_registry_names_are_trace_sources():
    src = as_trace_source("atx")
    assert src.declared_fingerprint == registry.declared_fingerprint("atx")
    sess = Session(device="cpu", verify_fingerprints=True)
    assert sess.verify_fingerprints and sess.store is None
    w = registry.resolve("polybench/atx", "smoke")
    # a declared source is keyed by its fingerprint, without a build
    assert sess.identify(w) == w.declared_fingerprint
    assert sess.stats.trace_builds == 0
    req = PredictionRequest(targets=("i7-5960X",), core_counts=(1, 2))
    got = sess.predict(w, req)
    assert got.trace_id == w.declared_fingerprint
    assert sess.stats.trace_builds == 1
    plain = Session(device="cpu").predict(make_workload("atx", "smoke"), req)
    assert [p.hit_rates for p in got] == [p.hit_rates for p in plain]
    assert trace_content_id(w.trace()) == plain.trace_id
    by_name = Session(device="cpu").predict("polybench/atx", req)
    assert len(by_name) == 2
