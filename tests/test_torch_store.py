"""The port's artifact store (``repro_torch.validate.store``) and the
Session's store layer, against the JAX package's: one directory serves
both packages (a store warmed by either gives the other zero profile and
reuse-distance builds, with the rates of its own cold predict bit for
bit), binned cells are not shared (ROADMAP queue C, C4), and the
reference's own store cases hold for the port: round trips, corrupt and
truncated files, the version bump, atomic writes, concurrent same-key
writers, ``verify_fingerprints`` and ``need_traces``."""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from repro.api import PredictionRequest as RefRequest
from repro.api import Session as RefSession
from repro.validate import store as ref_store
from repro.workloads import registry as ref_registry

from repro_torch.api import (
    ExactLRU,
    MimicProfileBuilder,
    PredictionRequest,
    Session,
)
from repro_torch.core.trace.types import trace_from_blocks
from repro_torch.validate import (
    STORE_VERSION,
    ArtifactStore,
    artifact_key,
    load_profile_artifacts,
    save_profile_artifacts,
)
from repro_torch.workloads import registry

torch.set_num_threads(1)

TARGETS = ("i7-5960X", "Xeon E5-2699 v4")
RATE_TOL = 1e-6   # the reference's hit-rate bound
# the cell modes whose profiles are bit-identical across the packages
SHARED_MODES = {
    "exact": {},
    "streaming": {"window_size": 256},
    "sampled": {"sampled": 0.5},
}


def small_trace(iters=300, stride=8):
    blocks = [("OUT__1__.entry", np.array([0, 8]), True)]
    a0, b0 = 1 << 20, 2 << 20
    for i in range(iters):
        blocks.append((
            "OUT__1__.for.body",
            np.array([a0 + stride * i, b0 + stride * (i % 64), 0]),
            np.array([False, False, True]),
        ))
    return trace_from_blocks(blocks)


def request(cores=(1, 2, 4)):
    return PredictionRequest(
        targets=TARGETS, core_counts=cores, respect_core_limit=False
    )


def ref_request(cores=(1, 2, 4)):
    return RefRequest(
        targets=TARGETS, core_counts=cores, respect_core_limit=False
    )


def port_session(**kw):
    return Session(device="cpu", cache_model="batched", **kw)


def ref_session(**kw):
    return RefSession(cache_model="batched", **kw)


def rates(result):
    return [(p.target, p.cores, p.hit_rates) for p in result]


# --- one directory, both packages --------------------------------------------


@pytest.mark.parametrize("mode", sorted(SHARED_MODES))
def test_reference_warmed_store_serves_the_port(tmp_path, mode):
    kw = SHARED_MODES[mode]
    ref = ref_session(artifact_dir=tmp_path, **kw)
    want = ref.predict(ref_registry.resolve("polybench/atx", "smoke"),
                       ref_request())
    assert ref.stats.store_puts == ref.stats.profile_builds > 0

    port = port_session(artifact_dir=tmp_path, **kw)
    got = port.predict(registry.resolve("polybench/atx", "smoke"), request())
    assert port.stats.profile_builds == 0
    assert port.stats.rd_builds == 0
    assert port.stats.trace_builds == 0
    assert port.stats.store_hits == ref.stats.store_puts
    cold = port_session(**kw).predict(
        registry.resolve("polybench/atx", "smoke"), request())
    assert rates(got) == rates(cold)          # bit for bit
    for a, b in zip(got, want):
        for lvl, r in b.hit_rates.items():
            assert abs(a.hit_rates[lvl] - r) <= RATE_TOL


@pytest.mark.parametrize("mode", sorted(SHARED_MODES))
def test_port_warmed_store_serves_the_reference(tmp_path, mode):
    kw = SHARED_MODES[mode]
    port = port_session(artifact_dir=tmp_path, **kw)
    got = port.predict(registry.resolve("polybench/atx", "smoke"), request())
    assert port.stats.store_puts == port.stats.profile_builds > 0

    ref = ref_session(artifact_dir=tmp_path, **kw)
    want = ref.predict(ref_registry.resolve("polybench/atx", "smoke"),
                       ref_request())
    assert ref.stats.profile_builds == 0 and ref.stats.rd_builds == 0
    assert ref.stats.store_hits == port.stats.store_puts
    cold = ref_session(**kw).predict(
        ref_registry.resolve("polybench/atx", "smoke"), ref_request())
    assert rates(want) == rates(cold)
    for a, b in zip(got, want):
        for lvl, r in b.hit_rates.items():
            assert abs(a.hit_rates[lvl] - r) <= RATE_TOL


def test_profile_cells_written_by_both_packages_are_equal(tmp_path):
    """The same cell, written once by each package, has the same key, the
    same arrays and the same meta."""
    a, b = tmp_path / "port", tmp_path / "ref"
    port_session(artifact_dir=a).artifacts(
        registry.resolve("polybench/atx", "smoke"), 4)
    ref_session(artifact_dir=b).artifacts(
        ref_registry.resolve("polybench/atx", "smoke"), 4)
    pa, rb = ArtifactStore(a), ref_store.ArtifactStore(b)
    assert pa.keys("profile") == rb.keys("profile") != []
    for key in pa.keys("profile"):
        arrays_p, meta_p = pa.get_arrays("profile", key)
        arrays_r, meta_r = rb.get_arrays("profile", key)
        assert meta_p == meta_r
        assert sorted(arrays_p) == sorted(arrays_r)
        for name in arrays_p:
            np.testing.assert_array_equal(arrays_p[name], arrays_r[name])
    assert pa.keys("workload") == rb.keys("workload")
    for key in pa.keys("workload"):
        assert pa.get_json("workload", key) == rb.get_json("workload", key)


@pytest.mark.parametrize("window_size", [None, 256])
def test_binned_cells_are_not_shared_across_packages(tmp_path, window_size):
    """C4: the port's binned profiles differ from the reference's at the
    C2 bin points, so each package keys its binned cells by its own
    builder fingerprint and is never served the other's."""
    kw = dict(binned=True, window_size=window_size)
    ref = ref_session(artifact_dir=tmp_path, **kw)
    ref.predict(ref_registry.resolve("polybench/atx", "smoke"), ref_request())
    port = port_session(artifact_dir=tmp_path, **kw)
    port.predict(registry.resolve("polybench/atx", "smoke"), request())
    assert port.stats.store_hits == 0
    assert port.stats.profile_builds == ref.stats.profile_builds > 0
    again = ref_session(artifact_dir=tmp_path, **kw)
    again.predict(ref_registry.resolve("polybench/atx", "smoke"),
                  ref_request())
    assert again.stats.profile_builds == 0   # its own cells, not the port's
    port2 = port_session(artifact_dir=tmp_path, **kw)
    port2.predict(registry.resolve("polybench/atx", "smoke"), request())
    assert port2.stats.profile_builds == 0
    assert port2.stats.store_hits == port.stats.store_puts
    fp = MimicProfileBuilder("cpu", binned=True).store_fingerprint
    assert fp == "repro_torch.api.stages.MimicProfileBuilder+binned"
    assert fp != again.builder.store_fingerprint
    keys = ArtifactStore(tmp_path).keys("profile")
    assert any(k.endswith(fp) for k in keys)
    assert any(k.endswith(again.builder.store_fingerprint) for k in keys)


def test_exact_keys_are_the_references():
    for kw in (dict(), dict(window_size=64), dict(sampled=0.25)):
        port = MimicProfileBuilder("cpu", **kw)
        ref = RefSession(**kw).builder
        assert port.store_fingerprint == ref.store_fingerprint
    args = ("tid", 64, 4, "round_robin", 0, None)
    assert artifact_key(*args) == ref_store.artifact_key(*args)
    assert STORE_VERSION == ref_store.STORE_VERSION


# --- raw payload round-trips -------------------------------------------------


def test_arrays_round_trip_with_meta(tmp_path):
    store = ArtifactStore(tmp_path)
    arrays = {
        "a": np.arange(7, dtype=np.int64),
        "b": np.array([[1.5, -2.0]], dtype=np.float64),
    }
    meta = {"cores": 4, "strategy": "round_robin", "nested": {"x": 1}}
    store.put_arrays("profile", "k1", arrays, meta)
    got_arrays, got_meta = store.get_arrays("profile", "k1")
    assert got_meta == meta
    for name in arrays:
        np.testing.assert_array_equal(got_arrays[name], arrays[name])
    assert store.stats.puts == 1 and store.stats.hits == 1


def test_json_round_trip_and_miss(tmp_path):
    store = ArtifactStore(tmp_path)
    obj = {"L1": 0.99, "L2": 0.75, "L3": 0.5}
    store.put_json("exact", "cell", obj)
    assert store.get_json("exact", "cell") == obj
    assert store.get_json("exact", "absent") is None
    assert store.get_arrays("profile", "absent") is None
    assert store.stats.misses == 2
    assert store.keys("exact") == ["cell"]


def test_profile_artifacts_round_trip(tmp_path):
    """Every field of a ProfileArtifacts cell survives the npz trip
    (traces intentionally excluded), as the port's types."""
    store = ArtifactStore(tmp_path)
    art = port_session(sampled=0.5).artifacts(small_trace(), 4)
    save_profile_artifacts(store, art)
    loaded = load_profile_artifacts(
        store, art.trace_id, art.line_size, art.cores, art.strategy,
        art.seed, art.window_size,
    )
    assert loaded is not None and not loaded.has_traces
    assert type(loaded) is type(art)
    assert (loaded.trace_id, loaded.cores, loaded.strategy, loaded.seed,
            loaded.line_size, loaded.sampled) == (
        art.trace_id, art.cores, art.strategy, art.seed, art.line_size,
        art.sampled)
    for name in ("prd", "crd"):
        a, b = getattr(art, name), getattr(loaded, name)
        assert type(a) is type(b)
        np.testing.assert_array_equal(a.distances, b.distances)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert (a.total, a.error_bound) == (b.total, b.error_bound)


# --- Session layering --------------------------------------------------------


def test_two_sessions_share_one_store(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    s1 = port_session(store=store)
    r1 = s1.predict(trace, request())
    assert s1.stats.profile_builds > 0
    assert s1.stats.store_puts == s1.stats.profile_builds
    assert s1.stats.store_hits == 0

    s2 = port_session(store=store)
    r2 = s2.predict(trace, request())
    assert s2.stats.profile_builds == 0
    assert s2.stats.rd_builds == 0
    assert s2.stats.mimic_builds == 0
    assert s2.stats.store_hits == s1.stats.profile_builds
    assert r1.to_json() == r2.to_json()


def test_different_builders_never_share_store_entries(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    port_session(store=store).artifacts(trace, 2)

    class OtherBuilder(MimicProfileBuilder):
        pass

    s2 = port_session(store=store, profile_builder=OtherBuilder("cpu"))
    s2.artifacts(trace, 2)
    assert s2.stats.store_hits == 0
    assert s2.stats.profile_builds == 1
    s3 = port_session(store=store)
    s3.artifacts(trace, 2)
    assert s3.stats.store_hits == 1 and s3.stats.profile_builds == 0


def test_artifact_dir_constructs_store(tmp_path):
    s = port_session(artifact_dir=tmp_path / "cache")
    assert isinstance(s.store, ArtifactStore)
    s.artifacts(small_trace(), 2)
    assert s.stats.store_puts == 1
    assert (tmp_path / "cache" / f"v{STORE_VERSION}" / "profile").is_dir()


def test_ground_truth_rematerializes_traces_from_store_hit(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    gt1 = port_session(store=store).ground_truth_hit_rates(
        trace, TARGETS[0], 4)
    s2 = port_session(store=store)
    gt2 = s2.ground_truth_hit_rates(trace, TARGETS[0], 4)
    assert gt2 == gt1
    assert s2.stats.profile_builds == 0
    assert s2.stats.store_hits == 1
    assert s2.stats.mimic_builds == 1  # traces rebuilt, profiles not


def test_exact_lru_predict_over_store_hits(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    port_session(store=store).predict(trace, request(cores=(2,)))
    s = Session(device="cpu", store=store, cache_model=ExactLRU())
    result = s.predict(trace, request(cores=(2,)))
    assert s.stats.profile_builds == 0 and s.stats.store_hits == 1
    gt = Session(device="cpu").ground_truth_hit_rates(trace, TARGETS[0], 2)
    assert result.one(target=TARGETS[0]).hit_rates == gt


def test_need_traces_rematerializes_a_cached_store_hit(tmp_path):
    """A profile-only cell already in the Session's memory gets its
    traces on a later ``need_traces=True``, without a profile pass; a
    streaming cell keeps ``shared=None``."""
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    port_session(store=store).artifacts(trace, 4)
    port_session(store=store, window_size=64).artifacts(trace, 4)
    s = port_session(store=store)
    bare = s.artifacts(trace, 4)
    assert not bare.has_traces and s.stats.mimic_builds == 0
    full = s.artifacts(trace, 4, need_traces=True)
    assert full.has_traces and full.shared is not None
    assert len(full.privates) == 4
    assert s.stats.profile_builds == 0 and s.stats.profile_hits == 1
    np.testing.assert_array_equal(full.crd.counts, bare.crd.counts)
    st = port_session(store=store, window_size=64)
    cell = st.artifacts(trace, 4, need_traces=True)
    assert cell.has_traces and cell.shared is None
    assert st.stats.profile_builds == 0


# --- declared fingerprints -----------------------------------------------------


def test_declared_source_records_its_content_hash(tmp_path):
    s = port_session(artifact_dir=tmp_path, verify_fingerprints=True)
    w = registry.resolve("polybench/atx", "smoke")
    s.predict(w, request(cores=(1,)))
    meta = s.store.get_json("workload", w.declared_fingerprint)
    from repro_torch.api.stages import trace_content_id

    assert meta == {"trace_content_id": trace_content_id(w.trace()),
                    "refs": len(w.trace()), "workload": "polybench/atx"}
    # a warm store serves the same request with no trace build at all
    warm = port_session(artifact_dir=tmp_path, verify_fingerprints=True)
    warm.predict(registry.resolve("polybench/atx", "smoke"),
                 request(cores=(1,)))
    assert warm.stats.trace_builds == 0


def test_verify_fingerprints_catches_a_stale_declaration(tmp_path):
    w = registry.resolve("polybench/atx", "smoke")
    port_session(artifact_dir=tmp_path).artifacts(w, 2)
    store = ArtifactStore(tmp_path)
    meta = store.get_json("workload", w.declared_fingerprint)
    store.put_json("workload", w.declared_fingerprint,
                   {**meta, "trace_content_id": "0" * 16})
    lax = port_session(artifact_dir=tmp_path)
    lax.artifacts(registry.resolve("polybench/atx", "smoke"), 2,
                  window_size=64)    # a new cell: the trace is built
    strict = port_session(artifact_dir=tmp_path, verify_fingerprints=True)
    with pytest.raises(RuntimeError, match="is stale"):
        strict.artifacts(registry.resolve("polybench/atx", "smoke"), 2,
                         line_size=128)


def test_registry_forwards_the_store():
    class Source:
        def trace(self):
            return small_trace()

        def attach_store(self, store):
            self.store = store

    spec = registry.WorkloadSpec(
        name="test/store-forwarding", build=lambda sizes: Source(),
        size_kwargs=lambda sizes: {}, presets=("smoke",))
    reg = registry.WorkloadRegistry()
    reg.register(spec)
    marker = object()
    assert reg.resolve("test/store-forwarding", "smoke",
                       store=marker).store is marker
    assert not hasattr(reg.resolve("test/store-forwarding"), "store")


# --- durability --------------------------------------------------------------


def test_truncated_file_falls_back_to_recompute(tmp_path):
    store = ArtifactStore(tmp_path)
    trace = small_trace()
    art = port_session(store=store).artifacts(trace, 4)
    path = store.path(
        "profile",
        artifact_key(art.trace_id, art.line_size, 4, "round_robin", 0, None),
        "npz",
    )
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 2])  # a torn write

    s2 = port_session(store=store)
    art2 = s2.artifacts(trace, 4)
    assert s2.stats.profile_builds == 1
    assert s2.stats.store_hits == 0
    assert store.stats.corrupt == 1
    np.testing.assert_array_equal(art2.crd.distances, art.crd.distances)
    np.testing.assert_array_equal(art2.crd.counts, art.crd.counts)

    s3 = port_session(store=store)                # healed by the rewrite
    s3.artifacts(trace, 4)
    assert s3.stats.store_hits == 1 and s3.stats.profile_builds == 0


def test_corrupt_json_reads_as_miss(tmp_path):
    store = ArtifactStore(tmp_path)
    store.put_json("exact", "cell", {"L1": 0.5})
    store.path("exact", "cell", "json").write_text("{not json")
    assert store.get_json("exact", "cell") is None
    assert store.stats.corrupt == 1
    assert not store.path("exact", "cell", "json").exists()


def test_version_bump_invalidates_keys(tmp_path):
    old = ArtifactStore(tmp_path, version=STORE_VERSION)
    trace = small_trace()
    port_session(store=old).artifacts(trace, 4)
    bumped = ArtifactStore(tmp_path, version=STORE_VERSION + 1)
    s2 = port_session(store=bumped)
    s2.artifacts(trace, 4)
    assert s2.stats.store_hits == 0
    assert s2.stats.profile_builds == 1
    assert old.keys("profile") and bumped.keys("profile")
    assert (tmp_path / f"v{STORE_VERSION}").is_dir()
    assert (tmp_path / f"v{STORE_VERSION + 1}").is_dir()


def test_atomic_write_leaves_no_temp_files(tmp_path):
    store = ArtifactStore(tmp_path)
    store.put_arrays("profile", "k", {"a": np.arange(3)}, {})
    store.put_json("exact", "k", {"x": 1})
    assert list(tmp_path.rglob("*.tmp")) == []


def test_failed_write_leaves_no_temp_file_and_no_target(tmp_path):
    store = ArtifactStore(tmp_path)

    class Boom(Exception):
        pass

    def write(_fh):
        raise Boom

    from repro_torch.validate.store import atomic_write

    with pytest.raises(Boom):
        atomic_write(store.path("exact", "k", "json"), write)
    assert list(tmp_path.rglob("*")) == [tmp_path / f"v{STORE_VERSION}",
                                         tmp_path / f"v{STORE_VERSION}"
                                         / "exact"]


def test_concurrent_same_key_writers_never_interleave(tmp_path):
    store = ArtifactStore(tmp_path)
    arrays = {"a": np.arange(4096, dtype=np.int64)}
    meta = {"k": "v"}
    stop = threading.Event()
    problems: list[str] = []

    def writer():
        w = ArtifactStore(tmp_path)  # own stats, same directory
        while not stop.is_set():
            w.put_arrays("profile", "cell", arrays, meta)

    def reader():
        r = ArtifactStore(tmp_path)
        while not stop.is_set():
            got = r.get_arrays("profile", "cell")
            if got is None:
                continue  # not yet written: a miss, never an error
            got_arrays, got_meta = got
            if (got_meta != meta
                    or not np.array_equal(got_arrays["a"], arrays["a"])):
                problems.append("partial payload observed")
                return

    threads = [threading.Thread(target=writer) for _ in range(3)]
    threads += [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    assert problems == []
    got_arrays, got_meta = store.get_arrays("profile", "cell")
    assert got_meta == meta
    np.testing.assert_array_equal(got_arrays["a"], arrays["a"])


def test_corrupt_cleanup_spares_concurrently_healed_file(tmp_path):
    store = ArtifactStore(tmp_path)
    path = store.path("profile", "cell", "npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"definitely not an npz")
    seen = path.stat()

    # a concurrent writer heals the cell between read and cleanup
    store.put_arrays("profile", "cell", {"a": np.arange(3)}, {"ok": True})
    store._drop_corrupt(path, seen)
    assert path.exists(), "cleanup deleted a healed cell"
    got = store.get_arrays("profile", "cell")
    assert got is not None and got[1] == {"ok": True}

    # ...but an actually-unchanged corrupt file is still cleared
    path.write_bytes(b"corrupt again")
    store._drop_corrupt(path, path.stat())
    assert not path.exists()
