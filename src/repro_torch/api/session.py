"""Session: executes PredictionRequests with content-hash artifact
caching — port of ``repro/api/session.py``.

One trace is loaded once, and every derived artifact is cached under
content-hash keys

    reuse distances       (trace_id, line_size)
    mimicked privates     (trace_id, cores)
    interleaved shared    (trace_id, cores, strategy, seed)
    PRD/CRD profiles      (trace_id, line_size, cores, strategy, seed)

so a full (target x core-count x strategy) sweep computes each profile
exactly once across ALL targets.  ``Session.stats`` exposes the same
build/hit counters as the reference, and ``Session.stage_seconds`` the
host wall time spent in each stage.

Device policy: ``Session(device=None)`` runs on the GPU and raises
when CUDA is absent; ``device="cpu"`` runs the plain PyTorch versions
of the kernels on the host.  Stages built by the Session, and an
``AnalyticalSDCM`` passed without a device, run on the Session's
device.

``window_size=W`` (on the Session, the builder, or per request)
builds each cell's profiles window by window: bit-identical to the
in-memory path, and the interleaved trace of a deterministic strategy
is never materialized.  ``binned=True`` builds log2-binned profiles
through the reuse-histogram kernel; the two combine.  ``sampled=R``
builds SHARDS-sampled profiles (each with its declared error bound),
and a request's ``sampled_rate`` overrides it cell by cell.
``ground_truth_hit_rates`` runs the exact-LRU simulator on the
Session's device.

Registry-resolved sources (``repro_torch.workloads.registry``) are
keyed by their declared fingerprint, as in the reference.

``Session(artifact_dir=...)`` (or ``store=ArtifactStore(...)``) layers
the disk store of :mod:`repro_torch.validate.store` under the in-memory
caches.  Lookup order per cell:

    in-memory dict  ->  ArtifactStore (npz on disk)  ->  build + put

The layout and keys are the reference's, so a store that either package
warmed serves the other (binned cells excepted: ROADMAP queue C, C4).
A cell served from disk carries profiles only; ``need_traces`` (and
``ExactLRU``) rebuild its mimicked traces without rerunning a profile
pass.  The first materialization of a declared source records its
content hash in the store's ``workload`` meta, and
``verify_fingerprints=True`` raises when a later one hashes otherwise.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

from repro_torch.api.request import PredictionRequest
from repro_torch.api.results import CellPrediction, PredictionSet
from repro_torch.api.stages import (
    AnalyticalSDCM,
    ExactLRU,
    MimicProfileBuilder,
    ProfileArtifacts,
    as_trace_source,
    default_runtime_model,
    resolve_runtime_model,
    trace_content_id,
)
from repro_torch.core.reuse.profile import profile_from_distances
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.device import resolve_device
from repro_torch.hw.targets import resolve_target


@dataclasses.dataclass
class SessionStats:
    """Observable cache behaviour (the reference's counters)."""

    trace_builds: int = 0
    rd_builds: int = 0
    mimic_builds: int = 0
    interleave_builds: int = 0
    profile_builds: int = 0
    profile_hits: int = 0
    streaming_builds: int = 0
    store_hits: int = 0     # profiles served from the disk store
    store_puts: int = 0     # freshly built profiles written back
    kernel_shapes: int = 0  # NEW SDCM launch shapes this session
    # (``repro_torch.api.batched``); a warm session re-running an
    # identical sweep leaves it unchanged.


class Session:
    """Cached executor for :class:`PredictionRequest` grids.

    Stages are injectable: pass a different ``cache_model`` or
    ``profile_builder`` and the same request produces an
    alternative-model grid.  ``cache=False`` disables artifact reuse.

    ``window_size``, ``binned`` and ``sampled`` configure the default
    builder; ``binned=True`` or ``sampled=R`` with a builder of one's
    own needs that builder to be binned, or sampled at R.
    ``window_size=0`` (here or per request) forces the in-memory path.

    ``artifact_dir`` (or an explicit ``store``) layers a disk-backed
    :class:`repro_torch.validate.store.ArtifactStore` under the
    in-memory caches: ``stats.store_hits`` counts disk loads,
    ``stats.store_puts`` write-backs.
    """

    def __init__(
        self,
        *,
        device=None,
        profile_builder=None,
        cache_model=None,
        runtime_model=None,
        cache: bool = True,
        window_size: int | None = None,
        binned: bool = False,
        sampled: float | None = None,
        store=None,
        artifact_dir=None,
        verify_fingerprints: bool = False,
    ):
        self.device = resolve_device(device)
        if profile_builder is None:
            profile_builder = MimicProfileBuilder(
                self.device, window_size=window_size, binned=binned,
                sampled=sampled,
            )
        elif binned and not getattr(profile_builder, "binned", False):
            raise ValueError(
                "binned=True only configures the default builder; pass a "
                "builder with binned profile support instead"
            )
        elif (sampled is not None
              and getattr(profile_builder, "sampled", None) != sampled):
            raise ValueError(
                "sampled=R only configures the default builder; pass a "
                "builder with sampled profile support instead"
            )
        self.builder = profile_builder
        self._sampled_builders: dict[float, object] = {}
        self.window_size = window_size
        if isinstance(cache_model, str):
            # shorthand for the analytical backends ("batched"/"numpy")
            cache_model = AnalyticalSDCM(backend=cache_model)
        cache_model = cache_model or AnalyticalSDCM()
        if (isinstance(cache_model, (AnalyticalSDCM, ExactLRU))
                and cache_model.device is None):
            cache_model = dataclasses.replace(cache_model, device=self.device)
        self.cache_model = cache_model
        self.runtime_model = runtime_model  # None -> per-target default
        self.cache_enabled = cache
        if store is None and artifact_dir is not None:
            from repro_torch.validate.store import ArtifactStore

            store = ArtifactStore(artifact_dir)
        self.store = store
        self.verify_fingerprints = verify_fingerprints
        self.stats = SessionStats()
        self.stage_seconds: collections.defaultdict = (
            collections.defaultdict(float)
        )
        self._trace_ids: dict[int, str] = {}       # id(source) -> trace_id
        # pins every cached source: id() keys are only valid while the
        # object is alive, so a recycled address must never hit the map
        self._sources: dict[int, object] = {}
        self._traces: dict[str, LabeledTrace] = {}
        self._rd: dict = {}
        self._privates: dict = {}
        self._shared: dict = {}
        self._profiles: dict = {}

    @contextlib.contextmanager
    def _stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] += time.perf_counter() - t0

    # --- artifact construction (each key computed exactly once) -----------

    def identify(self, source) -> str:
        """Trace id of a source: its declared fingerprint when it has one
        (registry-resolved workloads, without building the trace), else
        its content hash."""
        sid = id(source)
        if self.cache_enabled and sid in self._trace_ids:
            return self._trace_ids[sid]
        fp = getattr(source, "declared_fingerprint", None)
        if fp and self.cache_enabled:
            self._trace_ids[sid] = str(fp)
            self._sources[sid] = source
            return str(fp)
        tid, _trace = self.load(source)
        return tid

    def load(self, source) -> tuple[str, LabeledTrace]:
        """Coerce + trace + id a source (cached).  With caching disabled
        the id and the content hash are skipped (nothing is keyed on
        them)."""
        sid = id(source)  # the caller's object, not the coercion wrapper
        if self.cache_enabled and sid in self._trace_ids:
            tid = self._trace_ids[sid]
            return tid, self._trace_of(tid, source)
        if not self.cache_enabled:
            with self._stage("trace"):
                trace = as_trace_source(source).trace()
            self.stats.trace_builds += 1
            return "", trace
        fp = getattr(source, "declared_fingerprint", None)
        tid = str(fp) if fp else None
        if tid is None:
            with self._stage("trace"):
                trace = as_trace_source(source).trace()
            self.stats.trace_builds += 1
            tid = trace_content_id(trace)
            self._traces.setdefault(tid, trace)
        self._trace_ids[sid] = tid
        self._sources[sid] = source
        return tid, self._trace_of(tid, source)

    def _trace_of(self, tid: str, source) -> LabeledTrace:
        """Materialize (or fetch) the trace behind an already-known id;
        the only place declared sources build their trace."""
        if tid in self._traces:
            return self._traces[tid]
        with self._stage("trace"):
            trace = as_trace_source(source).trace()
        self.stats.trace_builds += 1
        self._traces[tid] = trace
        if getattr(source, "declared_fingerprint", None):
            self._check_declared(tid, source, trace)
        return trace

    def _check_declared(self, tid: str, source, trace: LabeledTrace) -> None:
        """Record (and optionally verify) the content hash behind a
        declared fingerprint: the first materialization writes
        ``trace_content_id`` into the store's workload meta; under
        ``verify_fingerprints=True`` a later one that hashes otherwise (a
        generator whose declared version lied) raises."""
        if self.store is None:
            return
        meta = dict(self.store.get_json("workload", tid) or {})
        recorded = meta.get("trace_content_id")
        if recorded is None:
            meta.update(
                trace_content_id=trace_content_id(trace),
                refs=len(trace),
                workload=getattr(source, "workload_name", None)
                or meta.get("workload"),
            )
            self.store.put_json("workload", tid, meta)
        elif self.verify_fingerprints:
            cid = trace_content_id(trace)
            if cid != recorded:
                raise RuntimeError(
                    f"declared fingerprint {tid} of "
                    f"{getattr(source, 'workload_name', source)!r} is stale: "
                    f"trace content hash {cid} != recorded {recorded} — "
                    "bump the generator version"
                )

    def _reuse_distances(self, tid: str, trace: LabeledTrace, line: int):
        key = (tid, line)
        if self.cache_enabled and key in self._rd:
            return self._rd[key]
        from repro_torch.core.reuse.distance import reuse_distances

        self.stats.rd_builds += 1
        rd = reuse_distances(trace.addresses, line, device=self.device)
        if self.cache_enabled:
            self._rd[key] = rd
        return rd

    def _private_traces(self, tid: str, trace: LabeledTrace, cores: int):
        if cores == 1:
            return [trace]
        key = (tid, cores)
        if self.cache_enabled and key in self._privates:
            return self._privates[key]
        self.stats.mimic_builds += 1
        with self._stage("mimic"):
            privs = self.builder.private_traces(trace, cores)
        if self.cache_enabled:
            self._privates[key] = privs
        return privs

    def _shared_trace(self, tid: str, privs, cores: int, strategy: str,
                      seed: int):
        key = (tid, cores, strategy, seed)
        if self.cache_enabled and key in self._shared:
            return self._shared[key]
        self.stats.interleave_builds += 1
        with self._stage("interleave"):
            shared = self.builder.interleave(privs, strategy, seed)
        if self.cache_enabled:
            self._shared[key] = shared
        return shared

    def _resolve_window(self, window_size: int | None) -> int | None:
        """Explicit override > session default > builder default."""
        if window_size is not None:
            return window_size or None  # 0 forces the in-memory path
        if self.window_size is not None:
            return self.window_size or None  # normalized: one cache key
        return getattr(self.builder, "window_size", None)

    def _builder_for(self, sampled: float | None):
        """The Session builder, or a cached sampled-rate variant when a
        per-request rate overrides it (``PredictionRequest.sampled_rate``)."""
        if sampled is None:
            return self.builder
        rate = float(sampled)
        if getattr(self.builder, "sampled", None) == rate:
            return self.builder
        if not hasattr(self.builder, "with_sampled"):
            raise ValueError(
                "per-request sampled_rate needs a profile builder with "
                "with_sampled support (the default MimicProfileBuilder)"
            )
        variant = self._sampled_builders.get(rate)
        if variant is None:
            variant = self.builder.with_sampled(rate)
            self._sampled_builders[rate] = variant
        return variant

    def artifacts(self, source, cores: int, *, strategy: str = "round_robin",
                  seed: int = 0, line_size: int = 64,
                  window_size: int | None = None,
                  sampled: float | None = None,
                  need_traces: bool = False) -> ProfileArtifacts:
        """PRD/CRD profiles (+ underlying traces) for one grid cell.

        ``window_size`` (or the Session/builder default) routes the
        reuse-distance passes through the streaming layer: bit-identical
        profiles, scan memory bounded by the window and the lines seen,
        and the interleaved shared trace never materialized for the
        deterministic strategies — ``artifacts.shared`` is ``None``.

        ``sampled`` overrides the builder's sampling rate for this cell
        (``None`` keeps the builder's mode); the cell cache keys embed
        the effective rate, so exact and sampled cells coexist.
        ``need_traces`` guarantees the mimicked traces are attached: cells
        served from the disk store arrive trace-less (only the histograms
        persist) and are rematerialized through the stage caches.
        """
        ws = self._resolve_window(window_size)
        builder = self._builder_for(sampled)
        rate = getattr(builder, "sampled", None)
        if self.cache_enabled:
            # id only: the trace is materialized lazily, so cells served
            # from memory or disk never build it
            tid, trace = self.identify(source), None
        else:
            tid, trace = self.load(source)
        key = (tid, line_size, cores, strategy, seed, ws, rate)
        if self.cache_enabled and key in self._profiles:
            self.stats.profile_hits += 1
            art = self._profiles[key]
            if need_traces and not art.has_traces:
                art = self._materialize_traces(
                    art, self._trace_of(tid, source))
                self._profiles[key] = art
            return art
        if self.cache_enabled and self.store is not None:
            from repro_torch.validate.store import (
                builder_fingerprint,
                load_profile_artifacts,
            )

            with self._stage("store"):
                art = load_profile_artifacts(
                    self.store, tid, line_size, cores, strategy, seed, ws,
                    builder_fingerprint(builder),
                )
            if art is not None:
                self.stats.store_hits += 1
                if need_traces:
                    art = self._materialize_traces(
                        art, self._trace_of(tid, source))
                self._profiles[key] = art
                return art
        if trace is None:
            trace = self._trace_of(tid, source)
        binned = bool(getattr(builder, "binned", False))
        if ws:
            art = self._streaming_artifacts(
                tid, trace, cores, strategy, seed, line_size, ws, builder
            )
        elif cores == 1:
            with self._stage("reuse_profile"):
                if rate is not None:
                    # sampled cells bypass the exact-rd cache: the
                    # builder hash-filters the trace itself
                    prof = builder.profile(trace, line_size)
                else:
                    rds = self._reuse_distances(tid, trace, line_size)
                    if hasattr(builder, "profile_of_distances"):
                        prof = builder.profile_of_distances(rds)
                    else:
                        prof = profile_from_distances(rds)
            art = ProfileArtifacts(
                trace_id=tid, cores=1, strategy=strategy, seed=seed,
                line_size=line_size, privates=[trace], shared=trace,
                prd=prof, crd=prof, binned=binned, sampled=rate,
            )
        else:
            privs = self._private_traces(tid, trace, cores)
            shared = self._shared_trace(tid, privs, cores, strategy, seed)
            # PRD of the master core (cores are symmetric by construction)
            with self._stage("reuse_profile"):
                prd = builder.profile(privs[0], line_size)
                crd = builder.profile(shared, line_size)
            art = ProfileArtifacts(
                trace_id=tid, cores=cores, strategy=strategy, seed=seed,
                line_size=line_size, privates=privs, shared=shared,
                prd=prd, crd=crd, binned=binned, sampled=rate,
            )
        self.stats.profile_builds += 1
        if self.cache_enabled:
            self._profiles[key] = art
            if self.store is not None:
                from repro_torch.validate.store import (
                    builder_fingerprint,
                    save_profile_artifacts,
                )

                with self._stage("store"):
                    save_profile_artifacts(
                        self.store, art, builder_fingerprint(builder))
                self.stats.store_puts += 1
        return art

    def _materialize_traces(self, art: ProfileArtifacts,
                            trace: LabeledTrace) -> ProfileArtifacts:
        """Re-attach mimicked traces to a store-loaded (trace-less)
        profile cell through the stage caches; the profile passes are
        not rerun.  Streaming cells keep ``shared=None``."""
        if art.cores == 1:
            return dataclasses.replace(art, privates=[trace], shared=trace)
        privs = self._private_traces(art.trace_id, trace, art.cores)
        shared = art.shared
        if shared is None and not art.window_size:
            shared = self._shared_trace(
                art.trace_id, privs, art.cores, art.strategy, art.seed)
        return dataclasses.replace(art, privates=privs, shared=shared)

    def _streaming_artifacts(self, tid, trace, cores, strategy, seed,
                             line_size, ws, builder) -> ProfileArtifacts:
        """Window-bounded cell build.

        Uses the builder's streaming hooks when present (the default
        ``MimicProfileBuilder`` provides them); a custom builder without
        them falls back to its own in-memory stages.  The streaming
        interleave runs inside the shared profile's reuse pass, so its
        time counts under ``stage_seconds["reuse_profile"]``.
        """
        self.stats.streaming_builds += 1
        binned = bool(getattr(builder, "binned", False))
        rate = getattr(builder, "sampled", None)
        if hasattr(builder, "profile_windows"):
            def stream_profile(t, line):
                return builder.profile_windows(t, line, ws)
        else:  # custom builder without streaming hooks: its own stages
            def stream_profile(t, line):
                return builder.profile(t, line)
        if cores == 1:
            with self._stage("reuse_profile"):
                prof = stream_profile(trace, line_size)
            return ProfileArtifacts(
                trace_id=tid, cores=1, strategy=strategy, seed=seed,
                line_size=line_size, privates=[trace], shared=trace,
                prd=prof, crd=prof, window_size=ws, binned=binned,
                sampled=rate,
            )
        privs = self._private_traces(tid, trace, cores)
        if (
            strategy in ("round_robin", "chunked")
            and hasattr(builder, "shared_profile")
        ):
            with self._stage("reuse_profile"):
                prd = stream_profile(privs[0], line_size)
                crd, shared = builder.shared_profile(
                    privs, strategy, seed, line_size, ws
                )
        else:
            # uniform (or a builder without streaming hooks) needs the
            # materialized interleave: go through the Session cache so
            # it is built once across line sizes/targets
            shared = self._shared_trace(tid, privs, cores, strategy, seed)
            with self._stage("reuse_profile"):
                prd = stream_profile(privs[0], line_size)
                crd = stream_profile(shared, line_size)
        return ProfileArtifacts(
            trace_id=tid, cores=cores, strategy=strategy, seed=seed,
            line_size=line_size, privates=privs, shared=shared,
            prd=prd, crd=crd, window_size=ws, binned=binned,
            sampled=rate,
        )

    # --- execution --------------------------------------------------------

    def predict(self, source, request: PredictionRequest) -> PredictionSet:
        """Execute the full grid; hit rates evaluated in one batched
        call when the cache model supports grids."""
        return self.predict_many([(source, request)])[0]

    def predict_many(
        self, items: list[tuple[object, PredictionRequest]]
    ) -> list[PredictionSet]:
        """Execute many independent (source, request) pairs with ONE
        cache-model grid evaluation across all of them; results come
        back in input order, bit-identical to ``[predict(s, r) for s, r
        in items]``."""
        need_traces = bool(getattr(self.cache_model, "needs_traces", False))
        plans = []
        flat: list[tuple[object, ProfileArtifacts]] = []
        for source, request in items:
            tid = self.identify(source)
            cells = list(request.cells())
            if not cells:
                raise ValueError(
                    f"request matched no grid cells: {request.describe()}"
                )
            arts = [
                self.artifacts(
                    source, cell.cores, strategy=cell.strategy,
                    seed=request.seed,
                    line_size=cell.target.levels[0].line_size,
                    window_size=request.window_size,
                    sampled=request.sampled_rate,
                    need_traces=need_traces,
                )
                for cell in cells
            ]
            plans.append((tid, request, cells, arts))
            flat.extend((cell.target, art) for cell, art in zip(cells, arts))

        from repro_torch.api import batched

        shapes_before = batched.shape_count()
        with self._stage("cache_model"):
            if hasattr(self.cache_model, "hit_rates_grid"):
                rate_dicts = self.cache_model.hit_rates_grid(flat)
            else:
                rate_dicts = [
                    self.cache_model.hit_rates(t, a) for t, a in flat
                ]
        self.stats.kernel_shapes += batched.shape_count() - shapes_before

        out: list[PredictionSet] = []
        offset = 0
        with self._stage("runtime_model"):
            for tid, request, cells, arts in plans:
                rates_slice = rate_dicts[offset:offset + len(cells)]
                offset += len(cells)
                out.append(
                    self._assemble(tid, request, cells, arts, rates_slice)
                )
        return out

    def _assemble(self, tid, request, cells, arts, rate_dicts
                  ) -> PredictionSet:
        predictions = []
        for cell, art, rates in zip(cells, arts, rate_dicts):
            timing = {}
            rt = None
            if request.counts is not None:
                # precedence: per-request named model > the Session's
                # injected stage > the target's default
                if request.runtime_model is not None:
                    rt = resolve_runtime_model(
                        request.runtime_model, cell.target
                    )
                else:
                    rt = self.runtime_model or default_runtime_model(
                        cell.target
                    )
                timing = rt.runtime(
                    cell.target, rates, request.counts, cell.cores,
                    mode=cell.mode, gap_bytes=request.gap_bytes,
                )
            predictions.append(
                CellPrediction(
                    target=cell.target.name,
                    cores=cell.cores,
                    strategy=cell.strategy,
                    mode=cell.mode,
                    hit_rates=rates,
                    t_pred_s=timing.get("t_pred_s"),
                    t_mem_s=timing.get("t_mem_s"),
                    t_cpu_s=timing.get("t_cpu_s"),
                    runtime_model=getattr(rt, "name", None) if rt else None,
                    private_profile=art.prd if request.keep_profiles else None,
                    shared_profile=art.crd if request.keep_profiles else None,
                )
            )
        return PredictionSet(
            predictions,
            cache_model=getattr(self.cache_model, "name", "custom"),
            trace_id=tid,
        )

    # --- single-cell conveniences ----------------------------------------

    def hit_rates(self, source, target, cores: int, *,
                  strategy: str = "round_robin", seed: int = 0
                  ) -> dict[str, float]:
        target = resolve_target(target)
        art = self.artifacts(
            source, cores, strategy=strategy, seed=seed,
            line_size=target.levels[0].line_size,
        )
        return self.cache_model.hit_rates(target, art)

    def ground_truth_hit_rates(self, source, target, cores: int, *,
                               strategy: str = "round_robin", seed: int = 0
                               ) -> dict[str, float]:
        """Exact-LRU simulation through the same stage interface, on the
        Session's device.

        ExactLRU simulates the materialized traces, so this always
        builds in-memory artifacts (``window_size=0``) — it works on a
        streaming Session too, cached under the in-memory key.
        """
        target = resolve_target(target)
        art = self.artifacts(
            source, cores, strategy=strategy, seed=seed,
            line_size=target.levels[0].line_size, window_size=0,
            need_traces=True,
        )
        return ExactLRU(device=self.device).hit_rates(target, art)
