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
through the reuse-histogram kernel; the two combine.

Not ported yet (ROADMAP queue A), and raising ``NotImplementedError``:
``sampled=``, ``store=``/``artifact_dir=``, ``verify_fingerprints``,
and ``ground_truth_hit_rates`` (ExactLRU).
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
    MimicProfileBuilder,
    ProfileArtifacts,
    as_trace_source,
    default_runtime_model,
    not_in_slice,
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
    kernel_shapes: int = 0  # NEW SDCM launch shapes this session
    # (``repro_torch.api.batched``); a warm session re-running an
    # identical sweep leaves it unchanged.


class Session:
    """Cached executor for :class:`PredictionRequest` grids.

    Stages are injectable: pass a different ``cache_model`` or
    ``profile_builder`` and the same request produces an
    alternative-model grid.  ``cache=False`` disables artifact reuse.

    ``window_size`` and ``binned`` configure the default builder;
    ``binned=True`` with a builder of one's own needs that builder to
    be binned.  ``window_size=0`` (here or per request) forces the
    in-memory path.
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
        if sampled is not None:
            raise not_in_slice("sampled=", "sampled profiles")
        if store is not None or artifact_dir is not None:
            raise not_in_slice("store=/artifact_dir=", "store")
        if verify_fingerprints:
            raise not_in_slice("verify_fingerprints", "registry names")
        self.device = resolve_device(device)
        if profile_builder is None:
            profile_builder = MimicProfileBuilder(
                self.device, window_size=window_size, binned=binned
            )
        elif binned and not getattr(profile_builder, "binned", False):
            raise ValueError(
                "binned=True only configures the default builder; pass a "
                "builder with binned profile support instead"
            )
        self.builder = profile_builder
        self.window_size = window_size
        if isinstance(cache_model, str):
            # shorthand for the analytical backends ("batched"/"numpy")
            cache_model = AnalyticalSDCM(backend=cache_model)
        cache_model = cache_model or AnalyticalSDCM()
        if isinstance(cache_model, AnalyticalSDCM) and cache_model.device is None:
            cache_model = dataclasses.replace(cache_model, device=self.device)
        self.cache_model = cache_model
        self.runtime_model = runtime_model  # None -> per-target default
        self.cache_enabled = cache
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
        """Trace id of a source (its content hash)."""
        tid, _trace = self.load(source)
        return tid

    def load(self, source) -> tuple[str, LabeledTrace]:
        """Coerce + trace + id a source (cached).  With caching disabled
        the content hash is skipped (nothing is keyed on it)."""
        sid = id(source)  # the caller's object, not the coercion wrapper
        if self.cache_enabled and sid in self._trace_ids:
            tid = self._trace_ids[sid]
            return tid, self._traces[tid]
        with self._stage("trace"):
            trace = as_trace_source(source).trace()
        self.stats.trace_builds += 1
        if not self.cache_enabled:
            return "", trace
        tid = trace_content_id(trace)
        self._trace_ids[sid] = tid
        self._sources[sid] = source
        self._traces.setdefault(tid, trace)
        return tid, self._traces[tid]

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

    def artifacts(self, source, cores: int, *, strategy: str = "round_robin",
                  seed: int = 0, line_size: int = 64,
                  window_size: int | None = None,
                  sampled: float | None = None) -> ProfileArtifacts:
        """PRD/CRD profiles (+ underlying traces) for one grid cell.

        ``window_size`` (or the Session/builder default) routes the
        reuse-distance passes through the streaming layer: bit-identical
        profiles, scan memory bounded by the window and the lines seen,
        and the interleaved shared trace never materialized for the
        deterministic strategies — ``artifacts.shared`` is ``None``.
        """
        if sampled is not None:
            raise not_in_slice("sampled=", "sampled profiles")
        ws = self._resolve_window(window_size)
        tid, trace = self.load(source)
        key = (tid, line_size, cores, strategy, seed, ws)
        if self.cache_enabled and key in self._profiles:
            self.stats.profile_hits += 1
            return self._profiles[key]
        binned = bool(getattr(self.builder, "binned", False))
        if ws:
            art = self._streaming_artifacts(
                tid, trace, cores, strategy, seed, line_size, ws
            )
        elif cores == 1:
            with self._stage("reuse_profile"):
                rds = self._reuse_distances(tid, trace, line_size)
                if hasattr(self.builder, "profile_of_distances"):
                    prof = self.builder.profile_of_distances(rds)
                else:
                    prof = profile_from_distances(rds)
            art = ProfileArtifacts(
                trace_id=tid, cores=1, strategy=strategy, seed=seed,
                line_size=line_size, privates=[trace], shared=trace,
                prd=prof, crd=prof, binned=binned,
            )
        else:
            privs = self._private_traces(tid, trace, cores)
            shared = self._shared_trace(tid, privs, cores, strategy, seed)
            # PRD of the master core (cores are symmetric by construction)
            with self._stage("reuse_profile"):
                prd = self.builder.profile(privs[0], line_size)
                crd = self.builder.profile(shared, line_size)
            art = ProfileArtifacts(
                trace_id=tid, cores=cores, strategy=strategy, seed=seed,
                line_size=line_size, privates=privs, shared=shared,
                prd=prd, crd=crd, binned=binned,
            )
        self.stats.profile_builds += 1
        if self.cache_enabled:
            self._profiles[key] = art
        return art

    def _streaming_artifacts(self, tid, trace, cores, strategy, seed,
                             line_size, ws) -> ProfileArtifacts:
        """Window-bounded cell build.

        Uses the builder's streaming hooks when present (the default
        ``MimicProfileBuilder`` provides them); a custom builder without
        them falls back to its own in-memory stages.  The streaming
        interleave runs inside the shared profile's reuse pass, so its
        time counts under ``stage_seconds["reuse_profile"]``.
        """
        self.stats.streaming_builds += 1
        builder = self.builder
        binned = bool(getattr(builder, "binned", False))
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
        raise not_in_slice("ground_truth_hit_rates", "ExactLRU/cachesim")
