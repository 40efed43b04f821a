"""Pluggable pipeline stages (paper Fig. 1) — port of
``repro/api/stages.py``.

    TraceSource   -> one labeled sequential trace (+ stable content id)
    ProfileBuilder-> PRD/CRD reuse profiles for (cores, strategy, seed)
    CacheModel    -> per-level hit rates from the profile artifacts
    RuntimeModel  -> T_pred from hit rates + op counts (Eq. 4-7, ECM,
                     or a roofline for accelerator targets)

Traces, Alg. 1 mimicry and Alg. 2 interleaving stay host numpy
(bit-identical to the reference); the reuse-distance pass and its
histogram run on the builder's device — exact (``torch.unique``),
binned (the hand-written reuse-histogram kernel) or SHARDS-sampled, in
memory or window by window; the batched SDCM runs the hand-written SDCM
kernel on the cache model's device, and the exact-LRU ground truth
(``ExactLRU``) simulates the mimicked traces on its own device.

Workload registry names (``polybench/atx``, bare Table-4 aliases such
as ``atx``, ``synthetic/stride``) are trace sources, and so are
``model/<arch>/{prefill,decode,train}`` names: a model step's ATen ops
recorded on the host (``workloads/model_trace.py``).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import ClassVar, Protocol, runtime_checkable

import numpy as np

from repro_torch.core import sdcm
from repro_torch.core.cachesim import simulate_hierarchy
from repro_torch.core.incore import ECMRuntimeModel, miss_fractions
from repro_torch.core.levels import CacheLevelConfig
from repro_torch.core.reuse.distance import (
    reuse_distance_windows_device,
    reuse_distances,
)
from repro_torch.core.reuse.profile import (
    ReuseProfile,
    profile_from_distances,
    profile_from_distances_incremental,
)
from repro_torch.core.reuse.sampled import (
    sampled_profile_windows,
    sampled_reuse_profile,
)
from repro_torch.core.runtime_model import OpCounts, predict_runtime_s
from repro_torch.core.trace.interleave import (
    interleave_traces,
    interleave_windows,
)
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.device import resolve_device
from repro_torch.hw.targets import resolve_target


# --- targets -----------------------------------------------------------------


@runtime_checkable
class Target(Protocol):
    """Anything with a cache hierarchy: CPUTarget and TPUTarget both
    satisfy this structurally."""

    name: str

    @property
    def levels(self) -> tuple[CacheLevelConfig, ...]: ...


def shared_level_index(target) -> int:
    return getattr(target, "shared_level", -1) % len(target.levels)


# --- trace sources -----------------------------------------------------------


@runtime_checkable
class TraceSource(Protocol):
    """Stage 1: produce the labeled sequential trace once."""

    def trace(self) -> LabeledTrace: ...


def trace_content_id(trace: LabeledTrace) -> str:
    """Stable content hash of a materialized trace (the reference's
    hash, so ids and cache keys agree across the two packages).
    Registry-resolved sources carry a declared fingerprint instead
    (``repro_torch.workloads.registry``), which the Session uses as
    their trace id."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(trace.addresses).tobytes())
    h.update(np.ascontiguousarray(trace.bb_ids).tobytes())
    h.update(np.ascontiguousarray(trace.shared_mask).tobytes())
    return h.hexdigest()[:16]


@dataclass
class ArrayTraceSource:
    """Wrap an in-memory trace as a TraceSource."""

    _trace: LabeledTrace
    name: str = "trace"

    def trace(self) -> LabeledTrace:
        return self._trace


def as_trace_source(obj) -> TraceSource:
    """Coerce a LabeledTrace / Workload / TraceSource / registry name
    (at its default sizes) uniformly."""
    if isinstance(obj, LabeledTrace):
        return ArrayTraceSource(obj)
    if isinstance(obj, str):
        from repro_torch.workloads import registry

        return registry.resolve(obj)
    if hasattr(obj, "trace") and callable(obj.trace):
        return obj  # Workload and any TraceSource qualify
    raise TypeError(f"cannot interpret {type(obj).__name__} as a TraceSource")


# --- profile artifacts -------------------------------------------------------


@dataclass
class ProfileArtifacts:
    """Everything derived from one (trace, cores, strategy, seed, line)
    cell — cached by Session so it is computed exactly once.

    ``shared`` is ``None`` when the cell was built through the streaming
    path (``window_size`` set) with a deterministic strategy: the
    interleaved trace is scanned window by window and never
    materialized.  Profile consumers (SDCM, batched SDCM) only read
    ``prd``/``crd``; trace consumers (ExactLRU) need the in-memory path.
    """

    trace_id: str
    cores: int
    strategy: str
    seed: int
    line_size: int
    privates: list[LabeledTrace]
    shared: LabeledTrace | None
    prd: ReuseProfile
    crd: ReuseProfile
    window_size: int | None = None
    # True when prd/crd are device-binned log2 profiles (the
    # kernels/reuse_hist path) rather than exact histograms
    binned: bool = False
    # sampling rate when prd/crd are SHARDS-sampled estimates
    # (core.reuse.sampled); the profiles then carry ``error_bound``
    sampled: float | None = None

    @property
    def has_traces(self) -> bool:
        """Whether the mimicked traces are attached (cells served from
        the disk store carry profiles only)."""
        return bool(self.privates)


class ProfileBuilder(Protocol):
    """Stage 2: trace -> mimicked traces -> PRD/CRD profiles."""

    def private_traces(
        self, trace: LabeledTrace, cores: int
    ) -> list[LabeledTrace]: ...

    def interleave(
        self, privates: list[LabeledTrace], strategy: str, seed: int
    ) -> LabeledTrace: ...

    def profile(self, trace: LabeledTrace, line_size: int) -> ReuseProfile: ...


class MimicProfileBuilder:
    """Default builder: Algorithm 1 + Algorithm 2 on the host, then the
    reuse-distance pass and its histogram on ``device`` (``None``
    resolves to the GPU, see :func:`repro_torch.device.resolve_device`).

    ``window_size`` is the builder's default window: a Session with no
    window of its own routes this builder's cells through the streaming
    layer (:meth:`profile_windows`, :meth:`shared_profile` — windowed
    reuse distances + incremental histogram accumulation): bit-identical
    profiles, peak memory bounded by the window and the lines seen
    instead of the trace length.  :meth:`profile` is always the
    in-memory pass, so the Session alone decides which path a cell
    takes.

    ``binned=True`` switches profile construction to the fused
    device-binned path (:mod:`repro_torch.core.reuse.fused`): the
    distance stream feeds the ``kernels/reuse_hist`` kernel on the
    device and the profile is log2-binned, with weighted-mean bin
    representatives.  SDCM hit rates from binned profiles track the
    exact ones to well under 1e-3 absolute.

    ``sampled=R`` (0 < R <= 1) switches to SHARDS-style spatially
    hashed sampled profiles (:mod:`repro_torch.core.reuse.sampled`):
    the kept lines' distances on the device, each profile carrying its
    declared ``error_bound``.  ``sampled`` and ``binned`` are mutually
    exclusive; ``R == 1.0`` reproduces the exact histograms bit for bit.
    """

    #: The disk-store identity of the default builder, shared with the
    #: JAX package's ``repro.api.stages.MimicProfileBuilder``: its exact,
    #: streaming and sampled profiles are bit-identical to the port's.
    STORE_NAME = "repro.api.stages.MimicProfileBuilder"
    #: The identity of the default builder's binned cells, the port's
    #: own: its log2 bins follow the documented rule at the points where
    #: the reference's do not (ROADMAP queue C, C2), so neither package
    #: is ever served the other's binned profile (C4).
    BINNED_STORE_NAME = "repro_torch.api.stages.MimicProfileBuilder"

    window_size: int | None = None  # class defaults: subclasses with
    binned: bool = False            # a bare __init__ still resolve them
    sampled: float | None = None
    sample_seed: int = 0            # spatial-hash key (fixed, so sampled
    # cells are deterministic and their keys stable)

    def __init__(self, device=None, window_size: int | None = None,
                 binned: bool = False, sampled: float | None = None):
        if sampled is not None:
            if binned:
                raise ValueError(
                    "binned and sampled are mutually exclusive profile "
                    "modes — pick one approximate representation"
                )
            if not (0.0 < float(sampled) <= 1.0):
                raise ValueError(
                    f"sampled rate must be in (0, 1], got {sampled!r}"
                )
            sampled = float(sampled)
        self.device = resolve_device(device)
        self.window_size = window_size
        self.binned = binned
        self.sampled = sampled

    @property
    def store_fingerprint(self) -> str:
        """Disk-store identity: binned/sampled cells must never be
        confused with exact cells (or with each other, or with another
        rate), so approximate builders stamp their keys.  Exact,
        streaming and sampled cells of the default builder keep the
        reference's keys; its binned cells take the port's own
        (:data:`BINNED_STORE_NAME`)."""
        if type(self) is MimicProfileBuilder:
            base = self.BINNED_STORE_NAME if self.binned else self.STORE_NAME
        else:
            base = f"{type(self).__module__}.{type(self).__qualname__}"
        if self.binned:
            base += "+binned"
        if self.sampled is not None:
            base += f"+sampled{self.sampled:g}"
            if self.sample_seed:
                base += f"@{self.sample_seed}"
        return base

    def with_sampled(self, rate: float | None) -> "MimicProfileBuilder":
        """Variant builder at another sampling rate (the Session's
        per-request ``sampled_rate`` overrides)."""
        if rate == self.sampled:
            return self
        return MimicProfileBuilder(
            self.device, window_size=self.window_size, sampled=rate
        )

    def private_traces(self, trace, cores):
        return gen_private_traces(trace, cores)

    def interleave(self, privates, strategy, seed):
        return interleave_traces(privates, strategy, seed=seed)

    def profile(self, trace, line_size):
        if self.sampled is not None:
            return sampled_reuse_profile(
                trace.addresses, line_size, rate=self.sampled,
                seed=self.sample_seed, device=self.device,
            )
        return self.profile_of_distances(
            reuse_distances(trace.addresses, line_size, device=self.device)
        )

    def profile_of_distances(self, rds) -> ReuseProfile:
        """Distances -> profile under the builder's histogram mode."""
        if self.binned:
            from repro_torch.core.reuse.fused import (
                binned_profile_from_distances,
            )

            return binned_profile_from_distances(rds, device=self.device)
        return profile_from_distances(rds)

    def profile_windows(
        self, source, line_size, window_size: int | None = None
    ) -> ReuseProfile:
        """Streaming profile of any window source (``LabeledTrace``,
        ``ChunkedTraceSource``, or an iterator of windows).
        ``window_size`` overrides the builder default for this call."""
        ws = window_size if window_size is not None else (self.window_size or 0)
        if ws < 1:
            raise ValueError("profile_windows needs window_size >= 1")
        if self.sampled is not None:
            return sampled_profile_windows(
                source, line_size, rate=self.sampled, seed=self.sample_seed,
                window_size=ws, device=self.device,
            )
        if self.binned:
            from repro_torch.core.reuse.fused import binned_profile_windows

            return binned_profile_windows(
                source, line_size, window_size=ws, device=self.device
            )
        return profile_from_distances_incremental(
            reuse_distance_windows_device(
                source, line_size, window_size=ws, device=self.device
            )
        )

    def shared_profile(
        self, privates, strategy: str, seed: int, line_size: int,
        window_size: int | None = None,
    ) -> tuple[ReuseProfile, LabeledTrace | None]:
        """CRD profile of the interleaved trace.

        Streaming mode merges per-core windows and scans them directly
        — the shared trace is never concatenated (returned trace is
        ``None``).  The ``uniform`` strategy needs the global random
        choice sequence, so it interleaves in memory first and streams
        only the reuse-distance pass.
        """
        ws = window_size if window_size is not None else self.window_size
        if ws and strategy in ("round_robin", "chunked"):
            wins = interleave_windows(
                privates, strategy, window_size=ws, seed=seed
            )
            return self.profile_windows(wins, line_size, ws), None
        shared = self.interleave(privates, strategy, seed)
        if ws:
            return self.profile_windows(shared, line_size, ws), shared
        return self.profile(shared, line_size), shared


# --- cache models ------------------------------------------------------------


class CacheModel(Protocol):
    """Stage 3: per-level cumulative hit rates for one target."""

    name: str

    def hit_rates(self, target, artifacts: ProfileArtifacts) -> dict[str, float]: ...


@dataclass
class AnalyticalSDCM:
    """Brehob–Enbody SDCM (paper Eq. 1–3) over the PRD/CRD profiles.

    ``backend="numpy"`` evaluates each level with the float64 oracle
    (bit-identical to the reference's numpy backend);
    ``backend="batched"`` folds the whole (target x level x cores) grid
    into one SDCM kernel launch per row shape on ``device`` (``None``
    resolves to the GPU; a Session binds its own device).
    """

    backend: str = "numpy"
    device: object = None
    name: str = field(default="sdcm", init=False)

    def __post_init__(self):
        if self.backend not in ("numpy", "batched"):
            raise ValueError(f"unknown SDCM backend: {self.backend}")

    def hit_rates(self, target, artifacts: ProfileArtifacts) -> dict[str, float]:
        (out,) = self.hit_rates_grid([(target, artifacts)])
        return out

    def hit_rates_grid(
        self, items: list[tuple[object, ProfileArtifacts]]
    ) -> list[dict[str, float]]:
        """Evaluate many (target, artifacts) cells."""
        if self.backend == "batched":
            from repro_torch.api.batched import batched_hit_rates

            return batched_hit_rates(items, device=resolve_device(self.device))
        out = []
        for target, art in items:
            shared_idx = shared_level_index(target)
            rates = {}
            for i, lvl in enumerate(target.levels):
                prof = art.crd if i >= shared_idx else art.prd
                rates[lvl.name] = sdcm.hit_rate(
                    prof, lvl.effective_assoc, lvl.num_lines
                )
            out.append(rates)
        return out


@dataclass
class ExactLRU:
    """Ground-truth stage-3 model: exact set-associative LRU simulation
    of the same mimicked traces (the paper's PAPI stand-in, §4.1), on
    ``device`` (``None`` resolves to the GPU; a Session binds its own).
    Same interface as the analytical model, so benchmarks swap it in.

    Private levels aggregate per-core simulations (every core runs its
    own hierarchy).  Shared levels follow the paper's Table-6
    convention — the interleaved trace through one inclusive hierarchy,
    mirroring the CRD profile the SDCM path consumes.
    """

    device: object = None
    name: str = field(default="exact-lru", init=False)
    # tells Session.predict to hand over artifacts with their traces
    needs_traces: ClassVar[bool] = True

    def hit_rates(self, target, artifacts: ProfileArtifacts) -> dict[str, float]:
        dev = resolve_device(self.device)
        shared_idx = shared_level_index(target)
        levels = list(target.levels)
        if not artifacts.has_traces:
            raise ValueError(
                "ExactLRU simulates the materialized traces, but this "
                "artifact carries only profiles (loaded from the disk "
                "store) — request it with need_traces=True"
            )
        if artifacts.cores == 1:
            res = simulate_hierarchy(
                artifacts.privates[0].addresses, levels, device=dev)
            return {r.name: r.cumulative_hit_rate for r in res}
        if artifacts.shared is None:
            raise ValueError(
                "ExactLRU simulates the materialized traces; streaming "
                "artifacts (window_size set) keep no shared trace — use "
                "an in-memory Session for ground truth"
            )
        out: dict[str, float] = {}
        # private levels: every core runs its own hierarchy; the Table-6
        # cumulative metric aggregates misses over ALL cores' accesses
        priv_levels = levels[:shared_idx]
        if priv_levels:
            total = sum(len(p) for p in artifacts.privates)
            misses = np.zeros(len(priv_levels), dtype=np.int64)
            for priv in artifacts.privates:
                for i, r in enumerate(simulate_hierarchy(
                        priv.addresses, priv_levels, device=dev)):
                    misses[i] += r.accesses - r.hits
            for i, lvl in enumerate(priv_levels):
                out[lvl.name] = 1.0 - misses[i] / max(total, 1)
        res_shared = simulate_hierarchy(
            artifacts.shared.addresses, levels, device=dev)
        for r, lvl in zip(res_shared, levels):
            out.setdefault(lvl.name, r.cumulative_hit_rate)
        return out


# --- runtime models ----------------------------------------------------------


class RuntimeModel(Protocol):
    """Stage 4: hit rates + op counts -> seconds."""

    def runtime(
        self,
        target,
        hit_rates: dict[str, float],
        counts: OpCounts,
        cores: int,
        *,
        mode: str = "throughput",
        gap_bytes: float = 0.0,
    ) -> dict[str, float]: ...


class EqRuntimeModel:
    """Paper Eq. 4–7 (T_mem latency/throughput chain + two-mode T_CPU)."""

    name = "eq"

    def runtime(self, target, hit_rates, counts, cores, *,
                mode="throughput", gap_bytes=0.0):
        ordered = [hit_rates[l.name] for l in target.levels]
        return predict_runtime_s(
            target, ordered, counts, cores, mode=mode, gap_bytes=gap_bytes
        )


def roofline_peak_flops(target) -> float:
    """Peak FLOP rate: the accelerator's declared peak, else the CPU's
    fully-issued FP pipes (freq / aggregate β_fp)."""
    peak = getattr(target, "peak_flops_bf16", None)
    if peak is not None:
        return peak
    return target.freq_hz / target.instr.beta_fp


def roofline_mem_bandwidth(target) -> float:
    """Sustained memory bandwidth (bytes/s): the accelerator's HBM
    figure, else the word-per-β_RAM stream of the Eq. 7 chain."""
    bw = getattr(target, "hbm_bandwidth", None)
    if bw is not None:
        return bw
    return target.word_bytes / (target.ram_beta_cy * target.cycle_s)


def roofline_miss_latency_s(target) -> float:
    """One un-hidden round trip to backing memory: the accelerator's
    declared on-chip latency, else the RAM latency of the Eq. 6 chain."""
    lat = getattr(target, "vmem_latency_s", None)
    if lat is not None:
        return lat
    return target.ram_latency_cy * target.cycle_s


class RooflineRuntimeModel:
    """Bandwidth/peak-FLOPs stage 4: on-chip hits are ~free, the
    traffic missing every cache level streams from backing memory at
    the target's sustained bandwidth; compute at the peak FLOP rate.
    ``mode`` picks the combiner: throughput-bound overlap (max) vs a
    serialized latency chain (sum).

    The accelerator reading (VMEM + HBM on the TPU) is unchanged; CPU
    and GPU targets reuse the same two-term model with peaks derived
    from their Eq. 4–7 parameters, which is what makes it the crude
    baseline the ECM model is gated against (``--runtime-gate``).
    """

    name = "roofline"

    def runtime(self, target, hit_rates, counts, cores, *,
                mode="throughput", gap_bytes=0.0):
        share = counts.scaled(1.0 / max(cores, 1))
        # levels are read by name, never dict order; a missing key is a
        # model-wiring bug — fail loudly like the Eq. 4-7 model does,
        # don't degrade to an all-miss estimate
        ordered = [hit_rates[lvl.name] for lvl in target.levels]
        miss_bytes = miss_fractions(ordered)[-1] * share.total_bytes
        t_mem = miss_bytes / roofline_mem_bandwidth(target)
        if miss_bytes > 0.0:  # no misses -> no memory round-trip to hide
            t_mem += roofline_miss_latency_s(target)
        t_cpu = share.fp_ops / roofline_peak_flops(target)
        t_pred = max(t_mem, t_cpu) if mode == "throughput" else t_mem + t_cpu
        return {"t_pred_s": t_pred, "t_mem_s": t_mem, "t_cpu_s": t_cpu}


def default_runtime_model(target) -> RuntimeModel:
    """CPU targets carry Eq. 4–7 instruction timings; targets exposing
    bandwidth/FLOP peaks instead get the roofline combiner."""
    if hasattr(target, "instr"):
        return EqRuntimeModel()
    return RooflineRuntimeModel()


#: Stage-4 registry: every runtime model addressable by name through
#: ``PredictionRequest(runtime_model=...)`` and the service's
#: ``/predict`` payload.  "auto" keeps the per-target default.
RUNTIME_MODELS: dict[str, type] = {
    "eq": EqRuntimeModel,
    "roofline": RooflineRuntimeModel,
    "ecm": ECMRuntimeModel,
}

RUNTIME_MODEL_NAMES = ("auto",) + tuple(RUNTIME_MODELS)


def supported_runtime_models(target) -> tuple[str, ...]:
    """Which named stage-4 models can run on ``target``.

    * ``eq`` needs the aggregate Eq. 4–7 ``instr`` timings;
    * ``ecm`` needs per-class ``incore`` tables (or ``instr`` to derive
      a 1-port fallback table) plus the per-level β chain;
    * ``roofline`` runs everywhere — peaks are declared (TPU) or
      derived from the Eq. 4–7 parameters (CPUs/GPU).
    """
    target = resolve_target(target)
    names = []
    if hasattr(target, "instr"):
        names.append("eq")
    if getattr(target, "incore", None) is not None or hasattr(target, "instr"):
        names.append("ecm")
    names.append("roofline")
    return tuple(names)


def resolve_runtime_model(name, target=None) -> RuntimeModel:
    """Instantiate a stage-4 model by registry name.

    ``None``/``"auto"`` defer to :func:`default_runtime_model` (which
    needs ``target``).  A named model is validated against the target's
    capabilities so an unsupported pairing fails at request-build time,
    not deep inside a grid evaluation.
    """
    if name is None or name == "auto":
        if target is None:
            raise ValueError("runtime model 'auto' needs a target")
        return default_runtime_model(resolve_target(target))
    try:
        cls = RUNTIME_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown runtime model {name!r}; known: "
            f"{sorted(RUNTIME_MODEL_NAMES)}"
        ) from None
    if target is not None:
        target = resolve_target(target)
        if name not in supported_runtime_models(target):
            raise ValueError(
                f"target {target.name!r} does not support runtime model "
                f"{name!r} (supported: {supported_runtime_models(target)})"
            )
    return cls()
