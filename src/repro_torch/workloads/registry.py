"""First-class workload registry — port of
``repro/workloads/registry.py``, the stage-1 fan-in.

Every trace source registers here under a namespaced name:

    polybench/<abbr>      Table-4 analytic generators (polybench.py)
    synthetic/<kind>      tracegen-built parametric access patterns

and a resolved workload carries a **declared fingerprint** — a stable
content key computed from (name, generator version, resolved size
kwargs) without building the trace, the reference's key for the same
workload.  The Session uses it as the trace id.  Every polybench entry
aliases its bare Table-4 abbreviation (``"atx"`` -> ``polybench/atx``).

``model/<arch>/<step>`` names (HLO-derived model-step traces in the
reference) raise ``NotImplementedError``: they need a graph source of
the port's own (ROADMAP queue A, A-11).
"""
from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass
from typing import Callable

# Bump when a generator's trace content changes for the same resolved
# kwargs — declared fingerprints are only honest while (name, version,
# kwargs) pins the trace bytes.  Kept in step with the reference.
GENERATOR_VERSION = "1"


@dataclass(frozen=True)
class WorkloadSpec:
    """One registry entry: how to name, fingerprint, and build a source.

    ``build(sizes)`` returns the trace source (anything ``Session``
    accepts); ``size_kwargs(sizes)`` returns the canonical kwargs that
    preset resolves to — the fingerprint hashes those, so two presets
    resolving to the same kwargs share one fingerprint.
    """

    name: str
    build: Callable[[str | None], object]
    size_kwargs: Callable[[str | None], dict]
    presets: tuple[str, ...] = ()
    aliases: tuple[str, ...] = ()
    version: str = GENERATOR_VERSION
    description: str = ""

    @property
    def namespace(self) -> str:
        return self.name.split("/", 1)[0]

    def fingerprint(self, sizes: str | None) -> str:
        blob = json.dumps(
            {"name": self.name, "version": self.version,
             "kwargs": self.size_kwargs(sizes)},
            sort_keys=True, default=str,
        )
        return hashlib.sha1(blob.encode()).hexdigest()[:16]


class WorkloadRegistry:
    """Name -> WorkloadSpec map with alias routing (dict reads; callers
    that resolve concurrently lock their own caches)."""

    def __init__(self):
        self._specs: dict[str, WorkloadSpec] = {}
        self._aliases: dict[str, str] = {}

    def register(self, spec: WorkloadSpec) -> WorkloadSpec:
        if "/" not in spec.name:
            raise ValueError(
                f"workload name {spec.name!r} must be namespaced "
                "(<namespace>/<name>)"
            )
        if spec.name in self._specs or spec.name in self._aliases:
            raise ValueError(f"workload {spec.name!r} already registered")
        for alias in spec.aliases:
            taken = self._aliases.get(alias)
            if (alias in self._specs) or (taken and taken != spec.name):
                raise ValueError(
                    f"alias {alias!r} for {spec.name!r} already taken"
                )
        self._specs[spec.name] = spec
        for alias in spec.aliases:
            self._aliases[alias] = spec.name
        return spec

    def canonical(self, name: str) -> str:
        """Canonical registry name for ``name`` (which may be an alias);
        KeyError with the roster if unknown."""
        if name in self._specs:
            return name
        if name in self._aliases:
            return self._aliases[name]
        if name.startswith("model/"):
            from repro_torch.api.stages import not_in_slice

            raise not_in_slice(f"model workload {name!r}", "A-11")
        raise KeyError(
            f"unknown workload {name!r} (choose from {self.names()} "
            f"or a legacy alias {sorted(self._aliases)})"
        )

    def spec(self, name: str) -> WorkloadSpec:
        return self._specs[self.canonical(name)]

    def names(self, namespace: str | None = None) -> list[str]:
        out = sorted(self._specs)
        if namespace:
            out = [n for n in out if n.startswith(namespace + "/")]
        return out

    def aliases(self) -> dict[str, str]:
        return dict(self._aliases)

    def resolve(self, name: str, sizes: str | None = None, *,
                store=None):
        """Build one workload source with its declared fingerprint set;
        ``sizes`` is one of the spec's presets (None for defaults).
        ``store`` is forwarded to sources that cache derived metadata on
        disk (an ``attach_store`` method); no source of the port has one
        yet."""
        spec = self.spec(name)
        if sizes is not None and sizes not in spec.presets:
            raise ValueError(
                f"unknown size preset {sizes!r} for {spec.name!r} "
                f"(choose from {sorted(spec.presets)} or omit for "
                "defaults)"
            )
        source = spec.build(sizes)
        source.workload_name = spec.name
        source.declared_fingerprint = spec.fingerprint(sizes)
        if store is not None and hasattr(source, "attach_store"):
            source.attach_store(store)
        return source


REGISTRY = WorkloadRegistry()

_POPULATED = False


_POPULATE_LOCK = threading.RLock()


def _ensure_populated() -> None:
    """Import the registering modules once (idempotent).  Under the lock
    a thread that arrives while another populates waits for the whole
    roster instead of finding it half registered; the lock is re-entrant
    because the imports below may come back here."""
    global _POPULATED
    with _POPULATE_LOCK:
        if _POPULATED:
            return
        _POPULATED = True
        from repro_torch.workloads import polybench  # noqa: F401  registers on import

        _register_synthetics(REGISTRY)


def register(spec: WorkloadSpec) -> WorkloadSpec:
    return REGISTRY.register(spec)


def resolve(name: str, sizes: str | None = None, *, store=None):
    _ensure_populated()
    return REGISTRY.resolve(name, sizes, store=store)


def canonical_name(name: str) -> str:
    _ensure_populated()
    return REGISTRY.canonical(name)


def workload_names(namespace: str | None = None) -> list[str]:
    _ensure_populated()
    return REGISTRY.names(namespace)


def workload_aliases() -> dict[str, str]:
    _ensure_populated()
    return REGISTRY.aliases()


def declared_fingerprint(name: str, sizes: str | None = None) -> str:
    """Fingerprint without building the source at all."""
    _ensure_populated()
    return REGISTRY.spec(name).fingerprint(sizes)


# --- synthetic namespace -----------------------------------------------------
#
# Parametric tracegen patterns: the reference inputs for cache-model
# sanity checks (a stream has no reuse inside the footprint; a
# stride-loop has exact periodic reuse).  They share the polybench
# preset names so matrix specs can mix namespaces.

_SYNTH_SIZES = {
    "stream": {None: dict(elems=8192, passes=2),
               "validation-xxl": dict(elems=524288, passes=2),
               "validation-xl": dict(elems=65536, passes=2),
               "validation": dict(elems=4096, passes=2),
               "smoke": dict(elems=1024, passes=2)},
    "stride": {None: dict(elems=4096, stride=8, passes=4),
               "validation-xxl": dict(elems=262144, stride=8, passes=4),
               "validation-xl": dict(elems=32768, stride=8, passes=4),
               "validation": dict(elems=2048, stride=8, passes=4),
               "smoke": dict(elems=512, stride=8, passes=4)},
}


def _make_synthetic(kind: str, **kw):
    import numpy as np

    from repro_torch.core.runtime_model import OpCounts
    from repro_torch.workloads.polybench import ELEM, Workload
    from repro_torch.workloads.tracegen import AddressSpace, TraceBuilder

    elems, passes = kw["elems"], kw["passes"]
    sp = AddressSpace()
    A = sp.array("A", elems)

    def build():
        tb = TraceBuilder()
        if kind == "stream":
            idx = np.arange(elems)
        else:
            stride = kw["stride"]
            idx = (np.arange(elems) * stride) % elems
        for _ in range(passes):
            for lo in range(0, elems, 64):
                tb.instance(f"synth.{kind}", [(A.addr(idx[lo:lo + 64]), True)])
        return tb.build()

    n = elems * passes
    counts = OpCounts(fp_ops=n, int_ops=n, loads=n, total_bytes=n * ELEM)
    return Workload(f"SYNTH-{kind.upper()}", kind, "Synthetic", build, counts)


def _register_synthetics(registry: WorkloadRegistry) -> None:
    for kind, presets in _SYNTH_SIZES.items():
        def build(sizes, _kind=kind, _presets=presets):
            return _make_synthetic(_kind, **_presets.get(sizes, _presets[None]))

        def size_kwargs(sizes, _kind=kind, _presets=presets):
            return dict(_presets.get(sizes, _presets[None]), kind=_kind)

        registry.register(WorkloadSpec(
            name=f"synthetic/{kind}",
            build=build,
            size_kwargs=size_kwargs,
            presets=("smoke", "validation", "validation-xl",
                     "validation-xxl"),
            description=f"tracegen {kind} pattern",
        ))
