"""``model/<arch>/<step>`` workloads: model-derived labeled traces — port
of ``repro/workloads/model_trace.py`` with the port's own graph source.

``ModelTraceSource`` records one model step (prefill, decode or train
of a ``configs/`` architecture at its reduced smoke shape) with
:mod:`repro_torch.analysis.aten_trace`: the ATen ops of the family's
plain-path ``prefill``/``decode_step``, or of its ``loss_fn`` and the
loss's gradient (the reference lowers ``jax.value_and_grad``), on the
host, with weights from seed 0, turned into the granule-labeled memory trace (the step's inputs
= weights, batch and caches = shared across mimicked cores), the
Byfl-style ``OpCounts`` of the runtime model (``hlo_cost.op_class_mix``
over the op census) and the largest op results for provenance.  The
reference lowers the same step with XLA and reads the HLO text; the two
programs are not the same (XLA fuses and, on ``xla:cpu``, legalizes
bf16 to f32; its layer scan reuses one loop body's buffers), so the
traces are held to per-cell bounds, not bit identity
(``tests/test_torch_model_trace.py``).

Everything derived from a recording is persisted in the ArtifactStore's
``workload`` kind keyed by the declared fingerprint: a warm store
answers ``op_counts`` and ``info`` without recording, and the Session
only materializes the trace on a profile-store miss.

A recording is deterministic for a fixed (torch, config, shape, seed):
buffers are named and placed in first-seen order, so the same cell gives
bit-identical traces across processes, which is what lets a *declared*
fingerprint stand in for the trace content hash.  The fingerprint folds
in ``torch.__version__`` and :data:`GRAPH_SOURCE` where the reference
folds in ``jax.__version__``, so the port's model cells are keyed apart
from the reference's (ROADMAP C8).
"""
from __future__ import annotations

import threading
import time

# Bump when recording or trace extraction changes trace content for the
# same (arch, step) — declared fingerprints hash this.  "2" as in the
# reference: op_counts carry the per-class op_class_mix.
MODEL_TRACE_VERSION = "2"

#: The graph source's stamp in the fingerprint: ATen ops recorded by a
#: dispatch mode on the CPU plain path (``analysis/aten_trace.py``).
GRAPH_SOURCE = "aten-dispatch-cpu-plain/1"

STEPS = ("prefill", "decode", "train")

# Trace granule and per-buffer reference cap — the reference's values.
# The reference's ``LOOP_CAP`` has no counterpart: the recorded program
# has no loop left to cap (Python loops are unrolled).
GRANULE = 512
REFS_CAP = 16

_META_INFO = ("touched_bytes", "loop_scale", "num_buffers", "num_blocks",
              "granule", "top_buffers")


def arch_slug(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


class ModelTraceSource:
    """TraceSource for one (arch, step) cell.

    Satisfies the stage-1 protocol (``trace()``) plus the registry's
    declared-source extensions (``workload_name`` /
    ``declared_fingerprint`` attrs set by ``resolve()``,
    ``attach_store`` for warm-path metadata).  ``timings`` holds the
    seconds of the recording (``record_s``) and trace build
    (``trace_s``).  One lock makes the build happen once when service
    threads ask for the trace and the counts together.
    """

    def __init__(self, arch_id: str, step: str):
        if step not in STEPS:
            raise ValueError(f"unknown model step {step!r} (one of {STEPS})")
        self.arch_id = arch_id
        self.step = step
        self.workload_name = f"model/{arch_slug(arch_id)}/{step}"
        self.declared_fingerprint: str | None = None
        self.timings: dict[str, float] = {}
        self._store = None
        self._trace = None
        self._op_counts = None
        self._info: dict | None = None
        self._lock = threading.Lock()

    # --- registry/store integration ---------------------------------------

    def attach_store(self, store) -> None:
        self._store = store

    def _store_meta(self) -> dict | None:
        if self._store is None or not self.declared_fingerprint:
            return None
        return self._store.get_json("workload", self.declared_fingerprint)

    def _put_store_meta(self, meta: dict) -> None:
        if self._store is None or not self.declared_fingerprint:
            return
        merged = dict(self._store_meta() or {})
        merged.update(meta)
        self._store.put_json("workload", self.declared_fingerprint, merged)

    # --- recording ---------------------------------------------------------

    def record(self):
        """The step's ATen recording (``aten_trace.record_model_step``)."""
        from repro_torch.analysis.aten_trace import record_model_step

        return record_model_step(self.arch_id, self.step)

    def _build(self) -> None:
        with self._lock:
            if self._trace is None:
                self._build_locked()

    def _build_locked(self) -> None:
        from repro_torch.analysis.aten_trace import (
            largest_results, recording_cost, recording_to_trace,
        )
        from repro_torch.analysis.hlo_cost import op_class_mix
        from repro_torch.core.runtime_model import OpCounts
        from repro_torch.workloads.tracegen import ELEM

        rec = self.record()
        t0 = time.perf_counter()
        trace, info = recording_to_trace(rec, granule=GRANULE,
                                         refs_cap=REFS_CAP)
        self.timings = {"record_s": rec.seconds,
                        "trace_s": time.perf_counter() - t0}
        # per-class mix (loads/stores split, addressing int ops,
        # transcendental -> div port), as the reference derives it
        self._op_counts = OpCounts(**op_class_mix(recording_cost(rec),
                                                  elem_bytes=ELEM))
        self._info = {
            "touched_bytes": info["touched_bytes"],
            "loop_scale": info["loop_scale"],
            "num_buffers": info["num_buffers"],
            "num_blocks": info["num_blocks"],
            "granule": GRANULE,
            "top_buffers": largest_results(rec, top=8),
        }
        self._trace = trace
        self._put_store_meta({
            "workload": self.workload_name,
            "arch": self.arch_id,
            "step": self.step,
            "refs": len(trace),
            "op_counts": vars(self._op_counts),
            **self._info,
        })

    # --- stage-1 protocol ---------------------------------------------------

    def trace(self):
        if self._trace is None:
            self._build()
        return self._trace

    @property
    def op_counts(self):
        """OpCounts for the runtime model; served from the store's
        workload meta when warm (no recording)."""
        if self._op_counts is None:
            meta = self._store_meta()
            if meta and "op_counts" in meta:
                from repro_torch.core.runtime_model import OpCounts

                self._op_counts = OpCounts(**meta["op_counts"])
            else:
                self._build()
        return self._op_counts

    @property
    def info(self) -> dict:
        if self._info is None:
            meta = self._store_meta()
            if meta and "touched_bytes" in meta:
                self._info = {k: meta.get(k) for k in _META_INFO}
            else:
                self._build()
        return self._info


def fingerprint_kwargs(arch_id: str, step: str) -> dict:
    """Everything that pins the trace bytes of a model cell."""
    import torch

    return {
        "arch": arch_id,
        "step": step,
        "granule": GRANULE,
        "refs_cap": REFS_CAP,
        "model_trace_version": MODEL_TRACE_VERSION,
        "torch": torch.__version__,
        "graph_source": GRAPH_SOURCE,
    }


def register_model_workloads(registry) -> None:
    """Register model/<slug>/<step> for every configured architecture.

    All size presets resolve to the reduced smoke shapes, so every
    preset shares one fingerprint and one artifact set per cell.  The
    raw arch id (``model/llama3-8b/decode``) stays routable as an alias
    wherever it differs from the slug.
    """
    from repro_torch.configs import list_archs
    from repro_torch.workloads.registry import WorkloadSpec

    for arch_id in list_archs():
        slug = arch_slug(arch_id)
        for step in STEPS:
            def build(sizes, _arch=arch_id, _step=step):
                return ModelTraceSource(_arch, _step)

            def size_kwargs(sizes, _arch=arch_id, _step=step):
                return fingerprint_kwargs(_arch, _step)

            aliases = ()
            if slug != arch_id:
                aliases = (f"model/{arch_id}/{step}",)
            registry.register(WorkloadSpec(
                name=f"model/{slug}/{step}",
                build=build,
                size_kwargs=size_kwargs,
                presets=("smoke", "validation", "validation-xl",
                         "validation-xxl"),
                aliases=aliases,
                version=MODEL_TRACE_VERSION,
                description=f"{arch_id} {step} step via ATen recording",
            ))
