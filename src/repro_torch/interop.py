"""Build the port's objects from plain arrays and dicts.

The JAX package's artifacts — traces, reuse profiles, hardware tables
— are carried across as numpy arrays and plain dicts (this module
imports nothing of that package): a test hands the reference's own
profiles to the port's SDCM stage, so the two are compared on
identical inputs, independent of the upstream stages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.incore import ClassTiming, InCoreTimings
from repro_torch.core.levels import CacheLevelConfig
from repro_torch.core.reuse.profile import ReuseProfile
from repro_torch.core.trace.types import LabeledTrace
from repro_torch.hw.targets import CPUTarget, InstrTimings, TPUTarget


def trace_from_arrays(addresses, bb_ids, shared_mask, inst_ids=None,
                      bb_names=None) -> LabeledTrace:
    """A :class:`LabeledTrace` from its arrays (``inst_ids`` None =
    maximal runs of equal bb ids, as in the reference)."""
    return LabeledTrace(
        np.asarray(addresses), np.asarray(bb_ids), np.asarray(shared_mask),
        None if inst_ids is None else np.asarray(inst_ids),
        {int(k): str(v) for k, v in (bb_names or {}).items()},
    )


def profile_from_arrays(distances, counts, total=None) -> ReuseProfile:
    """A :class:`ReuseProfile` from its distinct distances and counts."""
    d = np.asarray(distances, dtype=np.int64)
    c = np.asarray(counts, dtype=np.int64)
    if d.shape != c.shape or d.ndim != 1:
        raise ValueError("distances and counts must be equal-length 1-D")
    if len(d) > 1 and not (np.diff(d) > 0).all():
        raise ValueError("distances must be sorted and distinct")
    total = int(c.sum()) if total is None else int(total)
    if total != int(c.sum()):
        raise ValueError(f"total {total} != counts.sum() {int(c.sum())}")
    return ReuseProfile(d, c, total)


def _level(spec: dict) -> CacheLevelConfig:
    """One cache level from ``{name, line_size, assoc}`` plus either
    ``size_bytes``, ``num_lines`` or ``sets``."""
    line, assoc = int(spec["line_size"]), int(spec["assoc"])
    if "size_bytes" in spec:
        size = int(spec["size_bytes"])
    elif "num_lines" in spec:
        size = int(spec["num_lines"]) * line
    elif "sets" in spec:
        size = int(spec["sets"]) * assoc * line
    else:
        raise ValueError(f"level {spec.get('name')!r} needs size_bytes, "
                         "num_lines or sets")
    return CacheLevelConfig(str(spec["name"]), size, line, assoc)


def target_from_fields(name: str, levels: list[dict], **fields):
    """A hardware target from plain fields.

    ``levels`` are dicts as :func:`_level` reads them; a CPU/GPU target
    (``freq_hz`` among ``fields``) also takes each level's
    ``latency_cy``/``beta_cy`` from its dict unless ``level_latency_cy``
    /``level_beta_cy`` are given, ``instr`` as a dict and ``incore`` as
    ``{class: {delta, beta, ports}}``.  Without ``freq_hz`` the fields
    are a TPU target's, whose one VMEM level must match ``levels``.
    """
    lvls = tuple(_level(s) for s in levels)
    if "freq_hz" not in fields:
        tpu = TPUTarget(name=name, **fields)
        if tpu.levels != lvls:
            raise ValueError(
                f"TPU target {name!r}: levels {lvls} disagree with the "
                f"VMEM fields {tpu.levels}"
            )
        return tpu
    f = dict(fields)
    if "level_latency_cy" not in f:
        f["level_latency_cy"] = tuple(float(s["latency_cy"]) for s in levels)
    if "level_beta_cy" not in f:
        f["level_beta_cy"] = tuple(float(s["beta_cy"]) for s in levels)
    f["level_latency_cy"] = tuple(f["level_latency_cy"])
    f["level_beta_cy"] = tuple(f["level_beta_cy"])
    instr = f.pop("instr")
    f["instr"] = instr if isinstance(instr, InstrTimings) else InstrTimings(**instr)
    incore = f.pop("incore", None)
    if isinstance(incore, dict):
        incore = InCoreTimings(**{
            cls: ClassTiming(**t) for cls, t in incore.items()
        })
    f["incore"] = incore
    return CPUTarget(name=name, levels=lvls, **f)
