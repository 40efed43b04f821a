"""PPT tasklist ingestion (paper Fig. 7) — port of
``repro/core/tasklist.py``; the JSON is byte-identical to the
reference's, so either package reads the other's files.

The PPT Simian PDES model consumes a *tasklist*: per parallel section,
the instruction-class counts (divided by core count), memory footprint
and the reuse profiles.  The same shape is kept as a plain
JSON-serializable record so predictions can be driven from files the
way PPT drives Simian.
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from repro_torch.core.reuse.profile import ReuseProfile, profile_from_pairs
from repro_torch.core.runtime_model import OpCounts


@dataclass
class Task:
    name: str
    num_cores: int
    counts: OpCounts
    block_bytes: float
    private_profile: ReuseProfile
    shared_profile: ReuseProfile

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "num_cores": self.num_cores,
            # Fig. 7 divides ALU op counts by the core count when
            # emitting the tasklist; raw totals plus the core count are
            # stored and divided at evaluation time (lossless).
            "iALU": self.counts.int_ops,
            "fALU": self.counts.fp_ops,
            "fDIV": self.counts.div_ops,
            "loads": self.counts.loads,
            "stores": self.counts.stores,
            "total_bytes": self.counts.total_bytes,
            "block_bytes": self.block_bytes,
            "private_profile": _profile_to_lists(self.private_profile),
            "shared_profile": _profile_to_lists(self.shared_profile),
        }

    @staticmethod
    def from_dict(d: dict) -> "Task":
        return Task(
            name=d["name"],
            num_cores=int(d["num_cores"]),
            counts=OpCounts(
                int_ops=d["iALU"],
                fp_ops=d["fALU"],
                div_ops=d["fDIV"],
                loads=d["loads"],
                stores=d["stores"],
                total_bytes=d["total_bytes"],
            ),
            block_bytes=d["block_bytes"],
            private_profile=_profile_from_lists(d["private_profile"]),
            shared_profile=_profile_from_lists(d["shared_profile"]),
        )


def _profile_to_lists(p: ReuseProfile) -> dict:
    return {
        "distances": [int(x) for x in p.distances],
        "counts": [int(x) for x in p.counts],
    }


def _profile_from_lists(d: dict) -> ReuseProfile:
    return profile_from_pairs(
        np.asarray(d["distances"], dtype=np.int64),
        np.asarray(d["counts"], dtype=np.int64),
    )


def save_tasklist(tasks: list[Task], path: str) -> None:
    with open(path, "w") as f:
        json.dump([t.to_dict() for t in tasks], f)


def load_tasklist(path: str) -> list[Task]:
    with open(path) as f:
        return [Task.from_dict(d) for d in json.load(f)]
