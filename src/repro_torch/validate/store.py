"""Disk-backed, content-hash-keyed artifact store — port of
``repro/validate/store.py``, on the same files.

The Session's in-memory caches die with the process.  The
:class:`ArtifactStore` persists the expensive derived artifacts —
PRD/CRD reuse profiles (npz) and exact-LRU baselines, validation
results, workload metadata and explore results (json) — under a
directory keyed by

    v{STORE_VERSION}/{kind}/{content-hash-derived key}.{npz|json}

so repeated sweeps are incremental across processes and runs.  The
layout, the version, the kinds, the keys and the payloads are the
reference's, so one directory serves both packages: a cell that either
package wrote reads in the other.  Binned profile cells are the
exception by design: the port's binned builder stamps its keys with a
fingerprint of its own (``MimicProfileBuilder.store_fingerprint``),
because its log2 bins follow the documented rule where the reference's
do not (ROADMAP queue C, C2 and C4).

Durability rules:

* **Atomic writes** — payloads are serialized to a temp file in the
  destination directory and ``os.replace``d into place, so readers
  never observe a partially-written artifact.
* **Corruption tolerance** — a truncated or undecodable file reads as
  a miss (counted in ``stats.corrupt``) and is deleted; the caller
  recomputes and rewrites it.
* **Concurrent same-key safety** — every writer stages under its own
  mkstemp name, and the corrupt-file cleanup re-checks the file's stat
  identity before unlinking so it cannot delete a cell a concurrent
  writer just healed.
* **Version-stamped keys** — every key lives under ``v{version}``;
  bumping :data:`STORE_VERSION` (a format/semantics change) orphans
  old entries instead of misreading them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile
from pathlib import Path

import numpy as np

# Bump when the on-disk payload format or the meaning of a key changes:
# old entries become unreachable (they live under the old version dir).
# v2: profile cells carry a ``binned`` meta flag (device-binned log2
# profiles from the fused kernels/reuse_hist path share the namespace
# with exact cells, disambiguated by builder fingerprint + this flag).
# v3: trace ids of registry-resolved workloads are declared
# fingerprints (repro.workloads.registry) rather than content hashes,
# and the ``workload`` kind records per-fingerprint metadata (recorded
# trace_content_id cross-check, refs, model-trace op counts).
# v4: profile cells may be SHARDS-sampled (core.reuse.sampled): meta
# gains the ``sampled`` rate and per-profile ``prd_error_bound`` /
# ``crd_error_bound``, and sampled builders stamp their keys with
# ``+sampled{rate}`` — exact, binned, and sampled cells of one
# workload can never be confused in a shared store.
# v4 (unversioned addition): the ``explore`` kind persists
# config-sweep search results (repro.explore) — best config, top-k,
# round-by-round trajectory — keyed by explore_key(); purely additive,
# so existing stores stay readable.
STORE_VERSION = 4

_KINDS = ("profile", "exact", "validation", "workload", "explore")


def atomic_write(target: Path, write_fn) -> None:
    """Write via a same-directory temp file + fsync + ``os.replace`` —
    readers never observe a partial payload, a crashed writer leaves
    no temp file, and concurrent writers each use a private name."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=target.parent, prefix=f".{target.name}.", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as fh:
            write_fn(fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_bytes(target: str | Path, blob: bytes) -> None:
    atomic_write(Path(target), lambda fh: fh.write(blob))


@dataclasses.dataclass
class StoreStats:
    """Observable store behaviour (asserted by tests and the runner)."""

    hits: int = 0
    misses: int = 0
    puts: int = 0
    corrupt: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class ArtifactStore:
    """Filesystem key-value store for npz and json artifact payloads.

    Keys are plain strings (callers derive them from trace content
    hashes plus grid coordinates); kinds namespace the payload type.
    One store may be shared by any number of Sessions and processes —
    writes are atomic and last-writer-wins (all writers produce the
    same bytes for a given key, by construction of the keys).
    """

    def __init__(self, root: str | Path, *, version: int = STORE_VERSION):
        self.root = Path(root)
        self.version = int(version)
        self.stats = StoreStats()

    # --- paths ------------------------------------------------------------

    def _dir(self, kind: str) -> Path:
        return self.root / f"v{self.version}" / kind

    def path(self, kind: str, key: str, ext: str) -> Path:
        return self._dir(kind) / f"{key}.{ext}"

    def keys(self, kind: str) -> list[str]:
        d = self._dir(kind)
        if not d.is_dir():
            return []
        return sorted(p.stem for p in d.iterdir() if p.is_file())

    def _drop_corrupt(self, path: Path, seen: os.stat_result | None) -> None:
        """Clear a corrupt payload — unless a concurrent writer already
        replaced it.

        Between this reader's failed decode and its unlink, another
        service worker may have healed the cell with a complete
        rewrite; unconditionally unlinking would delete the *good*
        file.  Comparing the pre-read stat identity (inode, mtime,
        size) to the current one detects the swap.  The residual
        stat-to-unlink window is benign: deleting a healed file can
        only cost a recompute, never serve bad data.
        """
        self.stats.corrupt += 1
        try:
            if seen is not None:
                cur = path.stat()
                if ((cur.st_ino, cur.st_mtime_ns, cur.st_size)
                        != (seen.st_ino, seen.st_mtime_ns, seen.st_size)):
                    return  # healed since we read it — keep the new file
            path.unlink()
        except OSError:
            pass

    # --- npz payloads (numpy arrays + a json meta record) ------------------

    def put_arrays(
        self, kind: str, key: str,
        arrays: dict[str, np.ndarray], meta: dict | None = None,
    ) -> Path:
        """Persist named arrays plus a json-serializable ``meta`` dict
        as one atomic npz file."""
        target = self.path(kind, key, "npz")
        payload = dict(arrays)
        payload["__meta__"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8
        )
        atomic_write(target, lambda fh: np.savez(fh, **payload))
        self.stats.puts += 1
        return target

    def get_arrays(
        self, kind: str, key: str
    ) -> tuple[dict[str, np.ndarray], dict] | None:
        """Load (arrays, meta) for a key, or None on miss/corruption."""
        path = self.path(kind, key, "npz")
        try:
            seen = path.stat()  # pre-read identity, guards the heal race
        except OSError:
            self.stats.misses += 1
            return None
        try:
            with np.load(path) as data:
                arrays = {k: data[k] for k in data.files if k != "__meta__"}
                meta = json.loads(bytes(data["__meta__"]).decode())
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile, json.JSONDecodeError):
            # truncated/partial/undecodable file: treat as a miss and
            # clear it so the recompute's rewrite heals the store
            self._drop_corrupt(path, seen)
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return arrays, meta

    # --- json payloads -----------------------------------------------------

    def put_json(self, kind: str, key: str, obj) -> Path:
        target = self.path(kind, key, "json")
        blob = json.dumps(obj, indent=2, default=float).encode()
        atomic_write_bytes(target, blob)
        self.stats.puts += 1
        return target

    def get_json(self, kind: str, key: str):
        path = self.path(kind, key, "json")
        try:
            seen = path.stat()
        except OSError:
            self.stats.misses += 1
            return None
        try:
            obj = json.loads(path.read_text())
        except (OSError, ValueError, json.JSONDecodeError):
            self._drop_corrupt(path, seen)
            self.stats.misses += 1
            return None
        self.stats.hits += 1
        return obj


# --- ProfileArtifacts (de)serialization -------------------------------------
#
# The store persists the *profiles* of a grid cell (the expensive
# Fenwick-pass output), not the mimicked traces: traces are cheap O(N)
# rebuilds that Session materializes on demand (``need_traces``) for
# trace-consuming models like ExactLRU.


def builder_fingerprint(builder) -> str:
    """Identity of the profile builder that produced a cell.

    Different builders produce different profiles for the same grid
    coordinates, so the disk key must separate them (the in-memory
    cache is per-Session and never mixes builders).  A builder may
    override via a ``store_fingerprint`` attribute; the default is its
    qualified class name."""
    fp = getattr(builder, "store_fingerprint", None)
    if fp:
        return str(fp)
    cls = type(builder)
    return f"{cls.__module__}.{cls.__qualname__}".replace("/", "_")


#: The default builder's fingerprint — the reference's class name, which
#: the port's exact builder shares (``MimicProfileBuilder.STORE_NAME``):
#: its exact, streaming and sampled profiles are bit-identical.
DEFAULT_BUILDER_FP = "repro.api.stages.MimicProfileBuilder"


def artifact_key(tid: str, line_size: int, cores: int, strategy: str,
                 seed: int, window_size: int | None,
                 builder: str = DEFAULT_BUILDER_FP) -> str:
    """Stable store key for one profile cell — mirrors the Session's
    in-memory cache key, rooted in the trace content hash and stamped
    with the producing builder's identity."""
    return (
        f"{tid}-l{line_size}-c{cores}-{strategy}-s{seed}"
        f"-w{window_size or 0}-{builder}"
    )


def save_profile_artifacts(store: ArtifactStore, art,
                           builder: str = DEFAULT_BUILDER_FP) -> Path:
    """Persist one ProfileArtifacts cell (PRD/CRD histograms + cell
    coordinates).  The traces are intentionally not stored."""
    key = artifact_key(art.trace_id, art.line_size, art.cores,
                       art.strategy, art.seed, art.window_size, builder)
    return store.put_arrays(
        "profile", key,
        {
            "prd_distances": np.asarray(art.prd.distances, dtype=np.int64),
            "prd_counts": np.asarray(art.prd.counts, dtype=np.int64),
            "crd_distances": np.asarray(art.crd.distances, dtype=np.int64),
            "crd_counts": np.asarray(art.crd.counts, dtype=np.int64),
        },
        # "builder" is write-only provenance: the artifact key already
        # encodes the builder fingerprint, so the loader never needs it
        # back; it exists for humans inspecting the store directory.
        # repro-lint: disable=CK403 -- builder is write-only provenance
        {
            "trace_id": art.trace_id,
            "cores": art.cores,
            "strategy": art.strategy,
            "seed": art.seed,
            "line_size": art.line_size,
            "window_size": art.window_size,
            "binned": bool(getattr(art, "binned", False)),
            "sampled": getattr(art, "sampled", None),
            "prd_error_bound": art.prd.error_bound,
            "crd_error_bound": art.crd.error_bound,
            "builder": builder,
        },
    )


def load_profile_artifacts(
    store: ArtifactStore, tid: str, line_size: int, cores: int,
    strategy: str, seed: int, window_size: int | None,
    builder: str = DEFAULT_BUILDER_FP,
):
    """Load one profile cell, or None.  The returned artifact carries
    no traces (``privates == []``, ``shared is None``); Session
    rematerializes them from the cached trace when a trace-consuming
    stage (ExactLRU ground truth) asks."""
    from repro_torch.api.stages import ProfileArtifacts
    from repro_torch.core.reuse.profile import ReuseProfile

    key = artifact_key(tid, line_size, cores, strategy, seed, window_size,
                       builder)
    found = store.get_arrays("profile", key)
    if found is None:
        return None
    arrays, meta = found

    def prof(prefix: str) -> ReuseProfile:
        counts = arrays[f"{prefix}_counts"].astype(np.int64)
        bound = meta.get(f"{prefix}_error_bound")
        return ReuseProfile(
            arrays[f"{prefix}_distances"].astype(np.int64),
            counts, int(counts.sum()),
            float(bound) if bound is not None else None,
        )

    sampled = meta.get("sampled")
    return ProfileArtifacts(
        trace_id=meta["trace_id"], cores=int(meta["cores"]),
        strategy=meta["strategy"], seed=int(meta["seed"]),
        line_size=int(meta["line_size"]), privates=[], shared=None,
        prd=prof("prd"), crd=prof("crd"),
        window_size=meta.get("window_size"),
        binned=bool(meta.get("binned", False)),
        sampled=float(sampled) if sampled is not None else None,
    )
