"""repro_torch.validate — the disk-backed artifact store (port of
``repro.validate.store``).

:class:`~repro_torch.validate.store.ArtifactStore` keeps profiles and
results on disk under the reference's ``v4/{kind}/{key}`` layout, so one
directory serves both packages; ``Session(artifact_dir=...)`` layers it
under its in-memory caches.  The validation runner, its report and the
paper's reference claims are not ported yet (ROADMAP queue A, A-10).
"""
from repro_torch.validate.store import (
    STORE_VERSION,
    ArtifactStore,
    StoreStats,
    artifact_key,
    builder_fingerprint,
    load_profile_artifacts,
    save_profile_artifacts,
)

__all__ = [
    "ArtifactStore",
    "STORE_VERSION",
    "StoreStats",
    "artifact_key",
    "builder_fingerprint",
    "load_profile_artifacts",
    "save_profile_artifacts",
]
