"""repro_torch.validate — disk-backed artifacts + the paper-validation
harness (port of ``repro.validate``).

Three pieces:

* :class:`~repro_torch.validate.store.ArtifactStore` — the disk-backed
  artifact store under the reference's ``v4/{kind}/{key}`` layout, so
  one directory serves both packages; ``Session(artifact_dir=...)``
  layers it under its in-memory caches;
* :func:`~repro_torch.validate.runner.run_validation` — the paper-matrix
  runner (workloads × Table-5 CPUs × core counts × interleave
  strategies) on the card, with store-mediated shard merging;
* :func:`~repro_torch.validate.report.generate_report` — renders the
  merged summary against the paper's reference claims
  (``repro_torch.validate.reference``).

CLI::

    PYTHONPATH=src python -m repro_torch.validate --smoke \\
        --artifact-dir <dir>                   # double-run gate
    PYTHONPATH=src python -m repro_torch.validate --report <report.md>
"""
from repro_torch.validate.reference import (
    PAPER_ARCH_CLAIMS,
    PAPER_OVERALL,
    PAPER_TABLE4,
    PaperClaim,
    paper_claim,
)
from repro_torch.validate.report import generate_report, render_markdown
from repro_torch.validate.runner import (
    MatrixSpec,
    run_validation,
    run_workload,
    save_results,
)
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
    "MatrixSpec",
    "PAPER_ARCH_CLAIMS",
    "PAPER_OVERALL",
    "PAPER_TABLE4",
    "PaperClaim",
    "STORE_VERSION",
    "StoreStats",
    "artifact_key",
    "builder_fingerprint",
    "generate_report",
    "load_profile_artifacts",
    "paper_claim",
    "render_markdown",
    "run_validation",
    "run_workload",
    "save_profile_artifacts",
    "save_results",
]
