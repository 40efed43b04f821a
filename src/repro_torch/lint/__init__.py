"""Project-specific static analysis — port of ``repro/lint``.

Stdlib ``ast`` only: the linter imports neither jax nor torch, and lints
both packages.  The reference's four families keep their rule ids,
severities, messages and fingerprints, so either linter reads the
other's baseline and one ``# repro-lint:`` comment serves both:

* **JP** (jax-purity) — no host syncs, traced control flow, or
  recompile hazards inside jit-reachable code.
* **DN** (donation) — carry buffers rebound through jitted calls must
  be donated; donated buffers must not be read after the call.
* **CC** (concurrency) — lock-guarded attributes stay under their
  lock, lock order is consistent, Futures always resolve.
* **CK** (cache-keys) — fingerprint inputs reach the key,
  ``STORE_VERSION`` namespaces the key path, save/load meta agree.

The port adds a fifth, JP's counterpart for torch code:

* **TS** (torch-sync) — no host sync of a device tensor, and no Python
  control flow on one, inside a loop (each pass stalls the host until
  the device catches up, and no CUDA graph can be captured).

Entry point: ``python -m repro_torch.lint``; programmatic use via
:func:`lint_paths`.
"""
from repro_torch.lint.engine import Finding, LintResult, ModuleContext, lint_paths
from repro_torch.lint.rules import RULES, Rule, rules_by_family

__all__ = [
    "Finding",
    "LintResult",
    "ModuleContext",
    "RULES",
    "Rule",
    "lint_paths",
    "rules_by_family",
]
