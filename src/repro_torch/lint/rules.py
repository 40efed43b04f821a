"""Rule catalogue for ``repro_torch.lint`` — port of
``repro/lint/rules.py``.

Every rule has a stable ID (family prefix + number), a severity, a
one-line summary, and a fix hint.  The catalogue is the single source
of truth: analyzers import their rules from here, and suppression
comments / baseline entries reference rules by ID.  The JP, DN, CC and
CK rules are the reference's, word for word (``docs/lint.md`` documents
them); the TS rules are the port's own and are documented in the
README's port section.

Families:

* ``JP`` — jax-purity: host syncs, Python control flow on traced
  values, and recompile hazards inside jit-reachable code.
* ``DN`` — donation: rebound jit carries without ``donate_argnums``
  and use-after-donation at call sites.
* ``CC`` — concurrency: lock-guarded attribute discipline, lock
  acquisition order, and Future resolution paths.
* ``CK`` — cache-key invariants: fingerprint/key field coverage,
  ``STORE_VERSION`` in the key path, and save/load meta symmetry.
* ``TS`` — torch-sync: host syncs of device tensors and Python control
  flow on them inside loops of torch code.
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Rule:
    """One checkable invariant: stable ID, severity, summary, fix hint."""

    id: str
    name: str
    severity: str
    summary: str
    fix_hint: str


RULES: dict[str, Rule] = {}


def _rule(rule_id: str, name: str, severity: str, summary: str,
          fix_hint: str) -> Rule:
    if severity not in SEVERITIES:
        raise ValueError(f"unknown severity {severity!r} for {rule_id}")
    if rule_id in RULES:
        raise ValueError(f"duplicate rule id {rule_id}")
    r = Rule(rule_id, name, severity, summary, fix_hint)
    RULES[rule_id] = r
    return r


# --- JP: jax purity ----------------------------------------------------------

JP101 = _rule(
    "JP101", "jit-print", "error",
    "print() inside jit-reachable code (runs at trace time only, or "
    "not at all on later calls)",
    "use jax.debug.print(...) for traced values, or move the print "
    "outside the jitted function",
)
JP102 = _rule(
    "JP102", "jit-host-sync", "error",
    "host synchronization of a traced value inside jit-reachable code "
    "(float()/int()/bool()/.item()/.tolist() force a device round-trip "
    "or fail under tracing)",
    "keep the computation in jnp (jnp.where / lax.cond), or hoist the "
    "conversion out of the jitted function",
)
JP103 = _rule(
    "JP103", "jit-numpy-on-traced", "error",
    "numpy call applied to a traced value inside jit-reachable code "
    "(np.* materializes the tracer on host)",
    "use the jnp equivalent, or move the numpy post-processing outside "
    "the jitted function",
)
JP110 = _rule(
    "JP110", "jit-traced-control-flow", "error",
    "Python if/while/for/assert conditioned on a traced value inside "
    "jit-reachable code (TracerBoolConversionError at trace time)",
    "use jnp.where / jax.lax.cond / jax.lax.while_loop; comparisons "
    "against Python config values and `x is None` checks are fine",
)
JP120 = _rule(
    "JP120", "jit-in-loop", "error",
    "jax.jit(...) constructed inside a loop body (a fresh jitted "
    "callable recompiles on every iteration)",
    "hoist the jit() call out of the loop, or cache the jitted "
    "callable (module level / functools.lru_cache factory)",
)
JP121 = _rule(
    "JP121", "jit-data-length-static", "warning",
    "static jit argument derived from a data length (len()/.shape/"
    ".size) at the call site — one XLA compilation per distinct length",
    "pad or bucket the length to powers of two before passing it "
    "static (see repro.api.batched._row_shape_key)",
)

# --- DN: donation ------------------------------------------------------------

DN201 = _rule(
    "DN201", "undonated-carry", "warning",
    "jitted call rebinds an argument from its own result (a carry) but "
    "the jit wrapper does not donate that argument's buffer",
    "add donate_argnums=(<pos>,) to the jax.jit wrapper so XLA reuses "
    "the carry buffer in place (see core/reuse/batched.py)",
)
DN202 = _rule(
    "DN202", "use-after-donation", "error",
    "a donated argument is read again after the jitted call (donated "
    "buffers are invalidated by XLA)",
    "rebind the variable from the call result, or stop donating the "
    "argument",
)

# --- CC: concurrency ---------------------------------------------------------

CC301 = _rule(
    "CC301", "unlocked-guarded-attr", "error",
    "attribute is written under a lock elsewhere in this class but "
    "accessed outside it here (torn reads / lost updates)",
    "wrap the access in the same `with self.<lock>:` block (writes in "
    "__init__ happen-before publication and are exempt)",
)
CC302 = _rule(
    "CC302", "lock-order", "error",
    "locks are acquired in different orders by different methods of "
    "one class (deadlock risk)",
    "pick one global acquisition order for the class and restructure "
    "the method that violates it",
)
CC303 = _rule(
    "CC303", "unresolved-future", "warning",
    "a locally created Future has a code path that neither resolves "
    "(set_result/set_exception/cancel) nor hands it off (return / "
    "store / pass to a call)",
    "resolve or cancel the future on every path — a stranded future "
    "hangs its waiter forever",
)

# --- CK: cache-key invariants ------------------------------------------------

CK401 = _rule(
    "CK401", "key-field-unused", "error",
    "a fingerprint/key function reads a parameter or attribute that "
    "never flows into the returned key (two distinct inputs would "
    "collide on one cache entry)",
    "interpolate the field into the key, or add it to the analyzer's "
    "exclusion table with a justification",
)
CK402 = _rule(
    "CK402", "store-version-not-in-key-path", "error",
    "the module defines STORE_VERSION but the on-disk key path does "
    "not interpolate a version component (a format bump would misread "
    "old entries instead of orphaning them)",
    "namespace every key under f\"v{version}\" and default the store "
    "version to STORE_VERSION",
)
CK403 = _rule(
    "CK403", "meta-field-asymmetry", "error",
    "a save_*/load_* pair disagrees on the persisted meta fields "
    "(a field written but never restored, or read but never written)",
    "read the field in load_* (or drop it from save_*); genuinely "
    "write-only provenance fields need a justified suppression",
)

# --- TS: torch sync ----------------------------------------------------------

TS102 = _rule(
    "TS102", "loop-host-sync", "error",
    "host synchronization of a device tensor inside a loop (.item()/"
    ".tolist()/.cpu()/.numpy()/.to(\"cpu\"), int()/float()/bool(), "
    "np.* or print of a tensor, ops whose output size is read back: "
    "unique/nonzero/bincount/masked_select and boolean-mask indexing; "
    "each stalls the host on every pass and breaks CUDA graph capture)",
    "keep the value on the device (torch.where, masks, preallocated "
    "outputs), or read it back once after the loop",
)
TS103 = _rule(
    "TS103", "loop-host-to-device-copy", "error",
    "host-to-device copy inside a loop (.to(device)/.cuda() of host "
    "data, torch.tensor/as_tensor(..., device=...): a copy from pageable "
    "memory synchronizes the host on every pass)",
    "move the data to the device once before the loop, or stage it in "
    "pinned memory and copy with non_blocking=True",
)
TS110 = _rule(
    "TS110", "loop-tensor-control-flow", "error",
    "Python if/while/assert conditioned on a device tensor inside a loop "
    "(bool() of the tensor syncs on every pass)",
    "branch on the device (torch.where / masking) or on host values "
    "(shapes, config, `x is None`); read a flag back once after the loop",
)


def rules_by_family() -> dict[str, list[Rule]]:
    fams: dict[str, list[Rule]] = {}
    for r in RULES.values():
        fams.setdefault(r.id[:2], []).append(r)
    return {k: sorted(v, key=lambda r: r.id) for k, v in sorted(fams.items())}
