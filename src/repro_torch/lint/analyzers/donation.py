"""DN family: buffer donation at jitted call sites.  Port of
``repro/lint/analyzers/donation.py``, as is.

The repo's hot loops all follow the donated-carry pattern from
``core/reuse/batched.py``::

    run = _multi_scan_fn(cap, block)        # jit factory, donate_argnums=(0, 1)
    tree, last_slot, rds = run(tree, last_slot, starts)

DN201 flags the shape of that pattern *without* the donation: a call
to a known-jitted callable whose result rebinds one of its own
positional arguments (a carry), where that argument position is not in
``donate_argnums`` — XLA then keeps both the old and new buffer alive
per step.

DN202 flags the inverse hazard: an argument that *is* donated being
read again after the call without first being rebound (donated buffers
are invalidated).  The scan is linear within the enclosing statement
block; reads on loop back-edges are out of scope (documented in
docs/lint.md).
"""
from __future__ import annotations

import ast

from repro_torch.lint.analyzers._ast_utils import (
    collect_jit_callables,
    dotted,
    scan_imports,
)
from repro_torch.lint.engine import Finding, ModuleContext


def _blocks(tree: ast.Module):
    """Yield every statement list in the module (function bodies, loop
    bodies, branches...)."""
    for node in ast.walk(tree):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(node, field, None)
            if isinstance(stmts, list) and stmts \
                    and isinstance(stmts[0], ast.stmt):
                yield stmts


def _names_read(node: ast.AST) -> set[str]:
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            d = dotted(sub)
            if d:
                out.add(d)
    return out


def _names_bound(stmt: ast.stmt) -> set[str]:
    out = set()
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.For):
        targets = [stmt.target]
    for t in targets:
        for sub in ast.walk(t):
            d = dotted(sub)
            if d:
                out.add(d)
    return out


def analyze(ctx: ModuleContext) -> list[Finding]:
    imp = scan_imports(ctx.tree)
    if not imp.has_jax:
        return []
    callables = collect_jit_callables(ctx.tree, imp)
    findings: list[Finding] = []

    for stmts in _blocks(ctx.tree):
        for idx, stmt in enumerate(stmts):
            if not (isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Call)):
                continue
            call = stmt.value
            d = dotted(call.func)
            info = callables.get(d) if d else None
            if info is None or info.unknown or info.is_factory:
                # a factory call builds the jitted callable; its own
                # arguments (cap, block) are static config, not buffers
                continue
            rebound = set()
            for t in stmt.targets:
                for sub in ast.walk(t):
                    td = dotted(sub)
                    if td:
                        rebound.add(td)
            donated_args: list[tuple[int, str]] = []
            for i, arg in enumerate(call.args):
                ad = dotted(arg)
                if ad is None:
                    continue
                if i in info.donate_argnums:
                    donated_args.append((i, ad))
                elif ad in rebound:
                    findings.append(ctx.finding(
                        "DN201", call,
                        f"`{ad}` is a carry of jitted `{d}` (argument "
                        f"{i} rebound from the result) but the jit "
                        f"wrapper does not donate it — add "
                        f"donate_argnums=({i},)"))
            # DN202: donated buffer read after the call before rebinding
            for i, ad in donated_args:
                if ad in rebound:
                    continue
                for later in stmts[idx + 1:]:
                    if ad in _names_read(later) \
                            and ad not in _names_bound(later):
                        findings.append(ctx.finding(
                            "DN202", later,
                            f"`{ad}` was donated to jitted `{d}` "
                            f"(argument {i}) and is read again here — "
                            f"donated buffers are invalidated by XLA"))
                        break
                    if ad in _names_bound(later):
                        break
    return findings
