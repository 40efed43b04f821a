"""CC family: lock discipline and Future hygiene.  Port of
``repro/lint/analyzers/concurrency.py``, as is.

Written for the patterns in ``src/repro/service/`` (MicroBatcher,
PredictionService, WorkloadResolver) and ``src/repro/validate/store.py``.

CC301 — per class, an attribute becomes *lock-guarded* the moment any
method writes it inside ``with self.<lock>:``; every later access of
that attribute outside a lock block in a non-``__init__`` method is a
torn read / lost update.  ``__init__`` writes are exempt (publication
happens-before), and methods whose name contains ``locked`` are
treated as called-with-lock-held helpers.

CC302 — nested ``with self.A: ... with self.B:`` acquisitions define a
per-class order; two methods disagreeing on the order of the same pair
is a classic deadlock.

CC303 — a locally constructed ``Future`` must be resolved
(``set_result``/``set_exception``/``cancel``) or handed off (returned,
stored, passed to a call) on every path; a path that strands it hangs
the waiter forever.
"""
from __future__ import annotations

import ast

from repro_torch.lint.analyzers._ast_utils import dotted, scan_imports
from repro_torch.lint.engine import Finding, ModuleContext

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}
_RESOLVE_METHODS = {"set_result", "set_exception", "cancel"}


def _is_lock_ctor(call: ast.AST, imp) -> bool:
    if not isinstance(call, ast.Call):
        return False
    d = dotted(call.func)
    if d is None:
        return False
    parts = d.split(".")
    return parts[-1] in _LOCK_CTORS and (
        len(parts) == 1 or parts[0] in imp.threading_aliases)


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` (or the base attr of ``self.X.y``) → ``X``."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def _with_lock_attrs(stmt: ast.With) -> list[str]:
    out = []
    for item in stmt.items:
        ctx_expr = item.context_expr
        attr = _self_attr(ctx_expr)
        if attr is not None:
            out.append(attr)
    return out


class _ClassInfo:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.locks: set[str] = set()
        self.guarded: set[str] = set()
        # attr -> node of the first guarded write (for the message)
        self.guard_site: dict[str, str] = {}


def _methods(cls: ast.ClassDef):
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt


def _scan_class(cls: ast.ClassDef, imp) -> _ClassInfo:
    info = _ClassInfo(cls)
    for meth in _methods(cls):
        for sub in ast.walk(meth):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    attr = _self_attr(t)
                    if attr and _is_lock_ctor(sub.value, imp):
                        info.locks.add(attr)
            elif isinstance(sub, ast.With):
                for attr in _with_lock_attrs(sub):
                    info.locks.add(attr)
    for meth in _methods(cls):
        _collect_guarded(meth, meth.body, info, in_lock=False,
                         method=meth.name)
    return info


def _stores_in(node: ast.AST) -> list[str]:
    """self-attrs written by this statement (assign / augassign /
    write-through like ``self.stats.shed += 1`` counts for ``stats``)."""
    out = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    else:
        return out
    for t in targets:
        attr = _self_attr(t)
        if attr:
            out.append(attr)
    return out


def _collect_guarded(meth, stmts, info: _ClassInfo, in_lock: bool,
                     method: str) -> None:
    for stmt in stmts:
        is_lock_with = isinstance(stmt, ast.With) and any(
            a in info.locks for a in _with_lock_attrs(stmt))
        if in_lock or is_lock_with:
            for sub in ast.walk(stmt):
                for attr in _stores_in(sub):
                    if attr not in info.locks:
                        info.guarded.add(attr)
                        info.guard_site.setdefault(attr, method)
        for field in ("body", "orelse", "finalbody"):
            inner = getattr(stmt, field, None)
            if isinstance(inner, list) and inner \
                    and isinstance(inner[0], ast.stmt):
                _collect_guarded(meth, inner, info,
                                 in_lock or is_lock_with, method)
        for h in getattr(stmt, "handlers", []) or []:
            _collect_guarded(meth, h.body, info, in_lock or is_lock_with,
                             method)


def _flag_unlocked(ctx: ModuleContext, info: _ClassInfo,
                   findings: list[Finding]) -> None:
    for meth in _methods(info.node):
        if meth.name == "__init__" or "locked" in meth.name:
            continue
        _walk_accesses(ctx, meth, meth.body, info, in_lock=False,
                       findings=findings, seen=set())


def _walk_accesses(ctx, meth, stmts, info: _ClassInfo, in_lock: bool,
                   findings: list[Finding], seen: set) -> None:
    for stmt in stmts:
        is_lock_with = isinstance(stmt, ast.With) and any(
            a in info.locks for a in _with_lock_attrs(stmt))
        inner_blocks = []
        for field in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, field, None)
            if isinstance(blk, list) and blk \
                    and isinstance(blk[0], ast.stmt):
                inner_blocks.append(blk)
        for h in getattr(stmt, "handlers", []) or []:
            inner_blocks.append(h.body)
        if not (in_lock or is_lock_with):
            # examine only this statement's own expressions, not the
            # nested blocks (they are walked recursively below)
            for sub in _shallow_walk(stmt):
                attr = _self_attr(sub) if isinstance(
                    sub, (ast.Attribute, ast.Subscript)) else None
                if attr in info.guarded:
                    key = (meth.name, stmt.lineno, attr)
                    if key not in seen:
                        seen.add(key)
                        findings.append(ctx.finding(
                            "CC301", sub,
                            f"`self.{attr}` is lock-guarded (written "
                            f"under a lock in "
                            f"{info.guard_site.get(attr, 'another method')}"
                            f"()) but accessed here outside the lock"))
        for blk in inner_blocks:
            _walk_accesses(ctx, meth, blk, info,
                           in_lock or is_lock_with, findings, seen)


def _shallow_walk(stmt: ast.stmt):
    """Walk a statement's expressions without descending into nested
    statement blocks (those carry their own lock context)."""
    stack: list[ast.AST] = []
    for field, value in ast.iter_fields(stmt):
        if field in ("body", "orelse", "finalbody", "handlers"):
            continue
        if isinstance(value, ast.AST):
            stack.append(value)
        elif isinstance(value, list):
            stack.extend(v for v in value if isinstance(v, ast.AST))
    while stack:
        node = stack.pop()
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _lock_order_pairs(meth, stmts, info: _ClassInfo,
                      held: tuple[str, ...]) -> list[tuple[str, str, ast.With]]:
    pairs = []
    for stmt in stmts:
        new_held = held
        if isinstance(stmt, ast.With):
            acquired = [a for a in _with_lock_attrs(stmt)
                        if a in info.locks]
            for a in acquired:
                for h in new_held:
                    pairs.append((h, a, stmt))
                new_held = new_held + (a,)
        for field in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, field, None)
            if isinstance(blk, list) and blk \
                    and isinstance(blk[0], ast.stmt):
                pairs.extend(_lock_order_pairs(meth, blk, info, new_held))
        for h in getattr(stmt, "handlers", []) or []:
            pairs.extend(_lock_order_pairs(meth, h.body, info, new_held))
    return pairs


def _flag_lock_order(ctx, info: _ClassInfo,
                     findings: list[Finding]) -> None:
    seen_order: dict[tuple[str, str], str] = {}
    for meth in _methods(info.node):
        for a, b, site in _lock_order_pairs(meth, meth.body, info, ()):
            if (b, a) in seen_order:
                findings.append(ctx.finding(
                    "CC302", site,
                    f"locks `{a}` then `{b}` acquired here, but "
                    f"{seen_order[(b, a)]}() acquires `{b}` then `{a}` "
                    f"— inconsistent order risks deadlock"))
            else:
                seen_order.setdefault((a, b), meth.name)


# -- CC303: stranded futures --------------------------------------------------

def _is_future_ctor(call: ast.AST, imp) -> bool:
    if not isinstance(call, ast.Call):
        return False
    d = dotted(call.func)
    if d is None:
        return False
    if d in imp.future_names:
        return True
    parts = d.split(".")
    return parts[-1] == "Future" and (
        parts[0] in imp.futures_aliases or parts[0] == "concurrent")


def _discharges(stmt: ast.stmt, name: str) -> bool:
    """Does this statement (ignoring nested blocks) resolve or hand off
    the future bound to ``name``?"""
    for sub in _shallow_walk(stmt):
        if isinstance(sub, ast.Call):
            if (isinstance(sub.func, ast.Attribute)
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == name
                    and sub.func.attr in _RESOLVE_METHODS):
                return True
            for a in sub.args:
                if any(isinstance(s, ast.Name) and s.id == name
                       for s in ast.walk(a)):
                    return True
            for kw in sub.keywords:
                if any(isinstance(s, ast.Name) and s.id == name
                       for s in ast.walk(kw.value)):
                    return True
    if isinstance(stmt, (ast.Return, ast.Yield)) and stmt.value is not None:
        if any(isinstance(s, ast.Name) and s.id == name
               for s in ast.walk(stmt.value)):
            return True
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            if not (isinstance(t, ast.Name) and t.id == name):
                # stored somewhere (self.x = f, d[k] = f, other = f)
                if any(isinstance(s, ast.Name) and s.id == name
                       and isinstance(s.ctx, ast.Load)
                       for s in ast.walk(stmt.value)):
                    return True
    return False


def _covers(stmts: list[ast.stmt], name: str) -> bool:
    """True if every path through ``stmts`` discharges the future."""
    for stmt in stmts:
        if _discharges(stmt, name):
            return True
        if isinstance(stmt, ast.If):
            if stmt.orelse and _covers(stmt.body, name) \
                    and _covers(stmt.orelse, name):
                return True
        elif isinstance(stmt, ast.Try):
            handlers_ok = all(_covers(h.body, name)
                              for h in stmt.handlers) if stmt.handlers \
                else True
            if _covers(stmt.body + stmt.orelse, name) and handlers_ok:
                return True
        elif isinstance(stmt, (ast.For, ast.While)):
            # lenient: a discharge inside a loop is accepted (zero-trip
            # hazards are below this tool's precision)
            if _covers(stmt.body, name):
                return True
        elif isinstance(stmt, ast.With):
            if _covers(stmt.body, name):
                return True
        if isinstance(stmt, (ast.Return, ast.Raise, ast.Break,
                             ast.Continue)):
            return False  # path ends with the future stranded
    return False


def _flag_futures(ctx: ModuleContext, imp,
                  findings: list[Finding]) -> None:
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for idx, stmt in enumerate(fn.body):
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and _is_future_ctor(stmt.value, imp)):
                continue
            name = stmt.targets[0].id
            if not _covers(fn.body[idx + 1:], name):
                findings.append(ctx.finding(
                    "CC303", stmt,
                    f"Future `{name}` has a code path that neither "
                    f"resolves (set_result/set_exception/cancel) nor "
                    f"hands it off — its waiter would hang forever"))


def analyze(ctx: ModuleContext) -> list[Finding]:
    imp = scan_imports(ctx.tree)
    if not imp.has_threads:
        return []
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ClassDef):
            info = _scan_class(node, imp)
            if info.locks:
                _flag_unlocked(ctx, info, findings)
                _flag_lock_order(ctx, info, findings)
    _flag_futures(ctx, imp, findings)
    return findings
