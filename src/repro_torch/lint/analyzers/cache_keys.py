"""CK family: cache-key and fingerprint invariants.  Port of
``repro/lint/analyzers/cache_keys.py``, as is.

The artifact pipeline trusts its keys completely — ``Session`` and
``ArtifactStore`` never re-validate a hit (the paper's premise is
"extract the trace only once"), so a key that omits a
behavior-changing field silently serves wrong results.

CK401 — any function that *is* a key builder (name contains
``fingerprint``, ends in ``_key``, or is ``key``) must route every
parameter and every ``self.<attr>`` it reads into its return value.
The check runs a backward slice from the return expressions through
local assignments (and ``.append``/``.update`` mutations), so
``parts = [...]; parts.append(f(seed)); return "/".join(parts)``
counts ``seed`` as used.

CK402 — a module that defines ``STORE_VERSION`` must actually
interpolate a version component into its on-disk path (the
``f"v{self.version}"`` namespace in ``validate/store.py``); otherwise
bumping the constant would *misread* old entries instead of orphaning
them.

CK403 — ``save_*``/``load_*`` pairs must agree on the persisted meta
fields: every key written into the save-side meta dict should be read
back (``meta["k"]`` / ``meta.get("k")``) by the paired loader, and
vice versa.  Write-only provenance fields need a justified
suppression.
"""
from __future__ import annotations

import ast

from repro_torch.lint.analyzers._ast_utils import dotted
from repro_torch.lint.engine import Finding, ModuleContext


def _is_key_builder(name: str) -> bool:
    return "fingerprint" in name or name.endswith("_key") or name == "key"


def _expr_deps(node: ast.AST) -> set[str]:
    """Names and ``self.X`` attrs read by an expression."""
    deps: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and isinstance(sub.ctx, ast.Load):
            deps.add(sub.id)
        elif (isinstance(sub, ast.Attribute)
              and isinstance(sub.value, ast.Name)
              and sub.value.id == "self"):
            deps.add(f"self.{sub.attr}")
    return deps


def _check_key_builder(ctx: ModuleContext, fn: ast.FunctionDef,
                       findings: list[Finding]) -> None:
    args = fn.args
    if args.vararg or args.kwarg:
        return  # *args/**kwargs builders hash dynamically; out of scope
    params = [a.arg for a in (*args.posonlyargs, *args.args,
                              *args.kwonlyargs) if a.arg not in ("self",
                                                                 "cls")]

    returns = [n.value for n in ast.walk(fn)
               if isinstance(n, ast.Return) and n.value is not None]
    if not returns:
        return

    # local assignment graph: name -> deps of its value(s)
    assigns: dict[str, set[str]] = {}

    def _add(name: str, deps: set[str]) -> None:
        assigns.setdefault(name, set()).update(deps)

    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            deps = _expr_deps(sub.value)
            for t in sub.targets:
                for tn in ast.walk(t):
                    if isinstance(tn, ast.Name):
                        _add(tn.id, deps)
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            if getattr(sub, "value", None) is None:
                continue
            if isinstance(sub.target, ast.Name):
                _add(sub.target.id, _expr_deps(sub.value))
        elif isinstance(sub, ast.NamedExpr):
            if isinstance(sub.target, ast.Name):
                _add(sub.target.id, _expr_deps(sub.value))
        elif isinstance(sub, ast.Call):
            # mutation flows: parts.append(x), d.update(...), d.add(...)
            f = sub.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.attr in ("append", "extend", "update", "add",
                                   "insert", "setdefault", "write")):
                deps = set()
                for a in sub.args:
                    deps |= _expr_deps(a)
                for kw in sub.keywords:
                    deps |= _expr_deps(kw.value)
                _add(f.value.id, deps)
        elif isinstance(sub, ast.For):
            deps = _expr_deps(sub.iter)
            for tn in ast.walk(sub.target):
                if isinstance(tn, ast.Name):
                    _add(tn.id, deps)
        elif isinstance(sub, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                              ast.DictComp)):
            for gen in sub.generators:
                deps = _expr_deps(gen.iter)
                for tn in ast.walk(gen.target):
                    if isinstance(tn, ast.Name):
                        _add(tn.id, deps)

    used: set[str] = set()
    for r in returns:
        used |= _expr_deps(r)
    # control dependence: a field read in a branch condition steers
    # which key is returned (e.g. `if self.done: return inf`) — that
    # counts as flowing into the key
    for sub in ast.walk(fn):
        if isinstance(sub, (ast.If, ast.While)):
            used |= _expr_deps(sub.test)
        elif isinstance(sub, ast.IfExp):
            used |= _expr_deps(sub.test)
    for _ in range(len(assigns) + 1):
        grown = set(used)
        for name in list(used):
            grown |= assigns.get(name, set())
        if grown == used:
            break
        used = grown

    self_reads = {d for d in _all_self_reads(fn)}
    for p in params:
        if p not in used:
            findings.append(ctx.finding(
                "CK401", fn,
                f"key builder `{fn.name}` reads parameter `{p}` but it "
                f"never flows into the returned key — two inputs "
                f"differing only in `{p}` would collide"))
    for attr in sorted(self_reads):
        if attr not in used:
            findings.append(ctx.finding(
                "CK401", fn,
                f"key builder `{fn.name}` reads `{attr}` but it never "
                f"flows into the returned key"))


def _all_self_reads(fn: ast.FunctionDef) -> set[str]:
    out = set()
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Attribute)
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "self"
                and isinstance(sub.ctx, ast.Load)):
            out.add(f"self.{sub.attr}")
    return out


# -- CK402 --------------------------------------------------------------------

def _check_store_version(ctx: ModuleContext,
                         findings: list[Finding]) -> None:
    assign = None
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "STORE_VERSION"
                for t in node.targets):
            assign = node
            break
    if assign is None:
        return
    referenced = any(
        isinstance(n, ast.Name) and n.id == "STORE_VERSION"
        and isinstance(n.ctx, ast.Load)
        for n in ast.walk(ctx.tree))
    versioned_path = False
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.JoinedStr):
            continue
        has_v_literal = any(
            isinstance(v, ast.Constant) and isinstance(v.value, str)
            and v.value.rstrip().endswith("v")
            for v in node.values)
        has_version_field = any(
            isinstance(v, ast.FormattedValue)
            and any("version" in (dotted(s) or "").lower()
                    for s in ast.walk(v.value)
                    if isinstance(s, (ast.Name, ast.Attribute)))
            for v in node.values)
        if has_v_literal and has_version_field:
            versioned_path = True
            break
    if not (referenced and versioned_path):
        findings.append(ctx.finding(
            "CK402", assign,
            "STORE_VERSION is defined but the on-disk key path never "
            "interpolates a version component (expected an "
            "f\"v{...version...}\" namespace) — a format bump would "
            "misread old entries"))


# -- CK403 --------------------------------------------------------------------

def _meta_written_keys(fn: ast.FunctionDef) -> tuple[set[str],
                                                     ast.AST | None]:
    """String keys of the meta dict a ``save_*`` persists: a dict
    literal assigned to ``meta``/``*_meta``, passed as a ``meta=``
    kwarg, or handed positionally to a ``put_*`` call."""
    dicts: list[ast.Dict] = []
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            if (isinstance(sub.value, ast.Dict)
                    and any(isinstance(t, ast.Name)
                            and t.id.endswith("meta")
                            for t in sub.targets)):
                dicts.append(sub.value)
        elif isinstance(sub, ast.Call):
            fname = dotted(sub.func) or ""
            for kw in sub.keywords:
                if kw.arg == "meta" and isinstance(kw.value, ast.Dict):
                    dicts.append(kw.value)
            if "put" in fname.rsplit(".", 1)[-1]:
                # put_arrays(kind, key, arrays, meta): the payload dict
                # precedes the meta dict — only the last literal dict
                # is the persisted meta
                pos_dicts = [a for a in sub.args if isinstance(a, ast.Dict)]
                if pos_dicts:
                    dicts.append(pos_dicts[-1])
    keys: set[str] = set()
    site = dicts[0] if dicts else None
    for d in dicts:
        for k in d.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.add(k.value)
    return keys, site


def _meta_read_keys(fn: ast.FunctionDef) -> set[str]:
    """String keys a ``load_*`` reads off any ``*meta*`` variable via
    ``meta["k"]`` or ``meta.get("k")``."""
    keys: set[str] = set()
    for sub in ast.walk(fn):
        if (isinstance(sub, ast.Subscript)
                and isinstance(sub.ctx, ast.Load)
                and "meta" in (dotted(sub.value) or "")
                and isinstance(sub.slice, ast.Constant)
                and isinstance(sub.slice.value, str)):
            keys.add(sub.slice.value)
        elif (isinstance(sub, ast.Call)
              and isinstance(sub.func, ast.Attribute)
              and sub.func.attr == "get"
              and "meta" in (dotted(sub.func.value) or "")
              and sub.args
              and isinstance(sub.args[0], ast.Constant)
              and isinstance(sub.args[0].value, str)):
            keys.add(sub.args[0].value)
    return keys


def _check_save_load_pairs(ctx: ModuleContext,
                           findings: list[Finding]) -> None:
    fns: dict[str, ast.FunctionDef] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef):
            fns[node.name] = node
    for name, save_fn in fns.items():
        if not name.startswith("save_"):
            continue
        load_fn = fns.get("load_" + name[len("save_"):])
        if load_fn is None:
            continue
        written, site = _meta_written_keys(save_fn)
        read = _meta_read_keys(load_fn)
        if not written or not read:
            continue  # pair doesn't persist structured meta — no claim
        for k in sorted(written - read):
            findings.append(ctx.finding(
                "CK403", site or save_fn,
                f"meta field \"{k}\" is written by `{save_fn.name}` but "
                f"never read back by `{load_fn.name}` — drop it or "
                f"restore it on load"))
        for k in sorted(read - written):
            findings.append(ctx.finding(
                "CK403", load_fn,
                f"meta field \"{k}\" is read by `{load_fn.name}` but "
                f"never written by `{save_fn.name}` — it will always "
                f"be missing"))


def analyze(ctx: ModuleContext) -> list[Finding]:
    findings: list[Finding] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.FunctionDef) and _is_key_builder(node.name):
            _check_key_builder(ctx, node, findings)
    _check_store_version(ctx, findings)
    _check_save_load_pairs(ctx, findings)
    return findings
