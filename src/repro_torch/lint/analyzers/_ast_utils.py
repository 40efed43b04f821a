"""Shared AST helpers for the analyzer families.  Port of
``repro/lint/analyzers/_ast_utils.py``, as is.

Centralizes the fiddly parts every analyzer needs: resolving dotted
names, mapping import aliases (``jax`` vs ``jax.numpy`` vs real
``numpy``), and recovering :class:`JitInfo` (static/donate argument
sets) from the three jit idioms the codebase uses::

    @jax.jit / @functools.partial(jax.jit, static_argnames=...)
    g = jax.jit(f, donate_argnums=(0,))
    def factory(cap):                 # lru_cached jit factory
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def run(...): ...
        return run
"""
from __future__ import annotations

import ast
import dataclasses


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


@dataclasses.dataclass
class Imports:
    """How this module spells jax / numpy / functools."""

    jaxlike: set[str]          # aliases for jax or jax.* modules (jax, jnp, lax)
    jit_names: set[str]        # bare names bound to jax.jit
    jax_fn_names: set[str]     # names imported from jax.* (traced calls)
    numpy_aliases: set[str]    # aliases for real numpy
    numpy_fn_names: set[str]   # names imported from numpy
    partial_names: set[str]    # bare names bound to functools.partial
    functools_aliases: set[str]
    threading_aliases: set[str]
    future_names: set[str]     # names bound to concurrent.futures.Future
    futures_aliases: set[str]  # aliases for the concurrent.futures module

    @property
    def has_jax(self) -> bool:
        return bool(self.jaxlike or self.jit_names or self.jax_fn_names)

    @property
    def has_threads(self) -> bool:
        return bool(self.threading_aliases or self.future_names
                    or self.futures_aliases)


def scan_imports(tree: ast.Module) -> Imports:
    imp = Imports(set(), set(), set(), set(), set(), set(), set(), set(),
                  set(), set())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                name = a.asname or a.name.split(".")[0]
                if a.name == "jax" or a.name.startswith("jax."):
                    # `import jax.numpy as jnp` binds jnp; plain
                    # `import jax.numpy` binds only `jax`
                    imp.jaxlike.add(a.asname or "jax")
                elif a.name == "numpy" or a.name.startswith("numpy."):
                    imp.numpy_aliases.add(name)
                elif a.name == "functools":
                    imp.functools_aliases.add(name)
                elif a.name == "threading":
                    imp.threading_aliases.add(name)
                elif a.name in ("concurrent.futures", "concurrent"):
                    imp.futures_aliases.add(a.asname or "concurrent")
        elif isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            for a in node.names:
                name = a.asname or a.name
                if mod == "jax" and a.name == "jit":
                    imp.jit_names.add(name)
                elif mod == "jax" and a.name in ("numpy", "lax", "nn",
                                                 "random", "scipy"):
                    imp.jaxlike.add(name)
                elif mod == "jax" or mod.startswith("jax."):
                    imp.jax_fn_names.add(name)
                elif mod == "numpy" or mod.startswith("numpy."):
                    imp.numpy_fn_names.add(name)
                elif mod == "functools" and a.name == "partial":
                    imp.partial_names.add(name)
                elif mod == "threading":
                    imp.threading_aliases.add(name)  # e.g. `from threading import Lock` — treated as module-ish marker
                elif mod == "concurrent.futures":
                    if a.name == "Future":
                        imp.future_names.add(name)
                    else:
                        imp.futures_aliases.add(name)
                elif mod == "concurrent" and a.name == "futures":
                    imp.futures_aliases.add(name)
    return imp


def is_jit_ref(node: ast.AST, imp: Imports) -> bool:
    d = dotted(node)
    if d is None:
        return False
    if d in imp.jit_names:
        return True
    return any(d == f"{alias}.jit" for alias in imp.jaxlike)


def is_partial_ref(node: ast.AST, imp: Imports) -> bool:
    d = dotted(node)
    if d is None:
        return False
    if d in imp.partial_names:
        return True
    return any(d == f"{alias}.partial" for alias in imp.functools_aliases)


def _const_set(node: ast.AST, typ: type) -> frozenset | None:
    """Literal ``3`` / ``"x"`` / tuple-or-list of them → frozenset;
    anything non-literal → None (caller marks the info unknown)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, typ):
        return frozenset({node.value})
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = set()
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, typ):
                vals.add(e.value)
            else:
                return None
        return frozenset(vals)
    return None


@dataclasses.dataclass
class JitInfo:
    """Parsed jit options for one jitted callable."""

    node: ast.AST
    static_argnums: frozenset[int] = frozenset()
    static_argnames: frozenset[str] = frozenset()
    donate_argnums: frozenset[int] = frozenset()
    donate_argnames: frozenset[str] = frozenset()
    unknown: bool = False       # some option was not a parseable literal
    is_factory: bool = False    # name maps to a jit *factory*, not the
                                # jitted callable itself


def jit_info_from_keywords(node: ast.AST,
                           keywords: list[ast.keyword]) -> JitInfo:
    info = JitInfo(node)
    for kw in keywords:
        if kw.arg == "static_argnums":
            vals = _const_set(kw.value, int)
            info.static_argnums = vals or frozenset()
            info.unknown |= vals is None
        elif kw.arg == "static_argnames":
            vals = _const_set(kw.value, str)
            info.static_argnames = vals or frozenset()
            info.unknown |= vals is None
        elif kw.arg == "donate_argnums":
            vals = _const_set(kw.value, int)
            info.donate_argnums = vals or frozenset()
            info.unknown |= vals is None
        elif kw.arg == "donate_argnames":
            vals = _const_set(kw.value, str)
            info.donate_argnames = vals or frozenset()
            info.unknown |= vals is None
    return info


def jit_call_target(call: ast.Call,
                    imp: Imports) -> tuple[ast.AST | None, JitInfo] | None:
    """If ``call`` is ``jax.jit(f, ...)`` or ``partial(jax.jit, ...)``,
    return (wrapped expr or None, parsed JitInfo)."""
    if is_jit_ref(call.func, imp):
        target = call.args[0] if call.args else None
        return target, jit_info_from_keywords(call, call.keywords)
    if (is_partial_ref(call.func, imp) and call.args
            and is_jit_ref(call.args[0], imp)):
        target = call.args[1] if len(call.args) > 1 else None
        return target, jit_info_from_keywords(call, call.keywords)
    return None


def decorator_jit_info(func: ast.FunctionDef | ast.AsyncFunctionDef,
                       imp: Imports) -> JitInfo | None:
    for dec in func.decorator_list:
        if is_jit_ref(dec, imp):
            return JitInfo(dec)
        if isinstance(dec, ast.Call):
            hit = jit_call_target(dec, imp)
            if hit is not None:
                return hit[1]
    return None


def param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef | ast.Lambda
                ) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def positional_params(fn) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def collect_jit_callables(tree: ast.Module,
                          imp: Imports) -> dict[str, JitInfo]:
    """Map local names to the jit options of the callable they hold.

    Covers jit-decorated defs, ``g = jax.jit(f, ...)`` wraps (both
    ``g`` and ``f``), jit-factory functions (a def whose return value
    is a nested jitted def — mapped with ``is_factory=True``), and
    locals assigned from a factory call (``run = _scan_fn(cap)``).
    """
    out: dict[str, JitInfo] = {}
    factories: dict[str, JitInfo] = {}

    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = decorator_jit_info(node, imp)
            if info is not None:
                out[node.name] = info
                continue
            # factory? nested jitted def returned by name
            nested = {
                n.name: decorator_jit_info(n, imp)
                for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            }
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Return)
                        and isinstance(sub.value, ast.Name)
                        and nested.get(sub.value.id) is not None):
                    info = nested[sub.value.id]
                    factories[node.name] = info
                    out[node.name] = dataclasses.replace(
                        info, is_factory=True)
                    break

    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        target = dotted(node.targets[0])
        if target is None:
            continue
        hit = jit_call_target(node.value, imp)
        if hit is not None:
            wrapped, info = hit
            out[target] = info
            if isinstance(wrapped, ast.Name):
                out.setdefault(wrapped.id, info)
            continue
        callee = dotted(node.value.func)
        if callee in factories:
            out[target] = factories[callee]
    return out
