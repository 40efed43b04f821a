"""JP family: purity of jit-reachable code.  Port of
``repro/lint/analyzers/jax_purity.py``, as is.

The analyzer discovers every *jit root* in a module (jit-decorated
defs, ``jax.jit(f)`` wraps, ``jax.jit(lambda ...)``, and jitted defs
returned by factories), then runs a taint fixpoint: a root's
parameters are traced values (minus ``static_argnums`` /
``static_argnames``), local helper functions called from reachable
code inherit taint through their call-site arguments, and helpers
passed *by reference* (``jax.vmap(f)``, ``lax.scan(step, ...)``)
get all parameters tainted because jax calls them with tracers.

The call-site propagation is what keeps helpers like::

    def _fenwick_levels(n):
        return max(1, int(n).bit_length())

clean when every caller passes a static shape — a naive
"every param of a jit-reachable function is traced" scheme would
flag that ``int(n)`` as a host sync.

Untainted by construction: constants, ``.shape/.dtype/.ndim/.size``,
``len()``, and ``x is None`` comparisons (the standard optional-arg
idiom inside jitted wrappers).

Rules emitted: JP101 (print), JP102 (host sync), JP103 (numpy on
traced), JP110 (Python control flow on traced), JP120 (jit built in a
loop), JP121 (data-length static argument at a jitted call site).
"""
from __future__ import annotations

import ast

from repro_torch.lint.analyzers._ast_utils import (
    Imports,
    collect_jit_callables,
    decorator_jit_info,
    dotted,
    is_jit_ref,
    is_partial_ref,
    jit_call_target,
    param_names,
    positional_params,
    scan_imports,
)
from repro_torch.lint.engine import Finding, ModuleContext

_SHAPE_ATTRS = {"shape", "dtype", "ndim", "size", "weak_type", "sharding"}
_HOST_CASTS = {"float", "int", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "to_py"}
_UNTAINTED_BUILTINS = {"len", "isinstance", "hasattr", "getattr", "type",
                       "repr", "str", "id", "callable"}
_MAX_FIXPOINT_PASSES = 12


class _FnNode:
    """Per-function taint state across fixpoint passes."""

    def __init__(self, node: ast.AST):
        self.node = node
        self.params = param_names(node)
        self.taint: dict[str, bool] = {p: False for p in self.params}
        self.reachable = False
        self.is_root = False

    def taint_param(self, name: str) -> bool:
        if name in self.taint and not self.taint[name]:
            self.taint[name] = True
            return True
        return False

    def taint_all(self) -> bool:
        changed = False
        for p in self.params:
            changed |= self.taint_param(p)
        return changed


class _Analyzer:
    def __init__(self, ctx: ModuleContext, imp: Imports):
        self.ctx = ctx
        self.imp = imp
        self.fns: dict[ast.AST, _FnNode] = {}
        self.by_name: dict[str, list[_FnNode]] = {}
        self.findings: list[Finding] = []
        self.seen: set[tuple[str, int, int]] = set()
        self.changed = False
        self.emitting = False

        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                fn = _FnNode(node)
                self.fns[node] = fn
                if not isinstance(node, ast.Lambda):
                    self.by_name.setdefault(node.name, []).append(fn)

    # -- root discovery ------------------------------------------------------

    def find_roots(self) -> None:
        for node, fn in self.fns.items():
            if isinstance(node, ast.Lambda):
                continue
            info = decorator_jit_info(node, self.imp)
            if info is not None:
                self._make_root(fn, info)
        for node in ast.walk(self.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = jit_call_target(node, self.imp)
            if hit is None:
                continue
            wrapped, info = hit
            if isinstance(wrapped, ast.Lambda):
                self._make_root(self.fns[wrapped], info)
            elif isinstance(wrapped, ast.Name):
                for fn in self.by_name.get(wrapped.id, []):
                    self._make_root(fn, info)

    def _make_root(self, fn: _FnNode, info) -> None:
        fn.is_root = True
        fn.reachable = True
        pos = positional_params(fn.node)
        static = {pos[i] for i in info.static_argnums if i < len(pos)}
        static |= set(info.static_argnames)
        if info.unknown:
            static = set(fn.params)  # can't tell — assume static, no FPs
        for p in fn.params:
            if p not in static:
                fn.taint[p] = True

    # -- fixpoint ------------------------------------------------------------

    def run(self) -> list[Finding]:
        self.find_roots()
        if not any(fn.is_root for fn in self.fns.values()):
            self._scan_jit_in_loop()
            return self.findings
        for _ in range(_MAX_FIXPOINT_PASSES):
            self.changed = False
            for fn in list(self.fns.values()):
                if fn.reachable:
                    _BodyWalker(self, fn).walk()
            if not self.changed:
                break
        self.emitting = True
        for fn in self.fns.values():
            if fn.reachable:
                _BodyWalker(self, fn).walk()
        self._scan_jit_in_loop()
        self._scan_static_len_args()
        return self.findings

    # -- helpers used by the walker -----------------------------------------

    def mark_called(self, name: str, arg_taints: list[bool],
                    kw_taints: dict[str, bool]) -> None:
        """Direct call of a local function: taint its params from the
        call site and make it reachable."""
        for fn in self.by_name.get(name, []):
            if not fn.reachable:
                fn.reachable = True
                self.changed = True
            pos = positional_params(fn.node)
            for i, t in enumerate(arg_taints):
                if t and i < len(pos):
                    self.changed |= fn.taint_param(pos[i])
            for k, t in kw_taints.items():
                if t:
                    self.changed |= fn.taint_param(k)

    def mark_referenced(self, fn: _FnNode) -> None:
        """Function passed by reference (vmap/scan/fori_loop callback):
        jax will call it with tracers — every param is traced."""
        if not fn.reachable:
            fn.reachable = True
            self.changed = True
        self.changed |= fn.taint_all()

    def emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        if not self.emitting:
            return
        key = (rule_id, getattr(node, "lineno", 1),
               getattr(node, "col_offset", 0))
        if key in self.seen:
            return
        self.seen.add(key)
        self.findings.append(self.ctx.finding(rule_id, node, message))

    # -- module-wide scans (taint-independent) -------------------------------

    def _scan_jit_in_loop(self) -> None:
        self.emitting = True
        for loop in ast.walk(self.ctx.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for sub in ast.walk(loop):
                if isinstance(sub, ast.Call) and (
                        is_jit_ref(sub.func, self.imp)
                        or jit_call_target(sub, self.imp) is not None):
                    self.emit("JP120", sub,
                              "jax.jit(...) constructed inside a loop "
                              "body recompiles every iteration; hoist "
                              "or cache the jitted callable")

    def _scan_static_len_args(self) -> None:
        callables = collect_jit_callables(self.ctx.tree, self.imp)
        for node in ast.walk(self.ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            info = callables.get(d) if d else None
            if info is None or info.is_factory or info.unknown:
                continue
            for i, arg in enumerate(node.args):
                if i in info.static_argnums and _derives_from_length(arg):
                    self.emit("JP121", arg,
                              f"static argument {i} of `{d}` is derived "
                              "from a data length at the call site — one "
                              "XLA compilation per distinct length")
            for kw in node.keywords:
                if (kw.arg in info.static_argnames
                        and _derives_from_length(kw.value)):
                    self.emit("JP121", kw.value,
                              f"static argument `{kw.arg}` of `{d}` is "
                              "derived from a data length at the call "
                              "site — one XLA compilation per distinct "
                              "length")


def _derives_from_length(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            return True
        if isinstance(sub, ast.Attribute) and sub.attr in ("shape", "size"):
            return True
    return False


def _is_none_compare(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops)
            and (any(isinstance(c, ast.Constant) and c.value is None
                     for c in expr.comparators)
                 or (isinstance(expr.left, ast.Constant)
                     and expr.left.value is None)))


class _BodyWalker:
    """Single forward pass over one function body, computing local
    taint and (on the emission pass) JP findings."""

    def __init__(self, an: _Analyzer, fn: _FnNode):
        self.an = an
        self.fn = fn
        self.env: dict[str, bool] = dict(fn.taint)

    def walk(self) -> None:
        body = self.fn.node.body
        if isinstance(self.fn.node, ast.Lambda):
            self.taint(body)
        else:
            self.block(body)

    # -- statements ----------------------------------------------------------

    def block(self, stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            self.stmt(stmt)

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Expr):
            self.taint(node.value)
        elif isinstance(node, ast.Assign):
            t = self.taint(node.value)
            for target in node.targets:
                self.bind(target, t)
        elif isinstance(node, ast.AugAssign):
            t = self.taint(node.value) or self.taint(node.target)
            self.bind(node.target, t)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self.bind(node.target, self.taint(node.value))
        elif isinstance(node, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(node):
                self.taint(child)
        elif isinstance(node, ast.If):
            self.check_condition(node.test, "if")
            self.block(node.body)
            self.block(node.orelse)
        elif isinstance(node, ast.While):
            self.check_condition(node.test, "while")
            self.block(node.body)
            self.block(node.body)  # loop-carried taint
            self.block(node.orelse)
        elif isinstance(node, ast.For):
            t = self.taint(node.iter)
            if t:
                self.an.emit("JP110", node.iter,
                             "for-loop over a traced value inside "
                             "jit-reachable code (unrolls per element and "
                             "recompiles per length)")
            self.bind(node.target, t)
            self.block(node.body)
            self.block(node.body)  # loop-carried taint
            self.block(node.orelse)
        elif isinstance(node, ast.Assert):
            self.check_condition(node.test, "assert")
            if node.msg is not None:
                self.taint(node.msg)
        elif isinstance(node, ast.With):
            for item in node.items:
                self.taint(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, False)
            self.block(node.body)
        elif isinstance(node, ast.Try):
            self.block(node.body)
            for h in node.handlers:
                self.block(h.body)
            self.block(node.orelse)
            self.block(node.finalbody)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass  # nested defs get their own _FnNode via references
        elif isinstance(node, ast.ClassDef):
            pass
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.env.pop(t.id, None)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.taint(child)
                elif isinstance(child, ast.stmt):
                    self.stmt(child)

    def bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = tainted
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.bind(elt, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)
        # attribute/subscript stores: nothing to track locally

    def check_condition(self, test: ast.expr, kind: str) -> None:
        t = self.taint(test)
        if t and not _is_none_compare(test):
            self.an.emit("JP110", test,
                         f"Python `{kind}` conditioned on a traced value "
                         "inside jit-reachable code — use jnp.where / "
                         "jax.lax.cond")

    # -- expressions ---------------------------------------------------------

    def taint(self, node: ast.AST | None) -> bool:
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            if node.id in self.an.by_name and node.id not in self.env:
                # bare reference to a local function (callback position)
                for fn in self.an.by_name[node.id]:
                    self.an.mark_referenced(fn)
                return False
            return self.env.get(node.id, False)
        if isinstance(node, ast.Lambda):
            self.an.mark_referenced(self.an.fns[node])
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in _SHAPE_ATTRS:
                self.taint(node.value)
                return False
            return self.taint(node.value)
        if isinstance(node, ast.Subscript):
            return self.taint(node.value) | self.taint(node.slice)
        if isinstance(node, ast.Call):
            return self.call(node)
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.BoolOp):
            return any([self.taint(v) for v in node.values])
        if isinstance(node, ast.Compare):
            t = self.taint(node.left)
            for c in node.comparators:
                t |= self.taint(c)
            return False if _is_none_compare(node) else t
        if isinstance(node, ast.IfExp):
            self.check_condition(node.test, "if-expression")
            return self.taint(node.body) | self.taint(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            t = any([self.taint(k) for k in node.keys if k is not None])
            return any([self.taint(v) for v in node.values]) or t
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for child in ast.iter_child_nodes(node):
                self.taint(child)
            return False
        if isinstance(node, ast.NamedExpr):
            t = self.taint(node.value)
            self.bind(node.target, t)
            return t
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return self.comprehension(node)
        if isinstance(node, ast.Slice):
            return (self.taint(node.lower) | self.taint(node.upper)
                    | self.taint(node.step))
        if isinstance(node, (ast.Await, ast.Yield, ast.YieldFrom)):
            return self.taint(node.value) if node.value else False
        return any(self.taint(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def comprehension(self, node: ast.AST) -> bool:
        t = False
        for gen in node.generators:
            it = self.taint(gen.iter)
            if it:
                self.an.emit("JP110", gen.iter,
                             "comprehension over a traced value inside "
                             "jit-reachable code (unrolls per element)")
            self.bind(gen.target, it)
            for cond in gen.ifs:
                self.check_condition(cond, "comprehension-if")
            t |= it
        if isinstance(node, ast.DictComp):
            t |= self.taint(node.key) | self.taint(node.value)
        else:
            t |= self.taint(node.elt)
        return t

    def call(self, node: ast.Call) -> bool:
        imp = self.an.imp
        d = dotted(node.func)

        # evaluate arguments first; a Name-of-local-function in argument
        # position is a by-reference callback (vmap/scan) and is marked
        # all-tainted inside taint()
        skip_arg_refs = (is_partial_ref(node.func, imp)
                         and node.args
                         and isinstance(node.args[0], ast.Name)
                         and node.args[0].id in self.an.by_name)
        arg_taints = []
        for i, a in enumerate(node.args):
            if skip_arg_refs and i == 0:
                arg_taints.append(False)
                continue
            arg_taints.append(self.taint(a))
        kw_taints = {kw.arg: self.taint(kw.value)
                     for kw in node.keywords if kw.arg is not None}
        any_taint = any(arg_taints) or any(kw_taints.values())

        if d == "print":
            self.an.emit("JP101", node,
                         "print() inside jit-reachable code runs at "
                         "trace time only — use jax.debug.print()")
            return False
        if d in _HOST_CASTS and arg_taints and arg_taints[0]:
            self.an.emit("JP102", node,
                         f"{d}() on a traced value inside jit-reachable "
                         "code forces a host sync / fails under tracing")
            return False
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_METHODS
                and self.taint(node.func.value)):
            self.an.emit("JP102", node,
                         f".{node.func.attr}() on a traced value inside "
                         "jit-reachable code forces a host sync")
            return False
        root = d.split(".")[0] if d else None
        if d and any_taint and (root in imp.numpy_aliases
                                or d in imp.numpy_fn_names):
            self.an.emit("JP103", node,
                         f"`{d}` (host numpy) applied to a traced value "
                         "inside jit-reachable code — use the jnp "
                         "equivalent")
            return False
        if d and (root in imp.jaxlike or d in imp.jit_names
                  or d in imp.jax_fn_names):
            return True
        if (isinstance(node.func, ast.Name)
                and node.func.id in self.an.by_name
                and node.func.id not in self.env):
            self.an.mark_called(node.func.id, arg_taints, kw_taints)
            return any_taint
        if skip_arg_refs:
            # partial(local_fn, kw=...): map keyword taints through,
            # remaining params will be filled with tracers by the caller
            for fn in self.an.by_name[node.args[0].id]:
                if not fn.reachable:
                    fn.reachable = True
                    self.an.changed = True
                named = set()
                for k, t in kw_taints.items():
                    named.add(k)
                    if t:
                        self.an.changed |= fn.taint_param(k)
                for p in fn.params:
                    if p not in named:
                        self.an.changed |= fn.taint_param(p)
            return False
        if d in _UNTAINTED_BUILTINS:
            return False
        if isinstance(node.func, (ast.Attribute, ast.Subscript, ast.Call,
                                  ast.Lambda)):
            self.taint(node.func)
        return any_taint


def analyze(ctx: ModuleContext) -> list[Finding]:
    imp = scan_imports(ctx.tree)
    if not imp.has_jax:
        return []
    return _Analyzer(ctx, imp).run()
