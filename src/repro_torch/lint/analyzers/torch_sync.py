"""TS family: host syncs of device tensors inside loops of torch code.

JP's counterpart for the port.  Under ``jax.jit`` a host sync fails at
trace time; in eager PyTorch it runs, and inside a loop that also
enqueues device work each pass stalls the host until the device has
caught up, and no CUDA graph can be captured over the loop.

Scope:

* Modules that import torch.  Test files (under a ``tests`` directory,
  ``test_*.py``, ``conftest.py``) are out of scope: a test reads values
  back to compare them, on purpose and off any hot path.
* Loop scope: the body of a ``for`` or ``while`` (and a ``while``'s
  test), a comprehension (all but its first iterable), and every
  function called from loop scope, through JP's call-site propagation:
  local helpers by name, methods through ``self.m(...)``, and the
  functions of the same package that a call reaches through an import.
  That last step is what sees a per-layer readback in one module from
  the layer loop of another (``models/moe.py``'s expert counts from
  ``models/transformer.py``'s loop over blocks).

Taint (a value that may be a device tensor), by a fixpoint as in JP:
parameters annotated ``torch.Tensor`` (also inside ``Optional``, unions
and containers); results of torch calls and tensor methods that are
given a tainted value or a device (``device=``, ``.to(device)``,
``.cuda()``); results of calls with a tainted argument (a module's
forward, a helper), unless the callee is annotated to return something
other than a tensor; local helpers' parameters through their call
sites.  A tensor made from host data without a device is a host tensor,
and reading it back is no sync.  Untainted by construction: constants,
``.shape/.dtype/.device/.ndim``, ``.numel()/.size()/.dim()``, ``len()``,
``x is None`` comparisons, and the host value a sync returns.

Rules emitted: TS102 (host sync of a device tensor in loop scope),
TS110 (Python ``if``/``while``/``assert``/conditional expression on a
device tensor in loop scope).
"""
from __future__ import annotations

import ast
import dataclasses
import functools
from pathlib import Path

from repro_torch.lint.analyzers._ast_utils import (
    dotted,
    param_names,
    positional_params,
)
from repro_torch.lint.engine import Finding, ModuleContext

_SHAPE_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                "requires_grad", "is_leaf", "names", "itemsize", "nbytes"}
_HOST_METHODS = {"size", "dim", "ndimension", "numel", "nelement",
                 "element_size", "stride", "storage_offset", "data_ptr",
                 "is_contiguous", "is_floating_point", "is_complex",
                 "get_device"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_CASTS = {"int", "float", "bool", "complex"}
_UNTAINTED_BUILTINS = {"len", "isinstance", "hasattr", "getattr", "type",
                       "repr", "str", "id", "callable", "range"}
_TORCH_HOST_FNS = {"is_tensor", "numel", "is_floating_point", "is_complex",
                   "is_nonzero", "from_numpy", "device", "finfo", "iinfo",
                   "manual_seed", "no_grad", "inference_mode", "enable_grad",
                   "compile"}
# torch submodules whose functions return host objects (streams, events,
# flags, process groups), not tensors
_TORCH_HOST_MODULES = {"cuda", "backends", "distributed", "utils",
                       "profiler", "library", "jit", "compiler", "testing"}
_TORCH_HOST_PREFIXES = ("is_", "get_", "set_", "use_")
# torch functions that make a new tensor on the CPU unless given a device
_FACTORIES = {"empty", "zeros", "ones", "full", "arange", "linspace",
              "logspace", "eye", "rand", "randn", "randint", "randperm",
              "tensor"}
# torch functions that copy their data argument to ``device=``
_FROM_DATA = {"tensor", "as_tensor", "asarray"}
# functions and methods that give a boolean tensor, and methods that
# keep a mask a mask
_MASK_FNS = {"isnan", "isinf", "isfinite", "isin", "isneginf", "isposinf",
             "logical_and", "logical_or", "logical_not", "logical_xor",
             "eq", "ne", "lt", "le", "gt", "ge", "bool", "signbit"}
_MASK_KEEPING = {"flatten", "reshape", "view", "squeeze", "unsqueeze",
                 "contiguous", "t", "transpose", "expand", "expand_as",
                 "clone", "detach", "any", "all"}
# ops whose output size depends on the data: on a CUDA tensor they read a
# count back to the host before they can allocate their result
_SIZE_SYNC_OPS = {"unique", "unique_consecutive", "nonzero", "argwhere",
                  "bincount", "masked_select"}
_MAX_FIXPOINT_PASSES = 12
_MAX_REEXPORT_DEPTH = 5


def _is_test_file(rel: str) -> bool:
    parts = Path(rel).parts
    name = parts[-1] if parts else ""
    return ("tests" in parts[:-1] or name.startswith("test_")
            or name == "conftest.py")


# --- imports -----------------------------------------------------------------


@dataclasses.dataclass
class _TorchNames:
    """How one module spells torch."""

    modules: set[str]      # aliases of torch or torch.* modules (torch, F, nn)
    tensor: set[str]       # bare names bound to torch.Tensor
    fns: set[str]          # other names imported from torch.*
    numpy: set[str]        # aliases of numpy and names imported from it

    @property
    def has_torch(self) -> bool:
        return bool(self.modules or self.tensor or self.fns)


def _torch_names(tree: ast.Module) -> _TorchNames:
    names = _TorchNames(set(), set(), set(), set())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch" or a.name.startswith("torch."):
                    names.modules.add(a.asname or "torch")
                elif a.name == "numpy" or a.name.startswith("numpy."):
                    names.numpy.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            mod = node.module
            for a in node.names:
                bound = a.asname or a.name
                if mod == "torch" or mod.startswith("torch."):
                    if a.name == "Tensor":
                        names.tensor.add(bound)
                    elif a.name in ("nn", "fft", "linalg", "special",
                                    "functional", "cuda"):
                        names.modules.add(bound)
                    else:
                        names.fns.add(bound)
                elif mod == "numpy" or mod.startswith("numpy."):
                    names.numpy.add(bound)
    return names


def _mentions_tensor(ann: ast.AST | None, tn: _TorchNames) -> bool:
    if ann is None:
        return False
    for sub in ast.walk(ann):
        d = dotted(sub)
        if d is None:
            continue
        if d in tn.tensor or any(d == f"{m}.Tensor" for m in tn.modules):
            return True
    return False


# --- the package index: which functions run in loop scope --------------------


def _loop_parts(node: ast.AST, depth: int):
    """Yield (child, depth) for the direct parts of ``node`` that run, with
    the loop depth each runs at; nested defs, lambdas and classes are not
    entered (a def runs when it is called)."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        yield node.target, depth
        yield node.iter, depth
        for s in node.body:
            yield s, depth + 1
        for s in node.orelse:
            yield s, depth
    elif isinstance(node, ast.While):
        yield node.test, depth + 1
        for s in node.body:
            yield s, depth + 1
        for s in node.orelse:
            yield s, depth
    elif isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                           ast.DictComp)):
        for i, gen in enumerate(node.generators):
            yield gen.iter, depth if i == 0 else depth + 1
            yield gen.target, depth + 1
            for cond in gen.ifs:
                yield cond, depth + 1
        if isinstance(node, ast.DictComp):
            yield node.key, depth + 1
            yield node.value, depth + 1
        else:
            yield node.elt, depth + 1
    else:
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.ClassDef)):
                yield child, depth


def _calls(body: list[ast.AST]):
    """(call, in a loop) for every call a function body makes itself."""
    stack = [(s, 0) for s in body]
    while stack:
        node, depth = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            yield node, depth > 0
        stack.extend(_loop_parts(node, depth))


@dataclasses.dataclass
class _Module:
    name: str
    tree: ast.Module
    imports: dict[str, str]                    # local name -> dotted target
    defs: dict[str, list[ast.AST]]             # bare name -> function defs
    classes: dict[str, dict[str, list[ast.AST]]]   # class -> its methods


def _module_name(path: Path, top: Path | None) -> tuple[str, bool]:
    if top is None:
        return path.stem, False
    parts = [top.name, *path.relative_to(top).with_suffix("").parts]
    if parts[-1] == "__init__":
        return ".".join(parts[:-1]), True
    return ".".join(parts), False


def _imports(tree: ast.Module, name: str, is_pkg: bool) -> dict[str, str]:
    out: dict[str, str] = {}
    pkg = name.split(".") if is_pkg else name.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    top = a.name.split(".")[0]
                    out[top] = top
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            for a in node.names:
                out[a.asname or a.name] = f"{mod}.{a.name}"
    return out


class _Index:
    """Every module of one package (or one lone module): the functions
    that run in loop scope, and what each function is annotated to
    return."""

    def __init__(self, files: list[Path], top: Path | None):
        self.modules: dict[str, _Module] = {}
        for f in files:
            try:
                tree = ast.parse(f.read_text(), filename=str(f))
            except (SyntaxError, UnicodeDecodeError, OSError):
                continue
            name, is_pkg = _module_name(f, top)
            defs: dict[str, list[ast.AST]] = {}
            for node in ast.walk(tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.setdefault(node.name, []).append(node)
            classes: dict[str, dict[str, list[ast.AST]]] = {}
            for node in tree.body:
                if isinstance(node, ast.ClassDef):
                    methods = classes.setdefault(node.name, {})
                    for m in node.body:
                        if isinstance(m, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                            methods.setdefault(m.name, []).append(m)
            self.modules[name] = _Module(name, tree,
                                         _imports(tree, name, is_pkg), defs,
                                         classes)
        # every method of every class, by name: a call on a receiver of
        # unknown type resolves when one class of the package defines it
        self.methods: dict[str, list] = {}
        for mod in self.modules.values():
            for methods in mod.classes.values():
                for m, fns in methods.items():
                    self.methods.setdefault(m, []).extend(
                        (mod.name, fn) for fn in fns)
        self.looped: set[tuple[str, int]] = set()
        self.returns_tensor: dict[tuple[str, int], bool | None] = {}
        self._reach()

    def lookup(self, target: str, depth: int = 0):
        """The package module that defines the dotted ``target`` (a
        function or a class), following re-exports, and its name there."""
        parts = target.split(".")
        for i in range(len(parts) - 1, 0, -1):
            mod = self.modules.get(".".join(parts[:i]))
            if mod is None:
                continue
            if i != len(parts) - 1:
                return None
            name = parts[-1]
            if name in mod.defs or name in mod.classes:
                return mod, name
            if name in mod.imports and depth < _MAX_REEXPORT_DEPTH:
                return self.lookup(mod.imports[name], depth + 1)
            return None
        return None

    def _named(self, mod: _Module, name: str):
        """``name`` as ``mod`` sees it: (defining module, name) or None."""
        if name in mod.defs or name in mod.classes:
            return mod, name
        if name in mod.imports:
            return self.lookup(mod.imports[name])
        return None

    def _target(self, mod: _Module, func: ast.AST):
        if isinstance(func, ast.Name):
            return self._named(mod, func.id)
        d = dotted(func)
        if d is not None:
            root, _, rest = d.partition(".")
            if rest and root in mod.imports and root not in mod.defs:
                return self.lookup(f"{mod.imports[root]}.{rest}")
        return None

    def resolve_class(self, mod: _Module, func: ast.AST):
        hit = self._target(mod, func)
        if hit is not None and hit[1] in hit[0].classes:
            return hit
        return None

    def resolve(self, mod: _Module, func: ast.AST,
                local_types: dict | None = None) -> list:
        """The (module, def) pairs a call of ``func`` in ``mod`` may
        reach: functions by name and through the module's imports (a
        class's ``__init__`` for a class), ``self.m``, ``x.m`` where ``x``
        was made by a package class in the same function, and ``obj.m``
        where one class of the package alone defines ``m``."""
        hit = self._target(mod, func)
        if hit is not None:
            tmod, name = hit
            if name in tmod.classes:
                return [(tmod.name, fn)
                        for fn in tmod.classes[name].get("__init__", [])]
            return [(tmod.name, fn) for fn in tmod.defs.get(name, [])]
        if not isinstance(func, ast.Attribute):
            return []
        base, attr = func.value, func.attr
        if isinstance(base, ast.Name):
            if base.id in ("self", "cls"):
                return [(mod.name, fn) for fn in mod.defs.get(attr, [])]
            if local_types and base.id in local_types:
                cmod, cls = local_types[base.id]
                return [(cmod.name, fn)
                        for fn in cmod.classes[cls].get(attr, [])]
            if base.id in mod.imports:
                return []
        if attr.startswith("__") or len(self.methods.get(attr, [])) != 1:
            return []
        return list(self.methods[attr])

    def _reach(self) -> None:
        edges: dict[tuple[str, int], list] = {}
        work: list = []
        for mod in self.modules.values():
            tn = _torch_names(mod.tree)
            bodies = [(None, mod.tree.body)]
            for fns in mod.defs.values():
                for fn in fns:
                    key = (mod.name, fn.lineno)
                    self.returns_tensor[key] = (
                        None if fn.returns is None
                        else _mentions_tensor(fn.returns, tn))
                    bodies.append((key, fn.body))
            for key, body in bodies:
                out = edges.setdefault(key, [])
                local_types = {}
                for node in (n for stmt in body for n in ast.walk(stmt)):
                    if (isinstance(node, ast.Assign)
                            and len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Name)
                            and isinstance(node.value, ast.Call)):
                        cls = self.resolve_class(mod, node.value.func)
                        if cls is not None:
                            local_types[node.targets[0].id] = cls
                for call, in_loop in _calls(body):
                    targets = [(m, fn.lineno) for m, fn in
                               self.resolve(mod, call.func, local_types)]
                    out.extend(targets)
                    if in_loop:
                        work.extend(targets)
        while work:
            key = work.pop()
            if key in self.looped:
                continue
            self.looped.add(key)
            work.extend(edges.get(key, []))


def _package_files(path: Path) -> tuple[list[Path], Path | None]:
    top = None
    d = path.parent
    while (d / "__init__.py").is_file():
        top, d = d, d.parent
    if top is None:
        return [path], None
    return sorted(p for p in top.rglob("*.py")
                  if "__pycache__" not in p.parts), top


@functools.lru_cache(maxsize=4)
def _cached_index(top: Path | None, signature: tuple) -> _Index:
    return _Index([Path(p) for p, _, _ in signature], top)


def _index_for(path: Path) -> tuple[_Index, str]:
    files, top = _package_files(path.resolve())
    signature = []
    for f in files:
        st = f.stat()
        signature.append((str(f), st.st_mtime_ns, st.st_size))
    index = _cached_index(top, tuple(signature))
    return index, _module_name(path.resolve(), top)[0]


# --- taint and emission ------------------------------------------------------


def _is_none_compare(expr: ast.AST) -> bool:
    return (isinstance(expr, ast.Compare)
            and all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops)
            and (any(isinstance(c, ast.Constant) and c.value is None
                     for c in expr.comparators)
                 or (isinstance(expr.left, ast.Constant)
                     and expr.left.value is None)))


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args:
        d = dotted(node.func)
        return bool(d and d.endswith("device")) and _is_cpu(node.args[0])
    return False


def _names_device(node: ast.AST) -> bool:
    """An expression that names a device: a ``cuda`` string, a name or
    attribute called ``device``/``dev``, or a ``torch.device(...)``."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        d = dotted(node.func)
        return bool(d and d.split(".")[-1] == "device")
    d = dotted(node)
    return bool(d) and d.split(".")[-1] in ("device", "dev")


class _FnNode:
    def __init__(self, node: ast.AST, key, looped: bool, tn: _TorchNames):
        self.node = node
        self.key = key
        self.looped = looped
        self.params = [] if node is None else param_names(node)
        self.taint: dict[str, bool] = {p: False for p in self.params}
        if node is not None:
            a = node.args
            for p in (*a.posonlyargs, *a.args, *a.kwonlyargs):
                if _mentions_tensor(p.annotation, tn):
                    self.taint[p.arg] = True

    def taint_param(self, name: str) -> bool:
        if name in self.taint and not self.taint[name]:
            self.taint[name] = True
            return True
        return False


class _Analyzer:
    def __init__(self, ctx: ModuleContext, tn: _TorchNames, index: _Index,
                 mod_name: str):
        self.ctx = ctx
        self.tn = tn
        self.index = index
        self.mod = index.modules.get(mod_name)
        self.mod_name = mod_name
        self.findings: list[Finding] = []
        self.seen: set[tuple[str, int, int]] = set()
        self.changed = False
        self.emitting = False
        self.fns: list[_FnNode] = [_FnNode(None, None, False, tn)]
        self.by_name: dict[str, list[_FnNode]] = {}
        # attributes ``self.X`` that hold a device tensor: set from a
        # tainted value in any method, or annotated as a tensor in a class
        self.self_attrs: set[str] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                for stmt in node.body:
                    if (isinstance(stmt, ast.AnnAssign)
                            and isinstance(stmt.target, ast.Name)
                            and _mentions_tensor(stmt.annotation, tn)):
                        self.self_attrs.add(stmt.target.id)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = (mod_name, node.lineno)
                fn = _FnNode(node, key, key in index.looped, tn)
                self.fns.append(fn)
                self.by_name.setdefault(node.name, []).append(fn)

    def run(self) -> list[Finding]:
        for _ in range(_MAX_FIXPOINT_PASSES):
            self.changed = False
            for fn in self.fns:
                _Walker(self, fn).walk()
            if not self.changed:
                break
        self.emitting = True
        for fn in self.fns:
            _Walker(self, fn).walk()
        return self.findings

    def mark_called(self, fns: list[_FnNode], offset: int,
                    arg_taints: list[bool], kw_taints: dict) -> None:
        for fn in fns:
            pos = positional_params(fn.node)[offset:]
            for i, t in enumerate(arg_taints):
                if t and i < len(pos):
                    self.changed |= fn.taint_param(pos[i])
            for k, t in kw_taints.items():
                if t:
                    self.changed |= fn.taint_param(k)

    def returns(self, func: ast.AST) -> bool | None:
        """True/False when every function a call reaches is annotated to
        return a tensor / something else; None when unknown."""
        if self.mod is None:
            return None
        got = {self.index.returns_tensor.get((m, fn.lineno))
               for m, fn in self.index.resolve(self.mod, func)}
        return got.pop() if len(got) == 1 else None

    def emit(self, rule_id: str, node: ast.AST, message: str) -> None:
        if not self.emitting:
            return
        key = (rule_id, node.lineno, node.col_offset)
        if key in self.seen:
            return
        self.seen.add(key)
        self.findings.append(self.ctx.finding(rule_id, node, message))


class _Walker:
    """One forward pass over one function body (or the module's own
    statements), computing local taint and, on the emission pass, TS
    findings where the code runs in loop scope."""

    def __init__(self, an: _Analyzer, fn: _FnNode):
        self.an = an
        self.fn = fn
        self.env: dict[str, bool] = dict(fn.taint)
        self.masks: set[str] = set()
        self.depth = 0

    @property
    def in_loop(self) -> bool:
        return self.fn.looped or self.depth > 0

    def walk(self) -> None:
        body = (self.an.ctx.tree.body if self.fn.node is None
                else self.fn.node.body)
        self.block(body)

    # -- statements ----------------------------------------------------------

    def block(self, stmts: list[ast.stmt]) -> None:
        for stmt in stmts:
            self.stmt(stmt)

    def loop_block(self, stmts: list[ast.stmt]) -> None:
        self.depth += 1
        self.block(stmts)
        self.block(stmts)  # loop-carried taint
        self.depth -= 1

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, ast.Expr):
            self.taint(node.value)
        elif isinstance(node, ast.Assign):
            t = self.taint(node.value)
            mask = t and self.is_mask(node.value)
            for target in node.targets:
                self.bind(target, t, mask)
        elif isinstance(node, ast.AugAssign):
            t = self.taint(node.value) | self.taint(node.target)
            self.bind(node.target, t)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                t = self.taint(node.value)
                self.bind(node.target, t or _mentions_tensor(
                    node.annotation, self.an.tn))
        elif isinstance(node, (ast.Return, ast.Raise)):
            for child in ast.iter_child_nodes(node):
                self.taint(child)
        elif isinstance(node, ast.If):
            self.check_condition(node.test, "if")
            self.block(node.body)
            self.block(node.orelse)
        elif isinstance(node, ast.While):
            self.depth += 1
            self.check_condition(node.test, "while")
            self.depth -= 1
            self.loop_block(node.body)
            self.block(node.orelse)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self.bind(node.target, self.taint(node.iter))
            self.loop_block(node.body)
            self.block(node.orelse)
        elif isinstance(node, ast.Assert):
            self.check_condition(node.test, "assert")
            if node.msg is not None:
                self.taint(node.msg)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
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
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass  # each def is walked on its own
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

    def bind(self, target: ast.AST, tainted: bool,
             mask: bool = False) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = tainted
            if mask:
                self.masks.add(target.id)
            else:
                self.masks.discard(target.id)
        elif isinstance(target, ast.Subscript):
            self.taint(target.value)
            self.taint(target.slice)
            self.masked(target)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self.bind(elt, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)
        elif isinstance(target, ast.Attribute):
            self.taint(target.value)
            if (tainted and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and target.attr not in self.an.self_attrs):
                self.an.self_attrs.add(target.attr)
                self.an.changed = True

    def check_condition(self, test: ast.expr, kind: str) -> None:
        if self.taint(test) and self.in_loop and not _is_none_compare(test):
            self.an.emit("TS110", test,
                         f"Python `{kind}` on a device tensor inside a loop "
                         "syncs the host on every pass — branch on the "
                         "device (torch.where) or on host values")

    def h2d(self, node: ast.Call, what: str) -> None:
        if self.in_loop and not any(
                kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant)
                and kw.value.value is True for kw in node.keywords):
            self.an.emit("TS103", node,
                         f"{what} copies host data to the device inside a "
                         "loop; a copy from pageable memory syncs the "
                         "host on every pass — copy once before the loop")

    def masked(self, node: ast.Subscript) -> None:
        """``x[mask]`` with a boolean device tensor: the result's size is
        the mask's count, read back before the gather or scatter."""
        parts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                 else [node.slice])
        if self.in_loop and any(self.is_mask(p) for p in parts):
            self.an.emit("TS102", node,
                         "boolean-mask indexing of a device tensor inside a "
                         "loop syncs the host on every pass (the mask's "
                         "count is read back) — keep it on the device "
                         "(torch.where, masked_fill) or do it once after "
                         "the loop")

    def is_mask(self, node: ast.AST) -> bool:
        """A boolean device tensor: a comparison of tensors, a logical
        combination of masks, a name bound to one, or a tensor made or
        cast with ``dtype=torch.bool``."""
        if isinstance(node, ast.Name):
            return node.id in self.masks
        if isinstance(node, ast.Compare):
            return (not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                            ast.NotIn)) for op in node.ops)
                    and (self.taint(node.left)
                         or any([self.taint(c) for c in node.comparators])))
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self.is_mask(node.operand)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(node.left) or self.is_mask(node.right)
        if isinstance(node, ast.Subscript):
            return self.is_mask(node.value)
        if isinstance(node, ast.Call):
            d = dotted(node.func) or ""
            last = d.split(".")[-1]
            if any(kw.arg == "dtype" and (dotted(kw.value) or "").endswith(
                    ".bool") for kw in node.keywords):
                return self.taint(node)
            if isinstance(node.func, ast.Attribute):
                if last in _MASK_KEEPING:
                    return self.is_mask(node.func.value)
                if last == "to" and node.args and (
                        dotted(node.args[0]) or "").endswith(".bool"):
                    return self.taint(node.func.value)
            return last in _MASK_FNS and self.taint(node)
        return False

    def sync(self, node: ast.Call, what: str) -> None:
        if self.in_loop:
            self.an.emit("TS102", node,
                         f"{what} of a device tensor inside a loop syncs "
                         "the host on every pass — keep it on the device "
                         "or read it back once after the loop")

    # -- expressions ---------------------------------------------------------

    def taint(self, node: ast.AST | None) -> bool:
        if node is None or isinstance(node, (ast.Constant, ast.Lambda)):
            return False
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            t = self.taint(node.value)
            if node.attr in _SHAPE_ATTRS:
                return False
            return t or (isinstance(node.value, ast.Name)
                         and node.value.id == "self"
                         and node.attr in self.an.self_attrs)
        if isinstance(node, ast.Subscript):
            t = self.taint(node.value) | self.taint(node.slice)
            self.masked(node)
            return t
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
            identity = all(isinstance(op, (ast.Is, ast.IsNot))
                           for op in node.ops)
            return False if identity else t
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
        if isinstance(node, ast.JoinedStr):
            return any([self.taint(v) for v in node.values])
        if isinstance(node, ast.FormattedValue):
            return self.taint(node.value)
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
        return any([self.taint(c) for c in ast.iter_child_nodes(node)
                    if isinstance(c, ast.expr)])

    def comprehension(self, node: ast.AST) -> bool:
        """Tainted when its elements are: iterating over tensors taints
        the target, not a list of their shapes."""
        for i, gen in enumerate(node.generators):
            it = self.taint(gen.iter)
            if i == 0:
                self.depth += 1
            self.bind(gen.target, it)
            for cond in gen.ifs:
                self.check_condition(cond, "comprehension-if")
        if isinstance(node, ast.DictComp):
            t = self.taint(node.key) | self.taint(node.value)
        else:
            t = self.taint(node.elt)
        self.depth -= 1
        return t

    def call(self, node: ast.Call) -> bool:
        tn = self.an.tn
        d = dotted(node.func)
        arg_taints = [self.taint(a) for a in node.args]
        kw_taints = {kw.arg: self.taint(kw.value)
                     for kw in node.keywords if kw.arg is not None}
        for kw in node.keywords:
            if kw.arg is None:
                self.taint(kw.value)
        any_taint = any(arg_taints) or any(kw_taints.values())

        if d == "print":
            if any_taint:
                self.sync(node, "print()")
            return False
        if d in _HOST_CASTS and arg_taints and arg_taints[0]:
            self.sync(node, f"{d}()")
            return False
        root = d.split(".")[0] if d else None
        if d and (root in tn.numpy):
            if any_taint:
                self.sync(node, f"`{d}`")
            return False
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            recv = self.taint(node.func.value)
            if attr in _SYNC_METHODS and recv:
                self.sync(node, f".{attr}()")
                return False
            if attr == "to":
                dest = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "device"),
                    None)
                if dest is not None and _is_cpu(dest):
                    if recv:
                        self.sync(node, '.to("cpu")')
                    return False
                if dest is not None and _names_device(dest):
                    if not recv:
                        self.h2d(node, ".to(device)")
                    return True
            if attr == "cuda":
                if not recv:
                    self.h2d(node, ".cuda()")
                return True
            if attr in _HOST_METHODS:
                return False
            if d and root in tn.modules:
                return self.torch_call(node, d, any_taint, arg_taints)
            if recv:
                if attr in _SIZE_SYNC_OPS:
                    self.sync(node, f".{attr}() (its size read back)")
                return True
        if d in _UNTAINTED_BUILTINS:
            return False
        if isinstance(node.func, ast.Name):
            if node.func.id in tn.fns:
                return self.torch_call(node, node.func.id, any_taint,
                                       arg_taints)
            if node.func.id in self.an.by_name and node.func.id not in self.env:
                self.an.mark_called(self.an.by_name[node.func.id], 0,
                                    arg_taints, kw_taints)
        elif (isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id in ("self", "cls")):
            self.an.mark_called(self.an.by_name.get(node.func.attr, []), 1,
                                arg_taints, kw_taints)
        if isinstance(node.func, (ast.Subscript, ast.Call)):
            self.taint(node.func)
        annotated = self.an.returns(node.func)
        return annotated if annotated is not None else any_taint

    def torch_call(self, node: ast.Call, d: str, any_taint: bool,
                   arg_taints: list[bool]) -> bool:
        """A call of a torch function: its result is a tensor that may lie
        on the device, unless it is a class, a host query, a tensor made
        from numpy, or a tensor made on the CPU."""
        *mods, name = d.split(".")
        if (name in _TORCH_HOST_FNS or name.startswith(_TORCH_HOST_PREFIXES)
                or _TORCH_HOST_MODULES.intersection(mods) or (
                    name[:1].isupper() and not name.endswith("Tensor")
                    and name != "Parameter")):
            return False
        device = next((kw.value for kw in node.keywords
                       if kw.arg == "device"), None)
        if not any_taint and (
                (device is not None and _is_cpu(device))
                or (device is None and name in _FACTORIES)):
            return False
        if name in _SIZE_SYNC_OPS and arg_taints and arg_taints[0]:
            self.sync(node, f"`torch.{name}` (its size read back)")
        if name in _FROM_DATA and not (arg_taints and arg_taints[0]) and any(
                kw.arg == "device" and not _is_cpu(kw.value)
                for kw in node.keywords):
            self.h2d(node, f"`torch.{name}(..., device=...)`")
        return True


def sync_lines(ctx: ModuleContext) -> dict[int, Finding]:
    """Every line of each TS finding's expression, suppressed or not:
    where the CUDA runtime reports the sync (Python charges a call that
    spans lines to the line of its method's name)."""
    found = analyze(ctx)
    if not found:
        return {}
    ends: dict[tuple[int, int], int] = {}  # the widest expression there
    for n in ast.walk(ctx.tree):
        if isinstance(n, ast.expr):
            at = (n.lineno, n.col_offset)
            ends[at] = max(ends.get(at, 0), n.end_lineno)
    out: dict[int, Finding] = {}
    for f in found:
        for line in range(f.line, ends[(f.line, f.col)] + 1):
            out.setdefault(line, f)
    return out


def analyze(ctx: ModuleContext) -> list[Finding]:
    if _is_test_file(ctx.rel):
        return []
    tn = _torch_names(ctx.tree)
    if not tn.has_torch:
        return []
    index, mod_name = _index_for(ctx.path)
    return _Analyzer(ctx, tn, index, mod_name).run()
