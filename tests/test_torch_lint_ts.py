"""The TS family (``repro_torch.lint``'s host-sync rules for torch code):
true positives and false-positive guards per rule, the loop scope across
a package's modules, the port's own tree, and CC held against the lock
repairs of the port's kernels build, registry and launch counts."""
from __future__ import annotations

import re
import textwrap
from pathlib import Path

import pytest

from repro_torch.lint.analyzers import torch_sync
from repro_torch.lint.engine import ModuleContext, lint_paths

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture
def ts(tmp_path):
    """(rule, line) of every TS finding of a dedented snippet."""

    def run(source: str, name: str = "snippet.py"):
        path = tmp_path / name
        path.write_text(textwrap.dedent(source).lstrip("\n"))
        return [(f.rule_id, f.line)
                for f in lint_paths([path], root=tmp_path).findings
                if f.rule_id.startswith("TS")]

    return run


# -- TS102: host syncs ---------------------------------------------------------

MOE_SHAPE = """
    import torch

    def moe_apply(x: torch.Tensor, experts: torch.Tensor, e: int):
        counts = torch.bincount(experts, minlength=e).tolist()
        out = torch.zeros_like(x)
        for ex, n in enumerate(counts):
            if n == 0:
                continue
            out = out + x * ex
        return out

    def forward(x, layers, e):
        for experts in layers:
            x = moe_apply(x, experts, e)
        return x
"""


@pytest.mark.parametrize("source,want", [
    # the shape of models/moe.py's loop-path count read: the helper runs
    # once per layer
    (MOE_SHAPE, [("TS102", 4)]),
    ("""
        import torch

        def step(xs: list[torch.Tensor]):
            total = 0.0
            for x in xs:
                total += x.sum().item()
            return total
    """, [("TS102", 6)]),
    ("""
        import torch

        def drain(q: torch.Tensor, n: int):
            out = []
            for i in range(n):
                out.append(q[i].cpu().numpy())
            return out
    """, [("TS102", 6)]),
    ("""
        import numpy as np
        import torch

        def f(x: torch.Tensor, n: int):
            for i in range(n):
                a = np.asarray(x[i])
                b = float(x[i])
                c = int(x.max())
                d = bool(x.any())
                print(x)
                e = x.to("cpu")
                g = x[i].tolist()
    """, [("TS102", 6), ("TS102", 7), ("TS102", 8), ("TS102", 9),
          ("TS102", 10), ("TS102", 11), ("TS102", 12)]),
    ("""
        import torch

        def keep(d: torch.Tensor, n: int):
            for _ in range(n):
                ok = d >= 0
                d = d[ok]
                u = torch.unique(d)
                nz = d.nonzero()
        """, [("TS102", 6), ("TS102", 7), ("TS102", 8)]),
    ("""
        import torch

        def rows(x: torch.Tensor):
            return [r.item() for r in x]
    """, [("TS102", 4)]),
], ids=["moe_shape", "item_in_loop", "cpu_numpy_in_loop", "every_form",
        "data_dependent_sizes", "comprehension"])
def test_ts102_flags_syncs_in_loops(ts, source, want):
    assert ts(source) == want


@pytest.mark.parametrize("source", [
    # .shape, .numel(), len() and `is None` in a loop: host values
    """
    import torch

    def f(x: torch.Tensor, n: int):
        out = []
        for i in range(n):
            if x is None or x.shape[0] == 0:
                continue
            out.append(int(x.shape[-1]) + x.numel() + len(x) + x.dim())
        return out
    """,
    # one sync after the loop
    """
    import torch

    def f(x: torch.Tensor, n: int):
        for _ in range(n):
            x = x * 2
        return x.sum().item()
    """,
    # a loop over host readbacks enqueues device work, syncs nothing
    """
    import torch

    def f(x: torch.Tensor, e: int):
        counts = torch.bincount(x, minlength=e).tolist()
        for n in counts:
            if n == 0:
                continue
            x = x + n
        return x
    """,
    # host data: numpy and tensors made from it without a device
    """
    import numpy as np
    import torch

    def f(a: np.ndarray, n: int):
        for i in range(n):
            t = torch.from_numpy(a[i])
            v = float(a[i]) + t.item() + torch.zeros(3).sum().item()
        return v
    """,
    # the same sync in a function no loop reaches
    """
    import torch

    def once(x: torch.Tensor):
        return x.sum().item()
    """,
], ids=["shape_numel_len_none", "sync_after_loop", "loop_over_host_list",
        "host_tensors", "not_in_loop_scope"])
def test_ts102_guards(ts, source):
    assert ts(source) == []


# -- TS103: host-to-device copies ----------------------------------------------


def test_ts103_flags_copies_in_loops(ts):
    assert ts("""
        import numpy as np
        import torch

        def f(chunks, dev: torch.device, n: int):
            out = []
            for a in chunks:
                t = torch.from_numpy(np.asarray(a)).to(dev)
                u = torch.tensor([1, 2], device=dev)
                w = torch.from_numpy(a).cuda()
                out.append(t + u + w)
            return out
    """) == [("TS103", 7), ("TS103", 8), ("TS103", 9)]


def test_ts103_guards(ts):
    assert ts("""
        import numpy as np
        import torch

        def f(chunks, x: torch.Tensor, dev: torch.device):
            staged = torch.from_numpy(np.stack(chunks)).to(dev)
            out = []
            for i in range(len(chunks)):
                y = x.to(dev)
                z = torch.zeros(3, device=dev)
                p = torch.from_numpy(chunks[i]).to(dev, non_blocking=True)
                h = staged[i].to(torch.float32)
                out.append(y + z + p + h)
            return out
    """) == []


# -- TS110: control flow on device tensors -------------------------------------


@pytest.mark.parametrize("source,want", [
    ("""
        import torch

        def f(x: torch.Tensor, n: int):
            for _ in range(n):
                if x.sum() > 0:
                    x = x - 1
            return x
    """, [("TS110", 5)]),
    ("""
        import torch

        def f(x: torch.Tensor):
            while x.any():
                x = x - 1
            return x
    """, [("TS110", 4)]),
    ("""
        import torch

        def f(xs: list[torch.Tensor]):
            for x in xs:
                assert x.isfinite().all()
                y = x if x.max() > 1 else -x
    """, [("TS110", 5), ("TS110", 6)]),
], ids=["if", "while", "assert_and_ifexp"])
def test_ts110_flags_control_flow_in_loops(ts, source, want):
    assert ts(source) == want


def test_ts110_guards(ts):
    assert ts("""
        import torch

        def f(x: torch.Tensor, cache, n: int, flag: bool):
            if x.sum() > 0:          # once, outside any loop
                x = x - 1
            for _ in range(n):
                if cache is None or flag or x.shape[0] > 2:
                    continue
                if x.dtype == torch.float32 and x.ndim == 2:
                    x = x * 2
            return x
    """) == []


# -- scope ---------------------------------------------------------------------


def test_module_without_torch_is_out_of_scope(ts):
    assert ts("""
        import numpy as np

        def f(xs):
            for x in xs:
                x.item()
    """) == []


@pytest.mark.parametrize("name", ["test_snippet.py", "conftest.py"])
def test_test_files_are_out_of_scope(ts, name):
    src = """
        import torch

        def f(xs: list[torch.Tensor]):
            return [x.item() for x in xs]
    """
    assert ts(src, "plain.py") == [("TS102", 4)]
    assert ts(src, name) == []


def test_loop_scope_crosses_the_modules_of_a_package(tmp_path):
    """A helper in one module, its loop in another, reached through
    ``from pkg.layer import apply`` and through a method of a class the
    loop's module makes (the transformer's layer loop over
    ``moe_apply``; the fused histogram's ``profile()``)."""
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "layer.py").write_text(textwrap.dedent("""
        import torch

        def apply(x: torch.Tensor) -> torch.Tensor:
            n = torch.bincount(x).tolist()
            return x * len(n)

        class Hist:
            def __init__(self, device):
                self._h = torch.zeros(4, device=device)

            def read(self):
                return self._h.cpu().numpy()

        def unused(x: torch.Tensor):
            return x.item()
    """).lstrip("\n"))
    (pkg / "stack.py").write_text(textwrap.dedent("""
        from pkg.layer import Hist, apply

        def forward(x, blocks):
            for _ in blocks:
                x = apply(x)
                h = Hist(x.device)
                h.read()
            return x
    """).lstrip("\n"))
    got = [(f.path, f.rule_id, f.line) for f in
           lint_paths([pkg], root=tmp_path).findings]
    assert got == [("pkg/layer.py", "TS102", 4),
                   ("pkg/layer.py", "TS102", 12)]


def test_sync_lines_cover_a_call_that_spans_lines(tmp_path):
    """The card reports a multi-line ``.tolist()`` at the line of
    ``.tolist``; ``sync_lines`` maps every line of the finding's
    expression to it."""
    path = tmp_path / "snippet.py"
    path.write_text(textwrap.dedent("""
        import torch

        def f(xs: list[torch.Tensor], n: int):
            for x in xs:
                c = torch.bincount(x,
                                   minlength=n).tolist()
                y = x + 1
    """).lstrip("\n"))
    ctx = ModuleContext(path, "snippet.py", path.read_text())
    lines = torch_sync.sync_lines(ctx)
    assert sorted(lines) == [5, 6]
    assert {f.rule_id for f in lines.values()} == {"TS102"}


def test_the_port_moe_readback_is_reported():
    """The loop path's per-layer expert counts in ``models/moe.py`` (the
    line of ``torch.bincount(...).tolist()``; the grouped path reads no
    count on the host): TS reports it, suppressed with the ROADMAP item
    that removed it from the serving path."""
    path = PORT / "models" / "moe.py"
    rel = path.relative_to(ROOT).as_posix()
    ctx = ModuleContext(path, rel, path.read_text())
    line = next(i for i, text in enumerate(path.read_text().splitlines(), 1)
                if "torch.bincount(experts" in text)
    assert ".tolist()" in ctx.line_text(line)
    hits = [f for f in torch_sync.analyze(ctx) if f.line == line]
    assert [f.rule_id for f in hits] == ["TS102"]
    assert ctx.suppressed("TS102", line)
    assert "MoE decode reads the expert counts on the host once per " \
           "layer" in ctx.line_text(line)


def test_every_ts_finding_in_the_port_is_suppressed_with_a_reason():
    res = lint_paths([PORT], root=ROOT)
    assert not [f for f in res.findings if f.rule_id.startswith("TS")]
    suppressed = 0
    for path in PORT.rglob("*.py"):
        rel = path.relative_to(ROOT).as_posix()
        ctx = ModuleContext(path, rel, path.read_text())
        for f in torch_sync.analyze(ctx):
            assert ctx.suppressed(f.rule_id, f.line)
            text = ctx.line_text(f.line)
            m = re.search(r"repro-lint: disable=([A-Z0-9,]+) -- (\S.+)$",
                          text)
            assert m and f.rule_id in m.group(1).split(","), (rel, f.line)
            suppressed += 1
    assert suppressed == res.suppressed_by_rule["TS102"] + \
        res.suppressed_by_rule["TS103"] + res.suppressed_by_rule["TS110"]
    assert suppressed >= 30


# -- CC against the port's three lock repairs ----------------------------------

# (file, the lock's `with` line as written) for each repair: the build's
# load/build_all, the registry's population, the launch counts
LOCK_REPAIRS = {
    "kernels/build.py": "with _LOCK:",
    "workloads/registry.py": "with _POPULATE_LOCK:",
    "kernels/__init__.py": "with _COUNT_LOCK:",
}


@pytest.mark.parametrize("rel", sorted(LOCK_REPAIRS))
def test_cc_cannot_see_the_module_level_lock_repairs(rel, tmp_path):
    """Each repair guards module-level state with a module-level lock.
    CC tracks ``self.<attr>`` written under ``with self.<lock>:`` within
    one class, so a copy with the lock taken out gives no CC finding: CC
    cannot hold these repairs (ROADMAP A-12 says so).  The same
    discipline in a class is held: the control case below."""
    src = (PORT / rel).read_text()
    lock = LOCK_REPAIRS[rel]
    assert lock in src
    unlocked = tmp_path / Path(rel).name
    unlocked.write_text(src.replace(lock, "if True:"))
    for path in ((PORT / rel), unlocked):
        got = lint_paths([path], root=path.parent).findings
        assert [f.rule_id for f in got if f.rule_id.startswith("CC")] == []


def test_cc_holds_the_same_discipline_in_a_class(tmp_path):
    """The launch counter's repair written as a class: the count bumped
    under the lock in one method and outside it in another is CC301."""
    path = tmp_path / "counts.py"
    path.write_text(textwrap.dedent("""
        import threading

        class Counts:
            def __init__(self):
                self._lock = threading.Lock()
                self.launches = {}

            def count(self, name):
                with self._lock:
                    self.launches[name] += 1

            def bump(self, name):
                self.launches[name] += 1
    """))
    got = [f.rule_id for f in lint_paths([path], root=tmp_path).findings]
    assert got == ["CC301"]

