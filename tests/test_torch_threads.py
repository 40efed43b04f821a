"""The port under threads: a kernel library reached at first use by many
threads is built once and published whole, processes that build at once
each publish a whole file, and launch counts stay exact whatever thread
launches.  (B2's accumulator per stream needs the card:
``tests/test_torch_cuda.py``.)"""
from __future__ import annotations

import ast
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention, reuse_hist, sdcm, ssd_scan

ROOT = Path(__file__).resolve().parents[1]
CHUNK = b"0123456789abcdef" * 64     # 1 KiB a write of the fake compiler
CHUNKS = 8
THREADS = 8

# stands in for nvcc: logs each run, then writes its -o file in pieces
# with pauses between them, so a reader or a second writer of the same
# path would see (or make) a partial file
FAKE_NVCC = f"""#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo run >> "$FAKE_NVCC_LOG"
i=0
while [ $i -lt {CHUNKS} ]; do
  printf '%s' '{CHUNK.decode()}' >> "$out"
  sleep 0.02
  i=$((i + 1))
done
"""


class FakeLibrary:
    """Takes ``ctypes.CDLL``'s place: reads the file it is given."""

    def __init__(self, path):
        self.path = path
        self.data = Path(path).read_bytes()


@pytest.fixture()
def fake_toolchain(tmp_path, monkeypatch):
    """A fake ``nvcc`` on the PATH, a source of its own and an empty
    build directory and library cache."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    src = tmp_path / "fake" / "csrc" / "fake.cu"
    src.parent.mkdir(parents=True)
    src.write_text("// a source the fake compiler never reads\n")
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}:/usr/bin:/bin")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "SOURCES", {"fake": src})
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLibrary)
    return log


def run_threads(fn, n: int = THREADS, timeout: float = 60.0) -> list:
    """``fn()`` on ``n`` threads released together; their results, and
    re-raises the first exception any of them raised."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def go(i):
        barrier.wait()
        try:
            results[i] = fn()
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    if errors:
        raise errors[0]
    return results


def published(build_dir: Path) -> list[Path]:
    return sorted(build_dir.iterdir())


def test_first_use_from_many_threads_builds_once(fake_toolchain):
    libs = run_threads(lambda: build.load("fake"))
    assert fake_toolchain.read_text().splitlines() == ["run"]
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].data == CHUNK * CHUNKS          # whole, written once
    assert published(build.BUILD_DIR) == [build.library_path("fake")]
    # loaded once per process: a later call neither builds nor reloads
    assert build.load("fake") is libs[0]
    assert fake_toolchain.read_text().splitlines() == ["run"]


def test_builds_without_a_shared_lock_each_publish_a_whole_file(
        fake_toolchain):
    """Processes share no lock: two builds of one library at once (the
    unlocked build, as in two spawned workers) stage apart, and the one
    published file is whole with no staging file left."""
    run_threads(lambda: build._build_all(["fake"]), n=2)
    runs = fake_toolchain.read_text().splitlines()
    assert 1 <= len(runs) <= 2
    assert published(build.BUILD_DIR) == [build.library_path("fake")]
    assert build.library_path("fake").read_bytes() == CHUNK * CHUNKS


def test_a_failed_build_leaves_no_staging_file(fake_toolchain, tmp_path):
    (tmp_path / "bin" / "nvcc").write_text("#!/bin/sh\necho broken\nexit 1\n")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.load("fake")
    assert published(build.BUILD_DIR) == []


class YieldingDict(dict):
    """A counter dict whose store gives the interpreter to another thread
    first: the read-add-store window of ``counts[k] += 1`` made as wide as
    a preemption there (or a free-threaded interpreter) makes it."""

    def __setitem__(self, key, value):
        time.sleep(0)
        super().__setitem__(key, value)


COUNTERS = (sdcm.LAUNCHES, reuse_hist.LAUNCHES, ssd_scan.LAUNCHES,
            flash_attention.LAUNCHES, flash_attention.LAUNCHES_BY_FORM)


def test_launch_counts_from_many_threads_lose_nothing():
    """Eight threads bump every kernel's counters 10,000 times each."""
    counts = [YieldingDict.fromkeys(c, 0) for c in COUNTERS]
    names = [(c, name) for c in counts for name in c]
    bumps = 10_000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        def bump():
            for i in range(bumps):
                kernels.count_launch(*names[i % len(names)])

        run_threads(bump)
    finally:
        sys.setswitchinterval(old)
    each = THREADS * bumps // len(names)
    for got, want in zip(counts, COUNTERS):
        assert got == dict.fromkeys(want, each)


KERNEL_MODULES = sorted((ROOT / "src" / "repro_torch" / "kernels")
                        .glob("*/[!_]*.py"))


@pytest.mark.parametrize("path", KERNEL_MODULES,
                         ids=[p.parent.name for p in KERNEL_MODULES])
def test_kernel_wrappers_count_through_the_locked_helper(path):
    """No wrapper adds to a ``LAUNCHES`` dict by ``+=``: every launch is
    counted by ``count_launch``."""
    tree = ast.parse(path.read_text())
    augmented = [
        node.lineno for node in ast.walk(tree)
        if isinstance(node, ast.AugAssign)
        and isinstance(node.target, ast.Subscript)
        and isinstance(node.target.value, ast.Name)
        and node.target.value.id.startswith("LAUNCHES")
    ]
    calls = [
        node for node in ast.walk(tree)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
        and node.func.id == "count_launch"
    ]
    assert not augmented, f"{path.name}: LAUNCHES += at lines {augmented}"
    assert calls, f"{path.name} counts no launch"
