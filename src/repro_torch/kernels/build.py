"""Build the port's CUDA sources into shared libraries at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a library with
a plain C interface, cached under ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``) by a hash of every file in the
source's ``csrc/`` directory (the headers it includes too), of the
shared headers in ``kernels/csrc/`` and of the flags, and loaded with
``ctypes``.  :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them.

Threads and processes: one lock serializes :func:`load` and
:func:`build_all` within a process, so threads that reach a library at
first use together build it once.  Every build writes to a staging file
of its own (``tempfile.mkstemp`` in :data:`BUILD_DIR`) and publishes it
with one ``os.replace``, so processes that build the same library at
once each publish a whole file and a reader never sees a partial one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"
#: Headers shared by several sources: on every source's include path.
COMMON = _KERNELS / "csrc"

#: Every CUDA source of the port, by library name.
SOURCES: dict[str, Path] = {
    "sdcm": _KERNELS / "sdcm" / "csrc" / "sdcm.cu",
    "reuse_hist": _KERNELS / "reuse_hist" / "csrc" / "reuse_hist.cu",
    "flash_attention": (_KERNELS / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "ssd_scan": _KERNELS / "ssd_scan" / "csrc" / "ssd_scan.cu",
    "ssd_scan_bwd": _KERNELS / "ssd_scan" / "csrc" / "ssd_scan_bwd.cu",
    "flash_attention_bwd": (_KERNELS / "flash_attention" / "csrc"
                            / "flash_bwd.cu"),
    "moe": _KERNELS / "moe" / "csrc" / "moe.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the port's CUDA kernels "
        "are compiled on the machine that runs them"
    )


def library_path(name: str) -> Path:
    """Where ``name``'s library lands: keyed by the contents of every
    file in its source's directory and in :data:`COMMON`, and the
    flags."""
    h = hashlib.sha1()
    for path in [*sorted(SOURCES[name].parent.rglob("*")),
                 *sorted(COMMON.rglob("*"))]:
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def _staging_file(out: Path) -> Path:
    """A new empty file beside ``out`` that no other thread or process
    writes: the build's output until it is published."""
    fd, tmp = tempfile.mkstemp(dir=out.parent, prefix=f".{out.name}.",
                               suffix=".tmp")
    os.close(fd)
    return Path(tmp)


def build_all(names=None) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source in
    parallel.  Returns ``{name: {"path", "seconds", "log"}}``; raises
    with the compiler's output if any build fails."""
    with _LOCK:
        return _build_all(list(SOURCES) if names is None else list(names))


def _build_all(names: list) -> dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            nvcc = nvcc_path()
            tmp = _staging_file(out)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(COMMON), "-o", str(tmp),
                   str(SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, time.perf_counter())
        report = {n: {"path": library_path(n), "seconds": 0.0, "log": ""}
                  for n in names}
        failed = []
        for name, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            report[name].update(seconds=time.perf_counter() - t0, log=log)
            if proc.returncode:
                failed.append(f"nvcc failed for {SOURCES[name]}:\n{log}")
            else:
                os.replace(tmp, library_path(name))
    finally:
        for proc, tmp, _ in procs.values():
            proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if missing), loaded once
    per process."""
    with _LOCK:
        if name not in _LOADED:
            _build_all([name])
            _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return _LOADED[name]
