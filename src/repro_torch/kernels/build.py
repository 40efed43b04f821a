"""Build the port's CUDA sources into shared libraries at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a library with
a plain C interface, cached under ``build/repro_torch/`` at the root of
the checkout (listed in ``.gitignore``) by a hash of every file in the
source's ``csrc/`` directory (the headers it includes too) and the
flags, and loaded with ``ctypes``.  :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "repro_torch"

#: Every CUDA source of the port, by library name.
SOURCES: dict[str, Path] = {
    "sdcm": _KERNELS / "sdcm" / "csrc" / "sdcm.cu",
    "reuse_hist": _KERNELS / "reuse_hist" / "csrc" / "reuse_hist.cu",
    "flash_attention": (_KERNELS / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "ssd_scan": _KERNELS / "ssd_scan" / "csrc" / "ssd_scan.cu",
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
    file in its source's directory, and the flags."""
    h = hashlib.sha1()
    for path in sorted(SOURCES[name].parent.rglob("*")):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source in
    parallel.  Returns ``{name: {"path", "seconds", "log"}}``; raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
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
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (built first if missing)."""
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))
