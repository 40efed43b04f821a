"""What every cell's run shares: finding a cell's files by name, loading
the program, building its model from the benchmark's weights, and the
process's age.

Nothing here names a configuration, a traffic mix or a metric: a cell's
``config`` and ``traffic`` in ``BENCHMARK.json`` name the files
``configs/<config>.json`` and ``traffic/<traffic>.json``; the mix's
``kind`` names its loop ``loops/<kind>.py``; the configuration's
``family`` names its reference ``reference/<family>.py``, its counts
``counts/<family>.py`` and the reading of the program's outputs
``program/<family>.py``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

import torch

from portbench import weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Modules that may not be loaded by a run, compared by the name before
#: the first dot: JAX, and the JAX package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "repro")

_T0 = time.time()


def process_age() -> float:
    """Seconds since this process started (from ``/proc`` where it is
    readable, else since this module was imported)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.time() - _T0


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is banned."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One cell's files, as ``BENCHMARK.json`` names them."""

    name: str
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def family(self) -> str:
        return self.config["family"]

    def module(self, kind: str):
        """``portbench.<kind>.<family>`` (reference, program, counts)."""
        return importlib.import_module(f"portbench.{kind}.{self.family}")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, bench: dict | None = None) -> Cell:
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    return Cell(
        name=workload,
        config=load_json(HERE / "configs" / f"{w['config']}.json"),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
    )


def import_program():
    """Put the program's source tree on the path (it is not installed)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def program_config(cfg: dict, spec=None):
    """The program's architecture spec and its config as the cell runs
    it: the registered architecture ``cfg["arch"]`` (or ``spec``) cut to
    ``cfg["sizes"]["layers"]`` layers, with the fields that the
    configuration file sets (``overrides``, where the program's default
    differs from the source).  Every size the configuration file gives
    must equal the program's, or the run stops."""
    import_program()
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import with_config

    spec = spec or get_arch(cfg["arch"])
    pcfg = with_overrides(cfg, with_config(spec.config,
                                           layers=cfg["sizes"]["layers"]))
    check_sizes(cfg["sizes"], pcfg)
    return spec, pcfg


def with_overrides(cfg: dict, pcfg):
    """``pcfg`` with the configuration file's ``overrides``."""
    return dataclasses.replace(pcfg, **cfg.get("overrides", {}))


def check_sizes(sizes: dict, pcfg) -> None:
    """Every entry of ``sizes`` equals the program config's field (a
    nested dict against a nested config)."""
    def walk(want: dict, have, path: str):
        for key, val in want.items():
            got = getattr(have, key)
            if isinstance(val, dict):
                walk(val, got, f"{path}{key}.")
            elif isinstance(got, torch.dtype):
                if str(got) != f"torch.{val}":
                    raise SystemExit(f"{path}{key}: the program runs {got}, "
                                     f"the configuration states {val}")
            elif got != val:
                raise SystemExit(f"{path}{key}: the program has {got!r}, the "
                                 f"configuration states {val!r}")
    walk(sizes, pcfg, "")


def build_model(fam, pcfg, schema: dict, seed: int, device):
    """The program's model with every parameter drawn by the benchmark
    (``weights.fill_``) from ``seed``: built on the meta device, placed
    on ``device`` uninitialised, then filled in place.  The program's
    parameters and the schema must agree in names, shapes and dtypes."""
    model = fam.init(pcfg, device="meta")
    model.to_empty(device=device)
    params = dict(model.named_parameters())
    if set(params) != set(schema):
        raise SystemExit(
            "the program's parameters differ from the reference's: "
            f"only the program {sorted(set(params) - set(schema))[:5]}, "
            f"only the reference {sorted(set(schema) - set(params))[:5]}")
    for name, p in params.items():
        shape, dtype, init = schema[name]
        if tuple(p.shape) != tuple(shape) or p.dtype != dtype:
            raise SystemExit(f"{name}: the program holds {tuple(p.shape)} "
                             f"{p.dtype}, the reference {tuple(shape)} "
                             f"{dtype}")
        weights.fill_(p.data, init, seed, name)
    return model


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
