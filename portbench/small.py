"""A cell cut to the program's reduced configuration
(``repro_torch/configs/reduced.py``) and to short prompts, for the tests
on the CPU: the same files, loops and references at a size a test
run holds."""
from __future__ import annotations

import dataclasses

import torch

from portbench import core


def small_cell(workload: str, dtype: str = "bfloat16"):
    """``(cell, spec)``: the cell with the reduced architecture's sizes
    and ``dtype``, and that reduced spec, for ``run.run_cell(...,
    spec=spec)``."""
    core.import_program()
    from repro_torch.configs import get_arch
    from repro_torch.configs.reduced import reduced
    from repro_torch.launch.serve import with_config

    cell = core.find_cell(workload)
    spec = reduced(get_arch(cell.config["arch"]))
    spec = dataclasses.replace(spec, config=core.with_overrides(
        cell.config, with_config(spec.config, dtype=getattr(torch, dtype))))
    sizes = {}
    for key, val in cell.config["sizes"].items():
        got = getattr(spec.config, key)
        if isinstance(val, dict):
            sizes[key] = {k: getattr(got, k) for k in val}
        elif isinstance(got, torch.dtype):
            sizes[key] = str(got).split(".")[1]
        else:
            sizes[key] = got
    cell.config = {**cell.config, "sizes": sizes}
    mix = dict(cell.mix)
    if mix["kind"] == "prefill":
        mix.update(lengths={"min": 16, "max": 40, "count": 4, "multiple": 8},
                   check_requests=3, check_span=8)
    else:
        mix.update(seq=32)
    cell.mix = mix
    return cell, spec


def control_cell(workload: str):
    """The cell at its family's ``CONTROL_SIZES`` (declared by
    ``reference/<family>.py``) with prompts of 64-256 tokens, for
    ``control.reading`` (which runs the reference alone); a training
    cell at the reduced sizes of :func:`small_cell`."""
    cell = core.find_cell(workload)
    if cell.mix["kind"] == "train":
        return small_cell(workload)[0]
    cell.config = {**cell.config, "sizes": {
        **cell.config["sizes"], **cell.module("reference").CONTROL_SIZES}}
    cell.mix = {**cell.mix, "check_requests": 4, "check_span": 8,
                "lengths": {"min": 64, "max": 256, "count": 4,
                            "multiple": 32}}
    return cell
