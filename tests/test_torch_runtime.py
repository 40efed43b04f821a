"""Targets and stage-4 runtime models: the port's tables equal the JAX
package's field by field, and Eq. 4-7, ECM and the roofline give the
same float64 bits over a sweep."""
from __future__ import annotations

import dataclasses
import itertools

import pytest
import torch

from repro.api import stages as ref_stages
from repro.core.runtime_model import OpCounts as RefOpCounts
from repro.hw import targets as ref_targets

from repro_torch import interop
from repro_torch.api import stages
from repro_torch.core.runtime_model import OpCounts
from repro_torch.hw import targets

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)

NAMES = list(ref_targets.ALL_TARGETS)
COUNTS = [
    dict(int_ops=3000, fp_ops=1500, div_ops=10, loads=3000, stores=1500,
         total_bytes=36000),
    dict(int_ops=0, fp_ops=1e9, div_ops=0, loads=2e8, stores=1e7,
         total_bytes=1.68e9),
    dict(int_ops=7, fp_ops=0, div_ops=3, loads=1, stores=0, total_bytes=8),
]
RATES = (0.0, 0.31, 0.9, 0.999, 1.0)


def test_target_registry_names_match():
    assert list(targets.ALL_TARGETS) == NAMES
    assert list(targets.CPU_TARGETS) == list(ref_targets.CPU_TARGETS)


@pytest.mark.parametrize("name", NAMES)
def test_target_tables_equal_field_by_field(name):
    port, ref = targets.ALL_TARGETS[name], ref_targets.ALL_TARGETS[name]
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert [dataclasses.asdict(lv) for lv in port.levels] == [
        dataclasses.asdict(lv) for lv in ref.levels]
    assert port.cores == ref.cores
    assert stages.shared_level_index(port) == ref_stages.shared_level_index(ref)
    assert stages.supported_runtime_models(port) == (
        ref_stages.supported_runtime_models(ref))


@pytest.mark.parametrize("name", NAMES)
def test_interop_target_from_reference_fields(name):
    ref = ref_targets.ALL_TARGETS[name]
    fields = dataclasses.asdict(ref)
    fields.pop("name")
    levels = [dataclasses.asdict(lv) for lv in ref.levels]
    fields.pop("levels", None)
    carried = interop.target_from_fields(ref.name, levels, **fields)
    assert carried == targets.ALL_TARGETS[name]


def test_interop_levels_from_sets_and_latencies():
    ref = ref_targets.HASWELL_I7_5960X
    levels = [
        dict(name=lv.name, sets=lv.num_sets, assoc=lv.assoc,
             line_size=lv.line_size, latency_cy=lat, beta_cy=beta)
        for lv, lat, beta in zip(ref.levels, ref.level_latency_cy,
                                 ref.level_beta_cy)
    ]
    fields = dataclasses.asdict(ref)
    for k in ("name", "levels", "level_latency_cy", "level_beta_cy"):
        fields.pop(k)
    assert interop.target_from_fields(ref.name, levels, **fields) == (
        targets.HASWELL_I7_5960X)


@pytest.mark.parametrize("model", ["eq", "ecm", "roofline"])
@pytest.mark.parametrize("name", NAMES)
def test_runtime_models_bit_identical(name, model):
    ref_t, port_t = ref_targets.ALL_TARGETS[name], targets.ALL_TARGETS[name]
    if model not in ref_stages.supported_runtime_models(ref_t):
        with pytest.raises(ValueError):
            stages.resolve_runtime_model(model, port_t)
        return
    ref_m = ref_stages.resolve_runtime_model(model, ref_t)
    port_m = stages.resolve_runtime_model(model, port_t)
    names = [lv.name for lv in ref_t.levels]
    checked = 0
    for rates in itertools.product(RATES, repeat=len(names)):
        hr = dict(zip(names, rates))
        for counts, cores, mode in itertools.product(
                COUNTS, (1, 3, 8), ("throughput", "latency")):
            kw = dict(mode=mode, gap_bytes=16.0 if cores == 3 else 0.0)
            want = ref_m.runtime(ref_t, hr, RefOpCounts(**counts), cores, **kw)
            got = port_m.runtime(port_t, hr, OpCounts(**counts), cores, **kw)
            assert got == want, (hr, counts, cores, mode)
            checked += 1
    assert checked > 0


@pytest.mark.parametrize("name", NAMES)
def test_default_runtime_model_matches(name):
    ref_m = ref_stages.default_runtime_model(ref_targets.ALL_TARGETS[name])
    port_m = stages.default_runtime_model(targets.ALL_TARGETS[name])
    assert port_m.name == ref_m.name
