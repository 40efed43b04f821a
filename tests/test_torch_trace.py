"""Traces, Alg. 1 mimicry and Alg. 2 interleaving: the port is
bit-identical to the JAX package (both host numpy)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.api.stages import trace_content_id as ref_trace_content_id
from repro.core.trace.interleave import interleave_traces as ref_interleave
from repro.core.trace.mimic import gen_private_traces as ref_mimic
from repro.core.trace.types import trace_from_blocks as ref_trace_from_blocks
from repro.workloads import polybench as ref_pb

from repro_torch import interop
from repro_torch.api.stages import trace_content_id
from repro_torch.core.trace.interleave import interleave_traces
from repro_torch.core.trace.mimic import gen_private_traces
from repro_torch.core.trace.types import trace_from_blocks
from repro_torch.workloads import polybench as pb

# the tensors here are small: one intra-op thread per test worker keeps
# parallel test workers from oversubscribing the host
torch.set_num_threads(1)


def assert_same_trace(port, ref):
    assert np.array_equal(port.addresses, ref.addresses)
    assert port.addresses.dtype == ref.addresses.dtype
    assert np.array_equal(port.bb_ids, ref.bb_ids)
    assert port.bb_ids.dtype == ref.bb_ids.dtype
    assert np.array_equal(port.shared_mask, ref.shared_mask)
    assert np.array_equal(port.inst_ids, ref.inst_ids)
    assert port.bb_names == ref.bb_names


def test_makers_and_presets_match():
    assert list(pb.MAKERS) == list(ref_pb.MAKERS)
    assert pb.SIZE_PRESETS == ref_pb.SIZE_PRESETS


@pytest.mark.parametrize("abbr", list(ref_pb.MAKERS))
def test_polybench_trace_bit_identical_at_default_size(abbr):
    port_w, ref_w = pb.MAKERS[abbr](), ref_pb.MAKERS[abbr]()
    port_t, ref_t = port_w.trace(), ref_w.trace()
    assert_same_trace(port_t, ref_t)
    assert trace_content_id(port_t) == ref_trace_content_id(ref_t)
    assert (port_w.name, port_w.abbr, port_w.domain) == (
        ref_w.name, ref_w.abbr, ref_w.domain)
    assert dataclasses.asdict(port_w.op_counts) == dataclasses.asdict(
        ref_w.op_counts)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", ["round_robin", "chunked", "uniform"])
@pytest.mark.parametrize("cores", [1, 2, 4, 8])
def test_private_and_shared_traces_bit_identical(cores, strategy, seed):
    port_t = pb.make_workload("mvt", "smoke").trace()
    ref_t = ref_pb.make_workload("mvt", "smoke").trace()
    port_p, ref_p = gen_private_traces(port_t, cores), ref_mimic(ref_t, cores)
    assert len(port_p) == len(ref_p) == cores
    for a, b in zip(port_p, ref_p):
        assert_same_trace(a, b)
    kw = dict(seed=seed, chunk_size=5)
    assert_same_trace(interleave_traces(port_p, strategy, **kw),
                      ref_interleave(ref_p, strategy, **kw))


def test_trace_from_blocks_windows_and_interop():
    rng = np.random.default_rng(3)
    blocks = [(f"bb{i % 3}", rng.integers(0, 512, 7) * 8,
               rng.random(7) < 0.5) for i in range(20)]
    port, ref = trace_from_blocks(blocks), ref_trace_from_blocks(blocks)
    assert_same_trace(port, ref)
    assert port.bb_counts == ref.bb_counts
    assert np.array_equal(port.instance_index(), ref.instance_index())
    for a, b in zip(port.windows(16), ref.windows(16)):
        assert_same_trace(a, b)
    assert_same_trace(port.slice(3, 30), ref.slice(3, 30))
    carried = interop.trace_from_arrays(
        ref.addresses, ref.bb_ids, ref.shared_mask, ref.inst_ids,
        ref.bb_names)
    assert_same_trace(carried, ref)
    assert trace_content_id(carried) == ref_trace_content_id(ref)
