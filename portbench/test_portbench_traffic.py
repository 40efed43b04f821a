"""The generator: the same seed gives the same requests and batches, and
every block of requests holds the whole set of lengths."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import core, traffic

MIXES = ["prefill-long", "prefill-chat"]


def mix(name):
    return core.load_json(core.HERE / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = mix(name)
    seed = 2 ** 31 + 12345
    for i in (0, 7, 33):
        a = traffic.prompt(m, seed, i, 32000)
        b = traffic.prompt(m, seed, i, 32000)
        assert np.array_equal(a, b) and a.dtype == np.int32
        assert a.shape == (m["batch"], traffic.request_length(m, seed, i))
    assert not np.array_equal(traffic.prompt(m, seed, 0, 32000)[:, :64],
                              traffic.prompt(m, seed + 1, 0, 32000)[:, :64])


@pytest.mark.parametrize("name", MIXES)
def test_every_block_holds_the_whole_length_set(name):
    m = mix(name)
    lengths = traffic.length_set(m["lengths"])
    assert len(lengths) == m["lengths"]["count"]
    assert lengths[0] == m["lengths"]["min"]
    assert lengths[-1] == m["lengths"]["max"]
    assert all(x % m["lengths"]["multiple"] == 0 for x in lengths)
    n = len(lengths)
    for seed in (1, 99, 2 ** 33 + 5):
        got = [traffic.request_length(m, seed, i) for i in range(4 * n)]
        for b in range(4):
            assert sorted(got[b * n:(b + 1) * n]) == sorted(lengths)
        assert got[:n] != sorted(got[:n]) or seed == 1


def test_train_batches_repeat_and_shift():
    m = mix("train-4k")
    t1, l1 = traffic.train_batch(m, 5, 3, 32000)
    t2, l2 = traffic.train_batch(m, 5, 3, 32000)
    assert np.array_equal(t1, t2) and np.array_equal(l1, l2)
    assert t1.shape == (m["batch"], m["seq"])
    assert np.array_equal(t1[:, 1:], l1[:, :-1])
    assert len({r.tobytes() for r in t1}) == m["batch"]
    t3, _ = traffic.train_batch(m, 5, 4, 32000)
    assert not np.array_equal(t1, t3)
