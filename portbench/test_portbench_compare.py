"""The comparison's numbers on made-up digests: which units a fault in
one row, one slot or past the window moves, and which numbers see it."""
from __future__ import annotations

import pytest
import torch

from portbench import compare

LAYERS, BATCH, HKV, D = 4, 4, 2, 8
POSITIONS = [0, 3, 5, 9, 12, 15]
WINDOW = 8


def request(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    shape = (LAYERS, BATCH, len(POSITIONS), HKV, D)
    return {"logits": torch.randn(BATCH, 32, generator=g),
            "digest": {"k": torch.randn(*shape, generator=g),
                       "v": torch.randn(*shape, generator=g)}}


def served(ref: dict, noise: float = 1e-3, seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed + 1000)

    def near(t):
        return t + noise * t.abs().mean() * torch.randn(t.shape, generator=g)

    logits = near(ref["logits"])
    return {"logits": logits, "token": logits.argmax(-1, keepdim=True),
            "digest": {n: near(t) for n, t in ref["digest"].items()}}


def numbers(prog: list, ref: list) -> dict:
    return compare.prefill_numbers(prog, ref, [POSITIONS] * len(ref), WINDOW)


def test_sound_digests_read_their_noise():
    ref = [request(s) for s in range(6)]
    got = numbers([served(r, seed=s) for s, r in enumerate(ref)], ref)
    for name in ("cache_err", "cache_err_row", "cache_err_slot",
                 "cache_err_far"):
        assert 5e-4 < got[name] < 5e-3, (name, got[name])


def test_one_row_wrong_moves_the_row_and_not_the_median():
    ref = [request(s) for s in range(6)]
    prog = [served(r, seed=s) for s, r in enumerate(ref)]
    for t in prog[2]["digest"].values():
        t[:, 1] = -t[:, 1]
    got = numbers(prog, ref)
    assert got["cache_err_row"] > 1 and got["cache_err"] < 5e-3


def test_one_slot_wrong_in_every_request_moves_the_slot():
    ref = [request(s) for s in range(6)]
    prog = [served(r, seed=s) for s, r in enumerate(ref)]
    for p in prog:
        for t in p["digest"].values():
            t[:, BATCH - 1] = 0
    got = numbers(prog, ref)
    assert got["cache_err_slot"] == pytest.approx(1.0)
    assert got["cache_err"] < 5e-3


def test_a_few_units_wrong_in_many_rows_move_neither():
    """As a routing flip does: one position of each row, every layer."""
    ref = [request(s) for s in range(6)]
    prog = [served(r, seed=s) for s, r in enumerate(ref)]
    for p in prog:
        for t in p["digest"].values():
            t[:, :, 1] = -t[:, :, 1]
    got = numbers(prog, ref)
    assert got["cache_err_max"] > 0.3
    for name in ("cache_err", "cache_err_row", "cache_err_slot"):
        assert got[name] < 5e-3, (name, got[name])


def test_past_the_window_reads_only_later_layers_at_far_positions():
    ref = [request(s) for s in range(6)]
    prog = [served(r, seed=s) for s, r in enumerate(ref)]
    far = [j for j, p in enumerate(POSITIONS) if p >= WINDOW]
    for p in prog:
        for t in p["digest"].values():
            t[0] = 0                      # the first layer: not read
            t[1:, :, far] *= 1.5          # later layers, far positions
    got = numbers(prog, ref)
    assert got["cache_err_far"] == pytest.approx(0.5, rel=1e-2)
    no_window = compare.prefill_numbers(prog, ref)
    assert "cache_err_far" not in no_window


def test_a_number_the_run_could_not_read_fails():
    ok, checks = compare.verdict({"cache_err": 0.01},
                                 {"cache_err": 0.1, "cache_err_far": 0.1})
    assert not ok and checks["cache_err_far"]["value"] == compare.INF
