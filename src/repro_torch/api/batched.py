"""Batched SDCM: the whole (target x level x cores) grid through the
SDCM kernel — port of ``repro/api/batched.py`` up to its compile
accounting.

Every level profile of every grid cell becomes one row of a padded
``[G, M]`` grid, and the hand-written kernel
(``kernels/sdcm``, :func:`~repro_torch.kernels.sdcm.sdcm_rates`)
evaluates Eq. 1–3 for all rows of a row-shape group in one launch.
Per-row associativity and block count are run-time values; the kernel
is instantiated per A_MAX bucket.  Fully-associative rows (the TPU VMEM
level) take the exact stack rule ``P(h|D) = [D < B]``.

Evaluation is **composition-invariant**, as in the reference: every
row's (A_MAX, M) shape is derived from that row alone and row counts
are padded to powers of two, and the kernel folds each row in a fixed
order, so the bits a profile evaluates to are identical whether it runs
alone or coalesced with arbitrary other rows.

Not ported yet (ROADMAP queue A): ``sweep_grid`` and the fused config
sweeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.sdcm import (
    META_COLUMNS,
    a_max_bucket,
    sdcm_rates_ragged,
)
from repro_torch.kernels.sdcm import pow2 as _pow2


def pack_profiles(profiles, m: int, *, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad a list of ReuseProfiles into (distances [G, M], probs [G, M]),
    float64 tensors on ``device``; ``m`` is the rows' shared pow2 width.

    Padding entries carry distance 0 / probability 0 — they contribute
    nothing to the Eq. 3 fold.
    """
    d = np.zeros((len(profiles), m), dtype=np.float64)
    pr = np.zeros((len(profiles), m), dtype=np.float64)
    for g, p in enumerate(profiles):
        n = len(p.distances)
        d[g, :n] = p.distances
        pr[g, :n] = p.probabilities
    return (torch.from_numpy(d).to(device), torch.from_numpy(pr).to(device))


def _row_shape_key(prof, assoc: int, blocks: int) -> tuple[int, int]:
    """The (a_max bucket, padded M) this row is evaluated under.

    Derived from the ROW alone — never from what else is in the call —
    so a profile's evaluated bits are identical whether it runs in a
    single-request grid or coalesced with other requests.
    Fully-associative rows take the exact stack-rule branch and share
    the smallest bucket.
    """
    return (a_max_bucket(int(assoc), int(blocks)),
            _pow2(max(len(prof.distances), 1)))


@dataclasses.dataclass
class GridGroup:
    """One row-shape group: the inputs of one kernel launch."""

    a_max: int
    rows: list[int]       # indices into the flat row list
    d: torch.Tensor       # float64 [G, M], G = pow2(len(rows))
    probs: torch.Tensor   # float64 [G, M]
    assoc: torch.Tensor   # float64 [G]
    blocks: torch.Tensor  # float64 [G]

    @property
    def signature(self) -> tuple:
        return group_signature(self.a_max, self.d.shape[1], len(self.rows))


def grid_rows(items) -> list[tuple]:
    """(cell index, level name, profile, assoc, blocks) for every level
    of every (target, artifacts) cell."""
    from repro_torch.api.stages import shared_level_index

    rows = []
    for ci, (target, art) in enumerate(items):
        shared_idx = shared_level_index(target)
        for li, lvl in enumerate(target.levels):
            prof = art.crd if li >= shared_idx else art.prd
            rows.append(
                (ci, lvl.name, prof, lvl.effective_assoc, lvl.num_lines)
            )
    return rows


def row_groups(rows) -> dict[tuple[int, int], list[int]]:
    """Row indices by :func:`_row_shape_key`, in first-seen order."""
    groups: dict[tuple[int, int], list[int]] = {}
    for ri, (_ci, _name, prof, assoc, blocks) in enumerate(rows):
        groups.setdefault(_row_shape_key(prof, assoc, blocks), []).append(ri)
    return groups


def group_signature(a_max: int, m: int, rows: int) -> tuple:
    """The reference's launch signature of a row-shape group."""
    return ("grid", a_max, _pow2(rows), m)


def pack_grid(rows, *, device) -> list[GridGroup]:
    """Group rows by :func:`_row_shape_key` and pad each group's row
    count to a power of two with inert rows (probs 0): the inputs of the
    per-group form ``sdcm_rates``."""
    out = []
    for (a_max, m), idxs in row_groups(rows).items():
        g = _pow2(len(idxs))
        pad = g - len(idxs)
        profs = [rows[i][2] for i in idxs]
        d, pr = pack_profiles(profs, m, device=device)
        geom = np.array(
            [(rows[i][3], rows[i][4]) for i in idxs] + [(1, 2)] * pad,
            dtype=np.float64,
        )
        if pad:
            d = torch.cat([d, d.new_zeros(pad, m)])
            pr = torch.cat([pr, pr.new_zeros(pad, m)])
        geom_t = torch.from_numpy(geom).to(device)
        out.append(GridGroup(
            a_max, idxs, d, pr,
            geom_t[:, 0].contiguous(), geom_t[:, 1].contiguous(),
        ))
    return out


def pack_ragged(rows, *, device) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Every row back to back: (distances [T], probs [T], meta [R, 5]),
    float64 on ``device``, views of one buffer filled on the host (in
    pinned memory for a card) and copied in one non-blocking copy.  Row
    ``r`` of ``meta`` is row ``r`` of ``rows``."""
    device = torch.device(device)
    lens = np.array([len(r[2].distances) for r in rows], dtype=np.int64)
    n_rows, total = len(rows), int(lens.sum())
    width = len(META_COLUMNS)
    host = torch.empty(width * n_rows + 2 * total, dtype=torch.float64,
                       pin_memory=device.type == "cuda")
    buf = host.numpy()
    meta = buf[:width * n_rows].reshape(n_rows, width)
    meta[:, 0] = np.cumsum(lens) - lens
    meta[:, 1] = lens
    meta[:, 2] = [r[3] for r in rows]
    meta[:, 3] = [r[4] for r in rows]
    meta[:, 4] = [a_max_bucket(int(r[3]), int(r[4])) for r in rows]
    d = buf[width * n_rows:width * n_rows + total]
    pr = buf[width * n_rows + total:]
    if total:
        np.concatenate([r[2].distances for r in rows], out=d,
                       casting="unsafe")
        np.concatenate([r[2].probabilities for r in rows], out=pr)
    dev = host.to(device, non_blocking=True)
    return (dev[width * n_rows:width * n_rows + total],
            dev[width * n_rows + total:],
            dev[:width * n_rows].view(n_rows, width))


def batched_hit_rates(items, *, device) -> list[dict[str, float]]:
    """Evaluate SDCM for every level of every (target, artifacts) cell
    in one kernel launch on ``device``: one copy of the packed rows to
    the device, one launch, one copy of the rates back.  Returns one
    {level: hit_rate} dict per cell.

    Each row-shape group of the reference is recorded as its launch
    signature, so ``SessionStats.kernel_shapes`` counts what the
    reference's compile accounting counts.
    """
    rows = grid_rows(items)
    if not rows:
        return [{} for _ in items]
    for (a_max, m), idxs in row_groups(rows).items():
        _record_signature(group_signature(a_max, m, len(idxs)))
    rates = sdcm_rates_ragged(*pack_ragged(rows, device=device))
    rates = rates.cpu().numpy()
    # empty-profile rows (total == 0) follow the oracle: hit rate 0
    empty = np.array([r[2].total == 0 for r in rows])
    rates = np.where(empty, 0.0, rates)

    result: list[dict[str, float]] = [{} for _ in items]
    for (ci, name, _prof, _a, _b), rate in zip(rows, rates):
        result[ci][name] = float(rate)
    return result


# --- launch-shape accounting -------------------------------------------------
#
# The reference counts distinct jit compilations per (A_MAX bucket, G,
# M) signature so a warm sweep can assert "compiles nothing".  The
# kernel here is compiled once and launched once per predict, but the
# signature set is kept with the same keys: it counts the distinct
# row-shape groups a session has seen, and a warm sweep must add none
# (``SessionStats.kernel_shapes``).

_SHAPES: set[tuple] = set()


def _record_signature(sig: tuple) -> int:
    """Record a row-shape group's signature; 1 if new."""
    if sig in _SHAPES:
        return 0
    _SHAPES.add(sig)
    return 1


def shape_count() -> int:
    """Number of distinct row-shape group signatures seen so far."""
    return len(_SHAPES)
