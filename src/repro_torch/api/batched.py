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

from repro_torch.kernels.sdcm import a_max_bucket, sdcm_rates


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


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
        return ("grid", self.a_max, self.d.shape[0], self.d.shape[1])


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


def pack_grid(rows, *, device) -> list[GridGroup]:
    """Group rows by :func:`_row_shape_key` and pad each group's row
    count to a power of two with inert rows (probs 0)."""
    groups: dict[tuple[int, int], list[int]] = {}
    for ri, (_ci, _name, prof, assoc, blocks) in enumerate(rows):
        groups.setdefault(_row_shape_key(prof, assoc, blocks), []).append(ri)
    out = []
    for (a_max, m), idxs in groups.items():
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


def batched_hit_rates(items, *, device) -> list[dict[str, float]]:
    """Evaluate SDCM for every level of every (target, artifacts) cell,
    one kernel launch per row-shape group on ``device``.  Returns one
    {level: hit_rate} dict per cell.

    Rows are grouped by :func:`_row_shape_key` and the row count of
    each group is padded to a power of two, so both the launch-shape
    set AND each row's numerics are independent of batch composition.
    """
    rows = grid_rows(items)
    if not rows:
        return [{} for _ in items]
    groups = pack_grid(rows, device=torch.device(device))
    launched = []
    for grp in groups:
        _record_signature(grp.signature)
        launched.append(
            sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        )
    rates = np.zeros(len(rows), dtype=np.float64)
    for grp, out in zip(groups, launched):
        rates[grp.rows] = out[:len(grp.rows)].cpu().numpy()
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
# kernel here is compiled once per A_MAX bucket, but the signature set
# is kept with the same keys: it counts the distinct launch shapes a
# session has seen, and a warm sweep must add none
# (``SessionStats.kernel_shapes``).

_SHAPES: set[tuple] = set()


def _record_signature(sig: tuple) -> int:
    """Record the launch shape a dispatch lands on; 1 if new."""
    if sig in _SHAPES:
        return 0
    _SHAPES.add(sig)
    return 1


def shape_count() -> int:
    """Number of distinct launch shapes seen so far."""
    return len(_SHAPES)
