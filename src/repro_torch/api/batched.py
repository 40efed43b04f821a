"""Batched SDCM: the whole (target x level x cores) grid through the
SDCM kernel, and the fused config sweep — port of
``repro/api/batched.py``.

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

:func:`sweep_grid` flips the axes: one profile pair held on the device
(:class:`DeviceProfile`) against C candidate hardware configs, every
(config, level) row a record of the same ragged launch, and the ECM
runtime chain as float64 torch ops on the rates, on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.sdcm import (
    A_BUCKETS,
    META_COLUMNS,
    PROB_META_COLUMNS,
    a_max_bucket,
    sdcm_hit_probs_ragged,
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
    return (torch.from_numpy(d).to(device), torch.from_numpy(pr).to(device))  # repro-lint: disable=TS103 -- per-group SDCM form (pack_grid), the ragged form's check; predicts pack in one pinned copy


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
        geom_t = torch.from_numpy(geom).to(device)  # repro-lint: disable=TS103 -- per-group SDCM form (pack_grid), the ragged form's check; predicts pack in one pinned copy
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
    rates = rates.cpu().numpy()  # repro-lint: disable=TS102 -- one readback per grid evaluation (a predict makes one)
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


# --- fused config sweeps -----------------------------------------------------
#
# The batched grid above amortizes one launch over many (workload,
# target) cells; a config sweep flips the axes: ONE fixed profile pair
# against C candidate hardware configs.  The profiles are packed once and
# stay on the device; each (config, level) row is a 5-column record of
# the ragged form pointing into the PRD or the CRD, so a sweep is one
# launch over C x L records: nothing is padded, and the profile is never
# copied per config.  A row's record carries exactly the entries, length
# and A_MAX bucket that ``grid_rows``/``pack_ragged`` give the same row in
# a predict, so sweep rates equal ``batched_hit_rates`` bit for bit.

#: Ways above this take no A_MAX bucket (the set-associative grid raises,
#: as the reference's ``_bucket`` does); fully associative levels are fine.
A_MAX_LIMIT = A_BUCKETS[-1]


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A reuse profile packed once and held on the device.

    ``d``/``p`` are the float64 ``[m]`` row that :func:`pack_profiles`
    packs for this profile (``m`` its pow2 width, the row's shape key);
    ``n`` is the number of real entries, which a sweep row reads.
    """

    d: torch.Tensor
    p: torch.Tensor
    m: int
    n: int
    total: int


def pack_profile_device(prof, *, device) -> DeviceProfile:
    n = len(prof.distances)
    m = _pow2(max(n, 1))
    d, p = pack_profiles([prof], m, device=device)
    return DeviceProfile(d=d[0], p=p[0], m=m, n=n, total=int(prof.total))


@dataclasses.dataclass(frozen=True)
class SweepGeometry:
    """Host-staged config axes for one sweep (float64 numpy arrays).

    ``[C, L]`` for the per-level axes, ``[C]`` for cores.
    ``trans_beta[:, i]`` is the transfer beta of the boundary INTO level
    i+1 (RAM for the last column), the ``core/incore.py`` convention;
    ``delta`` is the per-level access latency of the latency-mode chain.
    """

    assoc: np.ndarray
    blocks: np.ndarray
    trans_beta: np.ndarray
    delta: np.ndarray
    cores: np.ndarray

    def __post_init__(self):
        c, n = self.assoc.shape
        for name in ("blocks", "trans_beta", "delta"):
            if getattr(self, name).shape != (c, n):
                raise ValueError(f"geometry field {name} shape mismatch")
        if self.cores.shape != (c,):
            raise ValueError("geometry cores shape mismatch")


@dataclasses.dataclass(frozen=True)
class SweepResult:
    rates: np.ndarray            # [C, L] float64
    t_pred_s: np.ndarray | None  # [C] float64 (None without counts)
    dispatches: int              # SDCM kernel calls issued
    compiles: int                # NEW launch shapes recorded


def _sweep_buckets(assoc: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """``[C, L]`` A_MAX buckets: ``_row_shape_key``'s rule
    (:func:`~repro_torch.kernels.sdcm.a_max_bucket`) for every (config,
    level) row at once, so each row runs exactly as it would in
    ``batched_hit_rates``; a set-associative row above 64 ways raises."""
    buckets = np.asarray(A_BUCKETS)
    full = assoc >= blocks
    idx = np.searchsorted(buckets, assoc, side="left")
    over = ~full & (idx >= len(buckets))
    if over.any():
        a_max_bucket(int(assoc[over][0]), int(blocks[over][0]))  # raises
    return np.where(full, buckets[0], buckets[np.minimum(idx, len(buckets) - 1)])


def _chain_body(rates, trans_beta, delta, cores, comp_cy: float,
                lsu_cy: float, mem_ops: float, ram_delta: float,
                cycle_s: float, shared_idx: int, mode: str) -> torch.Tensor:
    """ECM runtime chain over the config axis — ``core/incore.py``'s
    maths as float64 torch ops on the rates' device.

    Per-core counts are the 1/cores share; the chip-wide saturation
    term runs on UNDIVIDED counts over the boundaries at/above the
    shared level, exactly as ``ecm_cycles`` does on the host.
    """
    n_levels = rates.shape[1]
    reach = torch.cummin((1.0 - rates).clamp(0.0, 1.0), dim=1).values
    share = 1.0 / cores.clamp_min(1.0)
    full_transfers = mem_ops * reach * trans_beta        # [C, L] undivided
    if mode == "latency":
        acc = torch.full_like(share, ram_delta)
        for lv in reversed(range(n_levels)):
            pl = rates[:, lv]
            acc = pl * delta[:, lv] + (1.0 - pl) * acc
        core_cy = comp_cy * share + mem_ops * share * acc
    else:
        data = lsu_cy * share + share * full_transfers.sum(dim=-1)
        core_cy = torch.maximum(comp_cy * share, data)
    start = max(shared_idx - 1, 0)
    sat = full_transfers[:, start:].sum(dim=-1)
    return torch.maximum(core_cy, sat) * cycle_s


def _to_device(arrays, device) -> list[torch.Tensor]:
    """Host float64 arrays to ``device`` in one copy (pinned for a card)."""
    device = torch.device(device)
    sizes = [a.size for a in arrays]
    host = torch.empty(sum(sizes), dtype=torch.float64,
                       pin_memory=device.type == "cuda")
    buf, at = host.numpy(), 0
    for a, n in zip(arrays, sizes):
        buf[at:at + n] = a.ravel()
        at += n
    dev, out, at = host.to(device, non_blocking=True), [], 0
    for a, n in zip(arrays, sizes):
        out.append(dev[at:at + n].view(a.shape))
        at += n
    return out


def _ragged_rates(prd: DeviceProfile, crd: DeviceProfile,
                  geom: SweepGeometry, shared_idx: int,
                  buckets: np.ndarray) -> torch.Tensor:
    """[C, L] rates in ONE ``sdcm_rates_ragged`` launch: record
    ``c * L + l`` points into the PRD (levels below the shared one) or
    the CRD region of one resident buffer."""
    c, n_levels = geom.assoc.shape
    on_crd = np.arange(n_levels) >= shared_idx
    meta = np.empty((c, n_levels, len(META_COLUMNS)), dtype=np.float64)
    meta[..., 0] = np.where(on_crd, prd.n, 0)
    meta[..., 1] = np.where(on_crd, crd.n, prd.n)
    meta[..., 2] = geom.assoc
    meta[..., 3] = geom.blocks
    meta[..., 4] = buckets
    (meta_t,) = _to_device([meta.reshape(c * n_levels, -1)], prd.d.device)
    d = torch.cat([prd.d[:prd.n], crd.d[:crd.n]])
    p = torch.cat([prd.p[:prd.n], crd.p[:crd.n]])
    return sdcm_rates_ragged(d, p, meta_t).view(c, n_levels)


@dataclasses.dataclass(frozen=True)
class HitProbsPlan:
    """The records of one ``sweep_grid(inner="pallas")`` call: each
    profile's (0 PRD, 1 CRD) distinct set-associative (assoc, blocks)
    ``sa`` and fully associative ``fa``, one ``sdcm_hit_probs_ragged``
    record per entry of ``sa`` (``meta``, float64 [R, 6], each profile's
    outputs back to back, ``size`` of them in all), and ``which`` [C, L]:
    each (config, level)'s geometry among the profiles' ``sa + fa`` in
    order."""

    sa: tuple[list, list]
    fa: tuple[list, list]
    meta: np.ndarray
    size: int
    which: np.ndarray


def hit_probs_plan(prd: DeviceProfile, crd: DeviceProfile,
                   geom: SweepGeometry, shared_idx: int) -> HitProbsPlan:
    """:class:`HitProbsPlan` of a sweep of ``geom`` on ``prd``/``crd``:
    levels below ``shared_idx`` read the PRD, the rest the CRD; levels on
    one profile share a geometry's record."""
    c, n_levels = geom.assoc.shape
    on = np.where(np.arange(n_levels) < shared_idx, 0, 1)
    pairs = np.stack([geom.assoc, geom.blocks], axis=-1).astype(np.int64)
    keys: tuple[dict, dict] = ({}, {})
    for lv in range(n_levels):
        for a, b in np.unique(pairs[:, lv], axis=0).tolist():
            keys[on[lv]].setdefault((a, b), len(keys[on[lv]]))
    sa = tuple([k for k in ks if k[0] < k[1]] for ks in keys)
    fa = tuple([k for k in ks if k[0] >= k[1]] for ks in keys)
    meta, size = [], 0
    for offset, prof, geoms in zip((0, prd.n), (prd, crd), sa):
        for a, b in geoms:
            meta.append((offset, prof.n, a, b, a_max_bucket(a, b), size))
            size += prof.n
    index = ({k: i for i, k in enumerate(sa[0] + fa[0])},
             {k: len(sa[0]) + len(fa[0]) + i
              for i, k in enumerate(sa[1] + fa[1])})
    which = np.empty((c, n_levels), dtype=np.int64)
    for lv in range(n_levels):
        which[:, lv] = [index[on[lv]][(a, b)] for a, b in pairs[:, lv]]
    return HitProbsPlan(sa, fa, np.asarray(meta, dtype=np.float64).reshape(
        -1, len(PROB_META_COLUMNS)), size, which)


def _hit_probs_rates(prd: DeviceProfile, crd: DeviceProfile,
                     geom: SweepGeometry, shared_idx: int
                     ) -> tuple[torch.Tensor, int, int]:
    """[C, L] rates through B1's per-reference form, as the reference's
    Pallas inner evaluator computes them: P(h|D) of every distinct
    set-associative (profile, assoc, blocks) over the profile's distances
    in float32, all in ONE ``sdcm_hit_probs_ragged`` launch
    (:func:`hit_probs_plan`), then folded as
    ``kernels/sdcm/ops.py::sdcm_hit_rate`` folds (the dot product with the
    weights over ``max(sum(w), 1e-30)``), one matrix-vector product a
    profile; a fully associative geometry takes the exact LRU rule ``[0
    <= D < B]`` without a launch, a profile's together in one mask.
    Returns (rates, launches, new launch shapes)."""
    plan = hit_probs_plan(prd, crd, geom, shared_idx)
    meta_t, fa_b0, fa_b1, which_t = _to_device(
        [plan.meta, *(np.array([b for _, b in fa], dtype=np.float64)
                      for fa in plan.fa), plan.which.astype(np.float64)],
        prd.d.device)
    d32 = torch.cat([prd.d[:prd.n], crd.d[:crd.n]]).to(torch.float32)
    launches = shapes = 0
    if len(plan.meta):
        shapes += _record_signature(("hit_probs_ragged", len(plan.sa[0]),
                                     len(plan.sa[1]), prd.m, crd.m))
        phit = sdcm_hit_probs_ragged(d32, meta_t, plan.size)
        launches += 1
    vals, at, offset = [], 0, 0
    for pi, prof in enumerate((prd, crd)):
        w = prof.p[:prof.n]
        w_sum = w.sum().clamp_min(1e-30)
        n_sa = len(plan.sa[pi])
        if n_sa:
            block = phit[at:at + n_sa * prof.n].view(n_sa, prof.n)
            at += n_sa * prof.n
            vals.append(torch.mv(block.to(torch.float64), w) / w_sum)
        if plan.fa[pi]:
            dp = d32[offset:offset + prof.n]
            fa_b = (fa_b0, fa_b1)[pi]
            # compared in float32, as the reference's jnp.where compares
            hit = (dp >= 0) & (dp[None, :] < fa_b[:, None].float())
            vals.append(torch.mv(hit.to(torch.float64), w) / w_sum)
        offset += prof.n
    return torch.cat(vals)[which_t.long()], launches, shapes


def sweep_grid(prd: DeviceProfile, crd: DeviceProfile,
               geom: SweepGeometry, *, shared_idx: int,
               counts=None, timings=None, cycle_s: float = 1.0,
               ram_delta: float = 0.0, mode: str = "throughput",
               inner: str = "vmap") -> SweepResult:
    """Evaluate C hardware configs against one profile pair on the
    profiles' device.

    Returns per-config [C, L] hit rates, plus per-config predicted
    runtime seconds when ``counts`` (an ``OpCounts``) and ``timings``
    (an ``InCoreTimings``) are given: the SDCM rates and the ECM chain
    on the device, one copy back.

    ``inner="vmap"`` (the reference's name for its default evaluator)
    runs every (config, level) row in one ``sdcm_rates_ragged`` launch,
    bit-identical to ``batched_hit_rates`` on the same rows;
    ``inner="pallas"`` runs B1's per-reference form
    (:func:`_hit_probs_rates`), every distinct set-associative (profile,
    assoc, blocks) in one ``sdcm_hit_probs_ragged`` launch, which agrees
    with it to ~1e-7.  Either way ``dispatches`` is the call's one launch
    (0 when nothing is set-associative).  Each per-level A_MAX-bucket
    group (vmap) or each record count (pallas) records its launch
    signature, so ``compiles`` counts new launch shapes and a repeat sweep
    adds none.
    """
    if inner not in ("vmap", "pallas"):
        raise ValueError(f"unknown sweep inner evaluator: {inner!r}")
    c, n_levels = geom.assoc.shape
    with_runtime = counts is not None
    if with_runtime and timings is None:
        raise ValueError("sweep_grid needs timings when counts are given")
    if c == 0:
        return SweepResult(np.zeros((0, n_levels)),
                           np.zeros(0) if with_runtime else None, 0, 0)

    if inner == "pallas":
        rates_t, dispatches, compiles = _hit_probs_rates(
            prd, crd, geom, shared_idx)
    else:
        buckets = _sweep_buckets(geom.assoc, geom.blocks)
        groups: dict[tuple, int] = {}
        for key in map(tuple, buckets.tolist()):
            groups[key] = groups.get(key, 0) + 1
        compiles = sum(
            _record_signature(("sweep", key, shared_idx, mode, with_runtime,
                               _pow2(n), prd.m, crd.m))
            for key, n in groups.items())
        rates_t = _ragged_rates(prd, crd, geom, shared_idx, buckets)
        dispatches = 1

    if with_runtime:
        from repro_torch.core.incore import t_comp_cy, t_lsu_cy

        trans_beta, delta, cores = _to_device(
            [geom.trans_beta, geom.delta, geom.cores], rates_t.device)
        t = _chain_body(
            rates_t, trans_beta, delta, cores,
            float(t_comp_cy(timings, counts, mode)),
            float(t_lsu_cy(timings, counts)), float(counts.mem_ops),
            float(ram_delta), float(cycle_s), shared_idx, mode,
        )
        out = torch.cat([rates_t, t[:, None]], dim=1).cpu().numpy()  # repro-lint: disable=TS102 -- one readback per sweep_grid call
        rates, t_pred = out[:, :n_levels].copy(), out[:, n_levels].copy()
    else:
        rates, t_pred = rates_t.cpu().numpy().copy(), None  # repro-lint: disable=TS102 -- one readback per sweep_grid call

    if prd.total == 0:
        rates[:, :shared_idx] = 0.0
    if crd.total == 0:
        rates[:, shared_idx:] = 0.0
    return SweepResult(rates, t_pred, dispatches, compiles)
