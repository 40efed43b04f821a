"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device; exits non-zero without one.  Phases, each
printing its results on lines of its own, and any failure ends the run
with a non-zero exit:

1. device — the card's name and power limit; builds every CUDA kernel
   of the port from this checkout's sources (one nvcc per source, in
   parallel) and prints the build time and register use.
2. SDCM kernel vs its plain PyTorch version, per-reference form
   (``sdcm_hit_probs``): ~4M seeded distances at every Table-5 level
   geometry, gpu-sm's, A = 1, A = 64 and fully associative.
3. The same, grid form (``sdcm_rates``): 4096 mixed-shape rows, plus
   composition invariance (every row alone gives the bits it gives
   inside the batch).
4. The offline reuse-distance engine on the card against the same
   torch ops on the CPU, bit for bit, at 1M references.
5. The reuse-histogram kernel (both flags: ``reuse_histogram_moments``
   and ``reuse_histogram``) against its plain version on 2^24 seeded
   distances plus every power of two and 2^k - 1 up to 2^30 and values
   past 2^31, with unit and fractional weights: counts exact, unit-weight
   masses exact below 2^53, the rest within rtol 1e-12, and two launches
   bit-identical.
6. Streaming reuse distances on the card (windows of 2^14 and 2^18) bit
   for bit against the in-memory engine on the card, at 1M references.
7. The main path: ``Session(cache_model=AnalyticalSDCM("batched"),
   device="cuda").predict`` on polybench atx at ``validation-xxl``
   (1,082,640 references) over the three Table-5 CPUs x cores
   {1, 2, 4, 8} x round_robin, with the workload's op counts.  The
   SDCM kernel's launch count and the reuse-distance device are read
   around that run; hit rates are held against the float64 oracle
   (``backend="numpy"``) on the same profiles.
8. The binned main path: the same request through
   ``Session(binned=True)``; hit rates within 1e-3 of the exact
   predict and within 1e-6 of the float64 oracle on the binned
   profiles, the SDCM kernel against its plain version at this path's
   row groups, the reuse-histogram kernel's launches read around the
   run, and the kernel timed on that path's own distance tensor.
9. The streaming main path: the same request with
   ``window_size=STREAM_WINDOW``, exact (``to_json()`` equal to the
   in-memory predict) and binned (profiles equal to the in-memory
   binned ones, hit rates against the oracle and the SDCM kernel
   against its plain version as in 8, and the reuse-histogram kernel
   against its plain version on every window of the 8-core shared
   stream).  More validation-xxl workloads follow while time allows.

The last lines are the ``{"kernels": [...]}`` record, the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TABLE5 = ("i7-5960X", "Xeon E5-2699 v4", "EPYC 7702P")
CORES = (1, 2, 4, 8)
MAIN_WORKLOAD = "atx"
MORE_WORKLOADS = ("mvt", "2mm", "c2d")
SIZES = "validation-xxl"
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP64 (non-tensor)
# operations/s; the SDCM kernel computes in double.
PEAK_BYTES_S = 3.35e12
PEAK_FP64_S = 34e12
# operations counted per evaluated binomial term: one log, one exp and
# six arithmetic operations (each transcendental counted as one)
OPS_PER_TERM = 8
RATE_TOL = 1e-6       # kernel vs plain and vs the float64 oracle, hit rates
PHIT_TOL = 1e-6       # kernel vs plain, P(h|D) (float32 output)
BINNED_TOL = 1e-3     # binned vs exact hit rates (the reference's gate)
HIST_RTOL = 1e-12     # reuse histogram, sums that are not exact integers
EXACT_SUM = float(1 << 53)  # below this, integer sums in double are exact
HIST_N = 1 << 24      # distances of the reuse-histogram phase
STREAM_WINDOW = 1 << 16     # window of the streaming main path
TIME_BUDGET_S = 500   # more workloads at the end only while under this


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=float), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phit_terms(d: np.ndarray, assoc: np.ndarray, blocks: np.ndarray) -> int:
    """Binomial terms the data needs: A per set-associative element
    past the D <= A-1 plateau, none elsewhere."""
    busy = (d >= 0) & (assoc < blocks) & (d > assoc - 1)
    return int(np.where(busy, assoc, 0).sum())


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP64_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def geometries():
    from repro_torch.hw.targets import ALL_TARGETS

    geoms = []
    for name in TABLE5 + ("gpu-sm", "tpu-v5e"):
        for lvl in ALL_TARGETS[name].levels:
            geoms.append((lvl.effective_assoc, lvl.num_lines))
    geoms += [(1, 512), (64, 4096), (8, 8)]
    return list(dict.fromkeys(geoms))


def phase_device():
    from repro_torch.kernels import build

    smi = nvidia_smi()
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    report = build.build_all()
    wall = time.perf_counter() - t0
    for name, rec in report.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        line("build", kernel=name, seconds=rec["seconds"], ptxas=regs)
    line("build", wall_seconds=wall)
    return smi


def phase_hit_probs(n: int = 1 << 22, seed: int = 0):
    from repro_torch.kernels.sdcm import sdcm_hit_probs, sdcm_hit_probs_plain

    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n)
    d = np.where(kind == 0, -1,
        np.where(kind == 1, rng.integers(0, 64, n),
        np.where(kind == 2, rng.integers(0, 4096, n),
                 rng.integers(0, 2_000_000, n)))).astype(np.float32)
    dt = torch.from_numpy(d).cuda()
    rows = []
    for assoc, blocks in geometries():
        got = sdcm_hit_probs(dt, assoc, blocks)
        want = sdcm_hit_probs_plain(dt, assoc, blocks)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not np.isfinite(err) or err > PHIT_TOL:
            fail(f"sdcm_hit_probs assoc={assoc} blocks={blocks}: "
                 f"max |kernel - plain| = {err} > {PHIT_TOL}")
        ms = cuda_ms(lambda: sdcm_hit_probs(dt, assoc, blocks))
        plain_ms = cuda_ms(lambda: sdcm_hit_probs_plain(dt, assoc, blocks),
                           reps=3, warmup=1)
        terms = phit_terms(d, np.full(n, assoc), np.full(n, blocks))
        b_ms, b_by = bound_ms(8.0 * n, terms * OPS_PER_TERM)
        rec = dict(assoc=assoc, blocks=blocks, n=n, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        line("hit_probs", **rec)
        rows.append(rec)
    return rows


def phase_reuse_distances(n: int = 1 << 20, seed: int = 2):
    """The offline reuse-distance engine on the card against the same
    torch ops on the CPU (held to the JAX reference by the CPU tests)."""
    from repro_torch.core.reuse.distance import reuse_distances

    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, n // 8, n) * 8
    t0 = time.perf_counter()
    got = reuse_distances(addrs, 64, device="cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = reuse_distances(addrs, 64, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not torch.equal(got.cpu(), want):
        fail("reuse distances on the card differ from the CPU pass")
    line("reuse_distances", n=n, bit_identical=True, gpu_s=gpu_s,
         cpu_s=cpu_s)


def random_rows(g: int, seed: int):
    """(cell, level, profile, assoc, blocks) rows of mixed shape."""
    from repro_torch.core.reuse.profile import ReuseProfile

    rng = np.random.default_rng(seed)
    geoms = geometries()
    rows = []
    for i in range(g):
        m = int(rng.integers(1, 257))
        dist = np.unique(rng.integers(0, 1_500_000, m))
        if rng.random() < 0.7:
            dist = np.concatenate([[-1], dist[1:]])
        counts = rng.integers(1, 10_000, len(dist)).astype(np.int64)
        prof = ReuseProfile(dist.astype(np.int64), counts, int(counts.sum()))
        assoc, blocks = geoms[int(rng.integers(0, len(geoms)))]
        rows.append((i, "L", prof, assoc, blocks))
    return rows


def phase_rates(g: int = 4096, seed: int = 1):
    from repro_torch.api.batched import pack_grid
    from repro_torch.kernels.sdcm import sdcm_rates, sdcm_rates_plain

    rows = random_rows(g, seed)
    groups = pack_grid(rows, device="cuda")
    batch = np.zeros(g)
    err = 0.0
    for grp in groups:
        got = sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        want = sdcm_rates_plain(grp.d, grp.probs, grp.assoc, grp.blocks,
                                grp.a_max)
        err = max(err, float((got - want).abs().max()))
        batch[grp.rows] = got[:len(grp.rows)].cpu().numpy()
    if not np.isfinite(err) or err > RATE_TOL:
        fail(f"sdcm_rates: max |kernel - plain| = {err} > {RATE_TOL}")
    mismatched = 0
    for i, row in enumerate(rows):
        (grp,) = pack_grid([row], device="cuda")
        alone = sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks,
                           grp.a_max)[0].item()
        mismatched += alone != batch[i]
    if mismatched:
        fail(f"composition invariance: {mismatched} of {g} rows give "
             "other bits alone than inside the batch")
    line("rates", rows=g, groups=len(groups), max_abs_err=err,
         composition_invariant_rows=g)


def main_path_session(workload: str, **session_kw):
    from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
    from repro_torch.workloads.polybench import make_workload

    w = make_workload(workload, SIZES)
    req = PredictionRequest(targets=TABLE5, core_counts=CORES,
                            strategies=("round_robin",), counts=w.op_counts)
    sess = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cuda", **session_kw)
    return w, req, sess


def path_items(sess, w, req) -> list:
    """(target, artifacts) of every cell of ``req``, as the SDCM stage
    of ``sess.predict`` sees them."""
    return [
        (cell.target, sess.artifacts(w, cell.cores, strategy=cell.strategy,
                                     line_size=cell.target.levels[0].line_size))
        for cell in req.cells()
    ]


def path_groups(sess, w, req) -> list:
    """The SDCM kernel's row groups of one predict of ``req``."""
    from repro_torch.api.batched import grid_rows, pack_grid

    return pack_grid(grid_rows(path_items(sess, w, req)), device="cuda")


def sdcm_at_path_shapes(groups, tag: str) -> float:
    """``sdcm_rates`` against its plain version on one path's row
    groups; returns the max |kernel - plain|."""
    from repro_torch.kernels.sdcm import sdcm_rates, sdcm_rates_plain

    err = 0.0
    for grp in groups:
        args = (grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        err = max(err, float((sdcm_rates(*args)
                              - sdcm_rates_plain(*args)).abs().max()))
    if not err <= RATE_TOL:
        fail(f"sdcm_rates at {tag} shapes: {err} > {RATE_TOL}")
    return err


def check_against_oracle(sess, w, req, res, tag: str) -> float:
    from repro_torch.api import AnalyticalSDCM

    oracle = AnalyticalSDCM(backend="numpy").hit_rates_grid(
        path_items(sess, w, req))
    worst = 0.0
    for pred, want in zip(res, oracle):
        for lvl, rate in want.items():
            got = pred.hit_rates[lvl]
            worst = max(worst, abs(got - rate))
            if not np.isfinite(got) or abs(got - rate) > RATE_TOL:
                fail(f"{tag} {pred.target} cores={pred.cores} {lvl}: "
                     f"batched {got} vs oracle {rate}")
        t = pred.t_pred_s
        if t is None or not np.isfinite(t) or t <= 0:
            fail(f"{tag} {pred.target} cores={pred.cores}: t_pred_s={t}")
    return worst


def phase_main_path():
    from repro_torch.kernels.sdcm import sdcm_rates, sdcm_rates_plain

    w, req, sess = main_path_session(MAIN_WORKLOAD)

    reset_counts()
    t0 = time.perf_counter()
    res = sess.predict(w, req)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = read_counts()
    launches, passes = counts["launches"], counts["rd_passes"]
    cold_stages = dict(sess.stage_seconds)
    cold_stats = dict(vars(sess.stats))
    peak = counts["max_memory_allocated"]

    if launches["sdcm_rates"] <= 0:
        fail(f"main path launched no SDCM kernel: {launches}")
    if passes.get("cuda", 0) <= 0 or passes.get("cpu", 0):
        fail(f"reuse distances not computed on the GPU: {passes}")

    t0 = time.perf_counter()
    res_warm = sess.predict(w, req)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_stages = {k: v - cold_stages.get(k, 0.0)
                   for k, v in sess.stage_seconds.items()}
    if res_warm.to_json() != res.to_json():
        fail("warm predict differs from cold predict")
    worst = check_against_oracle(sess, w, req, res, MAIN_WORKLOAD)
    line("main_path", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         refs=len(sess.load(w)[1]), cells=len(res), cold_s=cold_s,
         warm_s=warm_s, cold_stage_s=cold_stages, warm_stage_s=warm_stages,
         max_memory_allocated=peak, stats=cold_stats,
         launches=launches, rd_passes=passes,
         max_abs_err_vs_oracle=worst)
    print(res.to_table(), flush=True)

    # the kernel at the main path's own shapes: one predict's SDCM stage
    groups = path_groups(sess, w, req)
    ms = plain_ms = 0.0
    err = sdcm_at_path_shapes(groups, MAIN_WORKLOAD)
    nbytes = ops = 0.0
    for grp in groups:
        args = (grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        ms += cuda_ms(lambda: sdcm_rates(*args), reps=200, warmup=10)
        plain_ms += cuda_ms(lambda: sdcm_rates_plain(*args), reps=20)
        g, m = grp.d.shape
        nbytes += 8.0 * (2 * g * m + 3 * g)
        d = grp.d.cpu().numpy()
        a = np.broadcast_to(grp.assoc.cpu().numpy()[:, None], d.shape)
        b = np.broadcast_to(grp.blocks.cpu().numpy()[:, None], d.shape)
        ops += phit_terms(d, a, b) * OPS_PER_TERM + 2.0 * g * m
    b_ms, b_by = bound_ms(nbytes, ops)
    line("main_path_kernel", groups=[list(g.signature[1:]) for g in groups],
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         max_abs_err=err)
    return res, {
        "name": "sdcm_rates",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdcm/csrc/sdcm.cu",
        "replaces": "src/repro/kernels/sdcm/sdcm.py:32",
        "launches": launches["sdcm_rates"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }


# --- the reuse-histogram kernel (B2/B3) --------------------------------------


def hist_distances(n: int, seed: int) -> np.ndarray:
    """``n`` seeded distances, log-uniform below 2^28 with a tenth
    first touches, then a few hundred edge values: -1, 0, 1, every 2^k
    and 2^k - 1 up to 2^30, and values past 2^31.  Values >= 2^50
    appear once each, so every bin's unit-weight sum is an exact integer
    or the rounding of a sum of two."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 29, n)
    d = (rng.random(n) * np.exp2(bits)).astype(np.int64)
    d[rng.random(n) < 0.1] = -1
    edges = [-1, 0, 1] + [1 << k for k in range(31)] + [
        (1 << k) - 1 for k in range(2, 31)] + [
        (1 << 31) + 1, 1 << 32, 3 << 33, (1 << 40) + 7, 1 << 45]
    tail = [(1 << 52) - 1, 1 << 62, (1 << 63) - 1]
    extra = np.array(edges * 4 + tail, dtype=np.int64)
    return np.concatenate([d[: n - extra.size], extra])


def check_hist(got: torch.Tensor, want: torch.Tensor, unit: bool,
               tag: str) -> float:
    """Counts (and unit-weight sums below 2^53) exact; every other sum
    within ``HIST_RTOL``.  Returns the max |kernel - plain|."""
    got, want = got.reshape(-1, 64), want.reshape(-1, 64)
    if unit:
        exact = want.abs() < EXACT_SUM
        exact[0] = True  # counts
        if not torch.equal(got[exact], want[exact]):
            fail(f"{tag}: exact sums differ from the plain version")
    rel = ((got - want).abs() / want.abs().clamp_min(1e-300)).max().item()
    if not rel <= HIST_RTOL:
        fail(f"{tag}: relative error {rel} > {HIST_RTOL}")
    return float((got - want).abs().max())


def time_hist(d: torch.Tensor, w, moments: bool) -> dict:
    """Kernel, plain and library times of one histogram, its bound and
    its max |kernel - plain|.  The library call is ``torch.bincount``
    over bins computed beforehand (it leaves the binning pass out)."""
    from repro_torch.kernels import reuse_hist as rh

    fn = rh.reuse_histogram_moments if moments else rh.reuse_histogram
    plain = (rh.reuse_histogram_moments_plain if moments
             else rh.reuse_histogram_plain)
    err = check_hist(fn(d, w), plain(d, w), w is None,
                     f"{fn.__name__} n={d.numel()}")
    bins = rh.bin_ids_plain(d)
    wt = (torch.ones(d.numel(), dtype=torch.float64, device=d.device)
          if w is None else w.to(torch.float64))
    wd = wt * d.clamp_min(0).to(torch.float64)

    def library():
        torch.bincount(bins, weights=wt, minlength=rh.NUM_BINS)
        if moments:
            torch.bincount(bins, weights=wd, minlength=rh.NUM_BINS)

    out_bytes = 8.0 * rh.NUM_BINS * (2 if moments else 1)
    in_bytes = 8.0 * d.numel() + (0.0 if w is None else 4.0 * d.numel())
    b_ms, b_by = bound_ms(in_bytes + out_bytes, 0.0)
    return dict(
        n=d.numel(), weights="unit" if w is None else "fractional",
        max_abs_err=err, ms=cuda_ms(lambda: fn(d, w)),
        plain_ms=cuda_ms(lambda: plain(d, w), reps=5, warmup=1),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(library),
    )


def phase_reuse_hist(seed: int = 3):
    from repro_torch.kernels import reuse_hist as rh

    d = torch.from_numpy(hist_distances(HIST_N, seed)).cuda()
    w = torch.from_numpy(np.random.default_rng(seed + 1).random(
        HIST_N).astype(np.float32)).cuda()
    for moments in (True, False):
        fn = rh.reuse_histogram_moments if moments else rh.reuse_histogram
        first, second = fn(d), fn(d)
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            fail(f"{fn.__name__}: two launches differ on unit weights")
        for weights in (None, w):
            line("reuse_hist", kernel=fn.__name__, bit_reproducible=True,
                 **time_hist(d, weights, moments))


def phase_streaming_distances(n: int = 1 << 20, seed: int = 4):
    """Streaming reuse distances on the card against the in-memory
    offline engine on the card, bit for bit."""
    from repro_torch.core.reuse.distance import (
        reuse_distances,
        reuse_distances_streaming,
    )

    rng = np.random.default_rng(seed)
    addrs = rng.integers(0, n // 8, n) * 8
    whole = reuse_distances(addrs, 64, device="cuda")
    for ws in (1 << 14, 1 << 18):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = reuse_distances_streaming(addrs, 64, window_size=ws,
                                        device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if got.device.type != "cuda" or not torch.equal(got, whole):
            fail(f"streaming reuse distances (window {ws}) differ from "
                 "the in-memory pass")
        line("streaming_distances", n=n, window_size=ws,
             bit_identical=True, seconds=secs)


# --- binned and streaming main paths -----------------------------------------


def reset_counts():
    from repro_torch.core.reuse import distance
    from repro_torch.kernels import reuse_hist, sdcm

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in (sdcm.LAUNCHES, reuse_hist.LAUNCHES):
        for k in counts:
            counts[k] = 0
    distance.PASSES.clear()
    distance.WINDOWS.clear()


def read_counts() -> dict:
    from repro_torch.core.reuse import distance
    from repro_torch.kernels import reuse_hist, sdcm

    torch.cuda.synchronize()
    return dict(launches={**sdcm.LAUNCHES, **reuse_hist.LAUNCHES},
                rd_passes=dict(distance.PASSES),
                rd_windows=dict(distance.WINDOWS),
                max_memory_allocated=torch.cuda.max_memory_allocated())


def drive(tag: str, needs: tuple, **session_kw):
    """One cold and one warm predict of the main request through
    ``Session(**session_kw)``, with every count set to 0 just before
    the cold run and read just after it."""
    w, req, sess = main_path_session(MAIN_WORKLOAD, **session_kw)
    reset_counts()
    t0 = time.perf_counter()
    res = sess.predict(w, req)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = read_counts()
    cold_stages = dict(sess.stage_seconds)
    for name in needs:
        if counts["launches"][name] <= 0:
            fail(f"{tag} launched no {name} kernel: {counts['launches']}")
    passes = counts["rd_passes"]
    if passes.get("cuda", 0) <= 0 or passes.get("cpu", 0):
        fail(f"{tag}: reuse distances not computed on the GPU: {passes}")
    t0 = time.perf_counter()
    res_warm = sess.predict(w, req)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if res_warm.to_json() != res.to_json():
        fail(f"{tag}: warm predict differs from cold predict")
    line(tag, workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         session=session_kw, cells=len(res), cold_s=cold_s, warm_s=warm_s,
         cold_stage_s=cold_stages,
         warm_stage_s={k: v - cold_stages.get(k, 0.0)
                       for k, v in sess.stage_seconds.items()},
         stats=dict(vars(sess.stats)), **counts)
    return w, req, sess, res, counts


def close_to_exact(res, exact, tag: str) -> float:
    worst = 0.0
    for got, want in zip(res, exact):
        for lvl, rate in want.hit_rates.items():
            diff = abs(got.hit_rates[lvl] - rate)
            worst = max(worst, diff)
            if not np.isfinite(got.hit_rates[lvl]) or diff >= BINNED_TOL:
                fail(f"{tag} {got.target} cores={got.cores} {lvl}: "
                     f"{got.hit_rates[lvl]} vs exact {rate}")
    return worst


def path_checks(sess, w, req, res, tag: str) -> dict:
    """The SDCM stage of one path held against the float64 oracle on
    that path's own profiles, and the kernel against its plain version
    at that path's row groups."""
    groups = path_groups(sess, w, req)
    return dict(
        max_abs_err_vs_oracle=check_against_oracle(sess, w, req, res, tag),
        sdcm_groups=[list(g.signature[1:]) for g in groups],
        sdcm_max_abs_err=sdcm_at_path_shapes(groups, tag),
    )


def phase_binned_main_path(exact):
    from repro_torch.core.reuse.distance import reuse_distances

    w, req, sess, res, counts = drive(
        "binned_main_path", ("reuse_hist_moments", "sdcm_rates"),
        binned=True)
    worst = close_to_exact(res, exact, "binned")
    checks = path_checks(sess, w, req, res, "binned")
    line("binned_vs_exact", max_abs_diff=worst, tol=BINNED_TOL, **checks)
    # the kernel on the path's own input: one profile's distance tensor
    d = reuse_distances(sess.load(w)[1].addresses, 64, device="cuda")
    records = []
    for moments, name, src_line in ((True, "reuse_hist_moments", 74),
                                    (False, "reuse_hist", 39)):
        rec = time_hist(d, None, moments)
        line("binned_main_path_kernel", kernel=name, **rec)
        records.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/kernels/reuse_hist/csrc/reuse_hist.cu",
            "replaces": f"src/repro/kernels/reuse_hist/reuse_hist.py:{src_line}",
            "launches": counts["launches"][name],
            **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
        })
    return sess, records, {"sdcm_rates": checks["sdcm_max_abs_err"]}


def window_hist_checks(sess, w, cores: int) -> dict:
    """``reuse_hist_moments`` against its plain version on every window
    of the ``cores``-core shared stream of the streaming path, at the
    windows' own sizes (counts and sums exact)."""
    from repro_torch.core.reuse.distance import reuse_distance_windows_device
    from repro_torch.core.trace.interleave import interleave_windows
    from repro_torch.kernels import reuse_hist as rh

    art = sess.artifacts(w, cores, strategy="round_robin", line_size=64)
    wins = interleave_windows(art.privates, "round_robin",
                              window_size=STREAM_WINDOW)
    err, sizes = 0.0, []
    for d in reuse_distance_windows_device(wins, 64,
                                           window_size=STREAM_WINDOW,
                                           device="cuda"):
        sizes.append(d.numel())
        err = max(err, check_hist(rh.reuse_histogram_moments(d),
                                  rh.reuse_histogram_moments_plain(d), True,
                                  f"streaming window {len(sizes)}"))
    return dict(cores=cores, windows=len(sizes), smallest=min(sizes),
                largest=max(sizes), max_abs_err=err)


def phase_streaming_main_path(exact, binned_sess) -> dict:
    """Both streaming paths; returns each kernel's worst |kernel -
    plain| at these paths' own inputs."""
    _, _, _, res, _ = drive("streaming_main_path", ("sdcm_rates",),
                            window_size=STREAM_WINDOW)
    if res.to_json() != exact.to_json():
        fail("exact streaming predict differs from the in-memory one")
    line("streaming_vs_in_memory", bit_identical=True)
    w, req, sess, res_b, _ = drive(
        "binned_streaming_main_path", ("reuse_hist_moments", "sdcm_rates"),
        binned=True, window_size=STREAM_WINDOW)
    for cell in req.cells():
        kw = dict(strategy=cell.strategy,
                  line_size=cell.target.levels[0].line_size)
        a = sess.artifacts(w, cell.cores, **kw)
        b = binned_sess.artifacts(w, cell.cores, **kw)
        for pa, pb in ((a.prd, b.prd), (a.crd, b.crd)):
            if not (np.array_equal(pa.distances, pb.distances)
                    and np.array_equal(pa.counts, pb.counts)):
                fail(f"binned streaming profile (cores={cell.cores}) "
                     "differs from the in-memory binned one")
    checks = path_checks(sess, w, req, res_b, "binned streaming")
    hist = window_hist_checks(sess, w, max(CORES))
    line("binned_streaming_vs_binned", profiles_equal=True,
         max_abs_diff_vs_exact=close_to_exact(res_b, exact,
                                              "binned streaming"),
         window_hist=hist, **checks)
    return {"sdcm_rates": checks["sdcm_max_abs_err"],
            "reuse_hist_moments": hist["max_abs_err"]}


def phase_more_workloads(t_start: float):
    for abbr in MORE_WORKLOADS:
        if time.perf_counter() - t_start > TIME_BUDGET_S:
            line("more_workloads", skipped=abbr, reason="time budget")
            continue
        w, req, sess = main_path_session(abbr)
        t0 = time.perf_counter()
        res = sess.predict(w, req)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        worst = check_against_oracle(sess, w, req, res, abbr)
        line("more_workloads", workload=f"polybench/{abbr}@{SIZES}",
             refs=len(sess.load(w)[1]), cold_s=cold_s,
             cold_stage_s=dict(sess.stage_seconds),
             max_abs_err_vs_oracle=worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels record here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device()
    probs = phase_hit_probs()
    phase_rates()
    phase_reuse_distances()
    phase_reuse_hist()
    phase_streaming_distances()
    exact, sdcm_kernel = phase_main_path()
    binned_sess, hist_kernels, binned_errs = phase_binned_main_path(exact)
    streaming_errs = phase_streaming_main_path(exact, binned_sess)
    phase_more_workloads(t_start)
    kernels = [sdcm_kernel] + hist_kernels
    for rec in kernels:  # the worst error over every path's own inputs
        for errs in (binned_errs, streaming_errs):
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     errs.get(rec["name"], 0.0))
    record = {"kernels": kernels}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {**record, "hit_probs": probs, "nvidia_smi": smi,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
