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
5. The main path: ``Session(cache_model=AnalyticalSDCM("batched"),
   device="cuda").predict`` on polybench atx at ``validation-xxl``
   (1,082,640 references) over the three Table-5 CPUs x cores
   {1, 2, 4, 8} x round_robin, with the workload's op counts.  The
   SDCM kernel's launch count and the reuse-distance device are read
   around that run; hit rates are held against the float64 oracle
   (``backend="numpy"``) on the same profiles.  More validation-xxl
   workloads follow while time allows.

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
TIME_BUDGET_S = 900   # more workloads in phase 4 only while under this


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


def main_path_session(workload: str):
    from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session
    from repro_torch.workloads.polybench import make_workload

    w = make_workload(workload, SIZES)
    req = PredictionRequest(targets=TABLE5, core_counts=CORES,
                            strategies=("round_robin",), counts=w.op_counts)
    sess = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cuda")
    return w, req, sess


def check_against_oracle(sess, w, req, res, tag: str) -> float:
    from repro_torch.api import AnalyticalSDCM

    items = [
        (cell.target, sess.artifacts(w, cell.cores, strategy=cell.strategy,
                                     line_size=cell.target.levels[0].line_size))
        for cell in req.cells()
    ]
    oracle = AnalyticalSDCM(backend="numpy").hit_rates_grid(items)
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
    from repro_torch.api.batched import grid_rows, pack_grid
    from repro_torch.core.reuse import distance
    from repro_torch.kernels.sdcm import LAUNCHES, sdcm_rates, sdcm_rates_plain

    w, req, sess = main_path_session(MAIN_WORKLOAD)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    distance.PASSES.clear()
    t0 = time.perf_counter()
    res = sess.predict(w, req)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    passes = dict(distance.PASSES)
    cold_stages = dict(sess.stage_seconds)
    cold_stats = dict(vars(sess.stats))
    peak = torch.cuda.max_memory_allocated()

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
    items = [
        (cell.target, sess.artifacts(w, cell.cores, strategy=cell.strategy,
                                     line_size=cell.target.levels[0].line_size))
        for cell in req.cells()
    ]
    groups = pack_grid(grid_rows(items), device="cuda")
    ms = plain_ms = 0.0
    err = 0.0
    nbytes = ops = 0.0
    for grp in groups:
        args = (grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        err = max(err, float((sdcm_rates(*args)
                              - sdcm_rates_plain(*args)).abs().max()))
        ms += cuda_ms(lambda: sdcm_rates(*args), reps=200, warmup=10)
        plain_ms += cuda_ms(lambda: sdcm_rates_plain(*args), reps=20)
        g, m = grp.d.shape
        nbytes += 8.0 * (2 * g * m + 3 * g)
        d = grp.d.cpu().numpy()
        a = np.broadcast_to(grp.assoc.cpu().numpy()[:, None], d.shape)
        b = np.broadcast_to(grp.blocks.cpu().numpy()[:, None], d.shape)
        ops += phit_terms(d, a, b) * OPS_PER_TERM + 2.0 * g * m
    if err > RATE_TOL:
        fail(f"sdcm_rates at main-path shapes: {err} > {RATE_TOL}")
    b_ms, b_by = bound_ms(nbytes, ops)
    line("main_path_kernel", groups=[list(g.signature[1:]) for g in groups],
         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
         max_abs_err=err)
    return {
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
    kernel = phase_main_path()
    phase_more_workloads(t_start)
    record = {"kernels": [kernel]}
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
