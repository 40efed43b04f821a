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
3. The same, grid forms: 4096 mixed-shape rows through the per-group
   form (``sdcm_rates``, one launch per row-shape group) and the ragged
   form (``sdcm_rates_ragged``, every row in one launch), the two forms
   bit for bit equal, plus composition invariance (every row alone
   gives the bits it gives inside the batch, in both forms).
4. The offline reuse-distance engine on the card against the same
   torch ops on the CPU, bit for bit, at 1M references.
5. The reuse-histogram kernel (both flags: ``reuse_histogram_moments``
   and ``reuse_histogram``) against its plain version on 2^24 seeded
   distances plus every power of two and 2^k - 1 up to 2^30 and values
   past 2^31, with unit and fractional weights: counts exact, unit-weight
   masses exact below 2^53, the rest within rtol 1e-12, and two launches
   bit-identical; then on 2^24 copies of one distance (every lane of
   every warp on one bin, its sum past 2^64), unit weights, exact at
   every sum, and timed on 4096 distances (one block: a launch's own cost).
6. Streaming reuse distances on the card (windows of 2^14 and 2^18) bit
   for bit against the in-memory engine on the card, at 1M references;
   then per-set distances at every Table-5 level geometry (line 64; the
   ``monolithic``, ``batched`` and ``auto`` methods, each the same one
   pass) and the batched engine on 1,000 mixed segments (every engine,
   1 and 3 shards, one pass for every value), on the card, bit for bit
   against each other and the CPU port, with seconds.
7. The main path: ``Session(cache_model=AnalyticalSDCM("batched"),
   device="cuda").predict`` on polybench atx at ``validation-xxl``
   (1,082,640 references) over the three Table-5 CPUs x cores
   {1, 2, 4, 8} x round_robin, with the workload's op counts.  The
   SDCM kernel's launch count (exactly one ragged launch, no per-group
   one) and the reuse-distance device are read around that run; hit
   rates are held against the float64 oracle (``backend="numpy"``) on
   the same profiles; the one ragged launch is timed at the path's own
   rows, and the SDCM stage as a whole.
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
   stream).
10. Flash attention (kernel B4) against its plain version and against
    ``torch.nn.functional.scaled_dot_product_attention`` (timed as a
    yardstick only), one row per case, each on the kernel form the
    wrapper picks (checked): the tensor-core form at the zamba2-1.2b
    prefill shape, at a GQA shape (32 heads over 8, head dim 128) and at
    a ragged Sq = 1000; the split-KV form at a decode step against the
    serving cache (kv_len 2048, and 2000, not a multiple of the split)
    and at a GQA decode step (32 over 8, head dim 128); the CUDA-core
    form in f32 at the prefill shape.  Each bf16 row is also held to
    ``FLASH_SCALED_TOL_BF16`` of the plain version's largest output.
    ``ms`` and SDPA's ``library_ms`` time the calls issued one by one,
    as every kernel's ``ms`` does; ``graph_ms`` and
    ``library_graph_ms`` time the same calls replayed from a CUDA graph,
    which leaves the host's cost per call out.
11. The SSD scan (kernel B5) against its plain version at the
    zamba2-1.2b and mamba2-780m prefill shapes, with an initial and a
    final state, with f32 and with bf16 b and c (the served models'
    layout), and at a prime length; timed as in 10.
12. The zamba2-1.2b serve path: ``repro_torch.launch.serve.serve`` at
    full width and depth, bf16, seeded weights, batch 4, prompt 2048,
    32 tokens greedy; B4/B5 launches read around it (B4 also by form:
    6 tensor-core, 186 split-KV, 0 CUDA-core), prefill s, decode
    ms/step, tok/s and peak memory; a ``torch.profiler`` breakdown of
    one prefill and four decode steps (device busy time, idle share, top
    kernels); the same weights teacher-forced through the kernels and
    through the plain versions on the card, in bf16 and in f32 (logits
    within ``SERVE_REL_TOL`` / ``SERVE_REL_TOL_F32`` of the plain path's
    scale; in bf16 also, ungated, with one kernel at a time and with
    SDPA in B4's place); and at full width and two groups in f32, the prefill of a
    whole prompt against a prefix plus decode steps (2e-4 of the logits'
    scale).
9a. After 9: the reuse stage of one cold exact and one streaming
    predict under ``torch.profiler`` (device-idle share; the streaming
    path's host ms per window, split into offline pass, live-set update
    and iterator, is on its line in 9); the exact-LRU ground truth
    (``Session(device="cuda").ground_truth_hit_rates``) over the main
    grid, seconds per cell and in all and the reuse passes, bit for bit
    against the CPU port at every cell at ``validation`` and at one
    full-size cell, with |SDCM - ground truth| per level (ungated: the
    paper's Table 6); the sampled main path (``Session(sampled=R)``, R =
    0.1 and 0.01, in memory and streaming): one SDCM launch per predict,
    profiles and declared bounds equal to the CPU port's, hit rates within
    1e-6 of the CPU port's sampled predict and within each cell's bound of
    the exact predict, and R = 1 equal to it; the
    registry resolving the main workload under the reference's declared
    fingerprint to the trace 7 ran.
9b. The artifact store (``Session(artifact_dir=...)``, under
    ``build/chip_smoke_store``): the main request cold in four modes
    (exact, binned, streaming at 2^16, sampled at R = 0.1), then a fresh
    Session on the same directory answering with no profile, reuse or
    trace build, every cell from disk and ``to_json()`` equal to the cold
    result (cold and warm-from-disk seconds, the store's bytes); the
    ground truth over store hits equal to 9a's.  The fused config sweep
    (``repro_torch.explore.FusedSweepEvaluator`` over ``sweep_grid``) on
    ``benchmarks/explore_sweep.py``'s 10,240-config space: seconds,
    configs/s, one ``sdcm_rates_ragged`` launch per ``sweep_grid`` call,
    64 configs bit for bit against ``batched_hit_rates``, every
    ``t_pred_s`` within 1e-12 of the host ECM model; on the 1,024-config
    space ``inner="pallas"`` (``sdcm_hit_probs``, B1's per-reference form,
    its launches counted, and timed at the sweep's own calls) within 1e-6
    of ``inner="vmap"``, and the warm per-config ``Session.predict`` loop
    timed beside the sweep.  The autotuner (``run_explore``) on the 10k
    space: random over the whole space (the oracle), hillclimb and ga at
    1,024 configs, each best against the oracle's, then again warm from
    the store (cached, nothing rebuilt).
9c. The prediction service (``repro_torch.service``) on the card: the
    ``PredictionServer`` on an ephemeral port with a warm Session on the
    main workload at full size; 1, 8 and 64 concurrent ``ServiceClient``s
    of 16 requests each (the reference selftest's mix: the canonical name
    and its alias as a duplicate, the three Table-5 CPUs, cores 1/2/4/8,
    both strategies), every response bit for bit a sequential
    ``Session.predict``'s, exactly one ragged SDCM launch per batch
    (launches == ``kernel_calls``), requests/s, p50/p99, mean batch size;
    the 64-client load under ``torch.profiler``; one ``/explore``
    (hillclimb, budget 256, the 1,024-config space) on the lane under the
    64-client load, equal to the same search alone, with the ``/predict``
    p99 beside the one without it; the selftest flow twice on one store
    (the second builds nothing).  The validation harness
    (``repro_torch.validate``): the reference's golden 18-cell matrix
    within 1e-6 of its committed aggregates; the whole roster at
    ``smoke`` twice on one store (B2 through the binned check, the second
    run builds nothing, the binned and sampling gates hold); and
    ``run_workload`` on the main workload at full size (24 cells), with
    seconds per part.
13. The mamba2-780m serve path: batch 4, prompt 2048, 16 tokens, B5
    launches read around it, the same profile and the same
    teacher-forced check.  More validation-xxl workloads follow while
    time allows.

Every kernel's ``ms`` times 20 calls issued one by one (what a caller
pays, host work included), its ``graph_ms`` the same calls replayed from
a CUDA graph (the device time).  Every predict in 7-9b must make exactly
one SDCM launch, and every service batch in 9c.  The last lines are the
``{"kernels": [...]}`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP64 and FP32
# (non-tensor) operations/s, and dense bf16 tensor-core operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_FP64_S = 34e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12
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
SAMPLED_RATES = (0.1, 0.01)  # SHARDS rates of the sampled main path
# the reference registry's declared fingerprint of polybench/atx at
# validation-xxl (repro.workloads.registry.declared_fingerprint)
ATX_XXL_FINGERPRINT = "4935eea85c643ec9"
TIME_BUDGET_S = 500   # more workloads at the end only while under this
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}  # the reference's
# bf16 attention, besides FLASH_TOL: max |kernel - plain| over max |plain|.
# A decode row over 2048 columns has outputs of ~0.04, below the absolute
# 3e-2, so a merge that dropped or misweighted a split would pass it.
FLASH_SCALED_TOL_BF16 = 1e-2
SSD_TOL = 5e-6        # SSD scan, |kernel - plain| / max |plain|
# kernel path vs plain path, bf16 logits at full depth: max |diff| over
# max |plain logits|.  bf16 keeps 8 bits (relative rounding 2^-9 = 0.002);
# the two paths round differently inside attention and the scan, and 38
# random-weight layers carry those differences to the logits.
SERVE_REL_TOL = 5e-2
# the same in f32, where the two paths differ only in summation order
# (~1e-6 relative), carried through the same 38 layers
SERVE_REL_TOL_F32 = 1e-4
# f32 prefill vs prefix + decode at full width: the reference's 2e-4,
# taken against the logits' scale (max |logit|).  At d_model 2048 the
# logits reach a few hundred and an error relative to the hidden state's
# scale lands on every logit alike, so the elementwise rtol/atol form would
# hold near-zero logits to 2e-4 absolute; the line reports both.
CONSISTENCY_TOL = 2e-4


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


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the host's launch cost (Python, ctypes,
    allocation) stays out, which an eager loop of calls faster than the
    host can issue them would measure instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # captured on the stream that warmed up: what a kernel keeps per
    # stream (B2's accumulator) was made there, outside the capture
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def phit_terms(d: np.ndarray, assoc: np.ndarray, blocks: np.ndarray) -> int:
    """Binomial terms the data needs: A per set-associative element
    past the D <= A-1 plateau, none elsewhere."""
    busy = (d >= 0) & (assoc < blocks) & (d > assoc - 1)
    return int(np.where(busy, assoc, 0).sum())


def bound_ms(nbytes: float, ops: float,
             peak_ops: float = PEAK_FP64_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
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
         cpu_s=cpu_s, offline_pass_s=offline_pass_seconds(addrs))


def offline_pass_seconds(addrs, reps: int = 5) -> list:
    """Host seconds of the offline pass over lines already on the card,
    ending in a synchronise, ``reps`` times."""
    from repro_torch.core.reuse.batched import reuse_distances_offline

    lines = torch.from_numpy(addrs // 64).cuda()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reuse_distances_offline(lines)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


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
    from repro_torch.api.batched import pack_grid, pack_ragged
    from repro_torch.kernels.sdcm import (
        sdcm_rates,
        sdcm_rates_plain,
        sdcm_rates_ragged,
        sdcm_rates_ragged_plain,
    )

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
    ragged_args = pack_ragged(rows, device="cuda")
    ragged = sdcm_rates_ragged(*ragged_args)
    ragged_err = float((ragged - sdcm_rates_ragged_plain(*ragged_args))
                       .abs().max())
    if not ragged_err <= RATE_TOL:
        fail(f"sdcm_rates_ragged: max |kernel - plain| = {ragged_err} > "
             f"{RATE_TOL}")
    if not np.array_equal(ragged.cpu().numpy(), batch):
        fail("sdcm_rates_ragged gives other bits than sdcm_rates")
    mismatched = 0
    for i, row in enumerate(rows):
        (grp,) = pack_grid([row], device="cuda")
        alone = sdcm_rates(grp.d, grp.probs, grp.assoc, grp.blocks,
                           grp.a_max)[0].item()
        alone_ragged = sdcm_rates_ragged(*pack_ragged([row],
                                                      device="cuda")).item()
        mismatched += alone != batch[i] or alone_ragged != batch[i]
    if mismatched:
        fail(f"composition invariance: {mismatched} of {g} rows give "
             "other bits alone than inside the batch")
    line("rates", rows=g, groups=len(groups), max_abs_err=err,
         ragged_max_abs_err=ragged_err, ragged_equals_per_group=True,
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


def path_rows(sess, w, req) -> list:
    """The SDCM rows of one predict of ``req``."""
    from repro_torch.api.batched import grid_rows

    return grid_rows(path_items(sess, w, req))


def sdcm_at_path_shapes(rows, tag: str) -> tuple[list, float]:
    """Both grid forms against their plain versions on one path's rows:
    ``sdcm_rates`` at each row-shape group, ``sdcm_rates_ragged`` at all
    rows at once, and the two forms' bits equal.  Returns the groups'
    signatures and the max |kernel - plain|."""
    from repro_torch.api.batched import pack_grid, pack_ragged
    from repro_torch.kernels.sdcm import (
        sdcm_rates,
        sdcm_rates_plain,
        sdcm_rates_ragged,
        sdcm_rates_ragged_plain,
    )

    groups = pack_grid(rows, device="cuda")
    per_group = np.zeros(len(rows))
    err = 0.0
    for grp in groups:
        args = (grp.d, grp.probs, grp.assoc, grp.blocks, grp.a_max)
        got = sdcm_rates(*args)
        err = max(err, float((got - sdcm_rates_plain(*args)).abs().max()))
        per_group[grp.rows] = got[:len(grp.rows)].cpu().numpy()
    args = pack_ragged(rows, device="cuda")
    ragged = sdcm_rates_ragged(*args)
    err = max(err, float((ragged - sdcm_rates_ragged_plain(*args))
                         .abs().max()))
    if not err <= RATE_TOL:
        fail(f"SDCM grid forms at {tag} shapes: {err} > {RATE_TOL}")
    if not np.array_equal(ragged.cpu().numpy(), per_group):
        fail(f"{tag}: sdcm_rates_ragged gives other bits than sdcm_rates")
    return [list(g.signature[1:]) for g in groups], err


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
    from repro_torch.api.batched import batched_hit_rates, pack_ragged
    from repro_torch.kernels.sdcm import (
        sdcm_rates_ragged,
        sdcm_rates_ragged_plain,
    )

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

    one_sdcm_launch(launches, MAIN_WORKLOAD)
    if passes.get("cuda", 0) <= 0 or passes.get("cpu", 0):
        fail(f"reuse distances not computed on the GPU: {passes}")

    reset_counts()
    t0 = time.perf_counter()
    res_warm = sess.predict(w, req)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_stages = {k: v - cold_stages.get(k, 0.0)
                   for k, v in sess.stage_seconds.items()}
    one_sdcm_launch(read_counts()["launches"], f"{MAIN_WORKLOAD} (warm)")
    if res_warm.to_json() != res.to_json():
        fail("warm predict differs from cold predict")
    # ten more warm predicts: the spread, and each stage's mean
    before = dict(sess.stage_seconds)
    warm_more = []
    for _ in range(10):
        t0 = time.perf_counter()
        sess.predict(w, req)
        torch.cuda.synchronize()
        warm_more.append(time.perf_counter() - t0)
    warm_stage_mean = {k: (v - before.get(k, 0.0)) / 10
                       for k, v in sess.stage_seconds.items()}
    worst = check_against_oracle(sess, w, req, res, MAIN_WORKLOAD)
    line("main_path", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         refs=len(sess.load(w)[1]), cells=len(res), cold_s=cold_s,
         warm_s=warm_s, cold_stage_s=cold_stages, warm_stage_s=warm_stages,
         warm_s_more=warm_more, warm_stage_s_mean=warm_stage_mean,
         max_memory_allocated=peak, stats=cold_stats,
         launches=launches, rd_passes=passes,
         max_abs_err_vs_oracle=worst)
    print(res.to_table(), flush=True)

    # the kernel at the main path's own rows: one predict's SDCM stage
    rows = path_rows(sess, w, req)
    groups, err = sdcm_at_path_shapes(rows, MAIN_WORKLOAD)
    args = pack_ragged(rows, device="cuda")
    d, _, meta = (t.cpu().numpy() for t in args)
    off, length = meta[:, 0].astype(np.int64), meta[:, 1].astype(np.int64)
    row_of = np.repeat(np.arange(len(rows)), length)
    terms = phit_terms(d, meta[row_of, 2], meta[row_of, 3])
    nbytes = 8.0 * (2 * d.size + meta.size + len(rows))
    b_ms, b_by = bound_ms(nbytes, terms * OPS_PER_TERM + 2.0 * d.size)
    items = path_items(sess, w, req)

    def host_ms(fn, reps: int = 20) -> float:
        """Host clock per call, the calls ending synchronised."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    # the SDCM stage (pack, copy, launch, copy back) and its parts
    stage = dict(
        stage_ms=host_ms(lambda: batched_hit_rates(items, device="cuda")),
        pack_ms=host_ms(lambda: pack_ragged(rows, device="cuda")),
        launch_and_copy_back_ms=host_ms(
            lambda: sdcm_rates_ragged(*args).cpu()))
    rec = dict(
        ms=cuda_ms(lambda: sdcm_rates_ragged(*args), reps=200, warmup=10),
        graph_ms=graph_ms(lambda: sdcm_rates_ragged(*args)),
        plain_ms=cuda_ms(lambda: sdcm_rates_ragged_plain(*args), reps=20),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    line("main_path_kernel", rows=len(rows), entries=int(d.size),
         groups=groups, launches_per_predict=launches["sdcm_rates_ragged"],
         **stage, **rec)
    return res, {
        "name": "sdcm_rates_ragged",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdcm/csrc/sdcm.cu",
        "replaces": "src/repro/kernels/sdcm/sdcm.py:32",
        "launches": launches["sdcm_rates_ragged"],
        **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
        "library_ms": None,
        "graph_ms": rec["graph_ms"],
    }


def one_sdcm_launch(launches: dict, tag: str) -> None:
    """A predict evaluates its whole SDCM grid in one ragged launch."""
    if launches["sdcm_rates_ragged"] != 1 or launches["sdcm_rates"]:
        fail(f"{tag}: a predict made {launches['sdcm_rates_ragged']} ragged "
             f"and {launches['sdcm_rates']} per-group SDCM launches, "
             f"expected exactly 1 ragged: {launches}")


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
        graph_ms=graph_ms(lambda: fn(d, w)),
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
    # one block's worth (4096 distances): the cost of a launch itself
    for moments in (True, False):
        fn = rh.reuse_histogram_moments if moments else rh.reuse_histogram
        line("reuse_hist", kernel=fn.__name__, input="one_block",
             **time_hist(d[:4096].clone(), None, moments))
    # the contention worst case: every lane of every warp on one bin, and
    # the bin's sum (2^24 (2^40 + 7)) past 2^64
    one = torch.full((HIST_N,), (1 << 40) + 7, dtype=torch.int64,
                     device="cuda")
    for moments in (True, False):
        fn = rh.reuse_histogram_moments if moments else rh.reuse_histogram
        plain = (rh.reuse_histogram_moments_plain if moments
                 else rh.reuse_histogram_plain)
        first, second = fn(one), fn(one)
        if not (torch.equal(first, plain(one)) and torch.equal(first, second)):
            fail(f"{fn.__name__}: one-bin input not exact or not reproducible")
        line("reuse_hist", kernel=fn.__name__, input="one_bin",
             bit_reproducible=True, exact=True, **time_hist(one, None, moments))


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


def launch_counts() -> tuple:
    from repro_torch.kernels import flash_attention, reuse_hist, sdcm, ssd_scan

    return (sdcm.LAUNCHES, reuse_hist.LAUNCHES, flash_attention.LAUNCHES,
            flash_attention.LAUNCHES_BY_FORM, ssd_scan.LAUNCHES)


def reset_counts():
    from repro_torch.core.reuse import distance

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counts in launch_counts():
        for k in counts:
            counts[k] = 0
    distance.PASSES.clear()
    distance.WINDOWS.clear()
    distance.WINDOW_SECONDS.clear()


def read_counts() -> dict:
    from repro_torch.core.reuse import distance

    torch.cuda.synchronize()
    launches = {}
    for counts in launch_counts():
        launches.update(counts)
    return dict(launches=launches,
                rd_passes=dict(distance.PASSES),
                rd_windows=dict(distance.WINDOWS),
                rd_window_seconds=dict(distance.WINDOW_SECONDS),
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
    one_sdcm_launch(counts["launches"], tag)
    passes = counts["rd_passes"]
    if passes.get("cuda", 0) <= 0 or passes.get("cpu", 0):
        fail(f"{tag}: reuse distances not computed on the GPU: {passes}")
    reset_counts()
    t0 = time.perf_counter()
    res_warm = sess.predict(w, req)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    one_sdcm_launch(read_counts()["launches"], f"{tag} (warm)")
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
    groups, err = sdcm_at_path_shapes(path_rows(sess, w, req), tag)
    return dict(
        max_abs_err_vs_oracle=check_against_oracle(sess, w, req, res, tag),
        sdcm_groups=groups, sdcm_max_abs_err=err,
    )


def phase_binned_main_path(exact):
    from repro_torch.core.reuse.distance import reuse_distances

    w, req, sess, res, counts = drive(
        "binned_main_path", ("reuse_hist_moments", "sdcm_rates_ragged"),
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
                                   "bound_ms", "bound_by", "library_ms",
                                   "graph_ms")},
        })
    return sess, records, {"sdcm_rates_ragged": checks["sdcm_max_abs_err"]}


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
    _, _, _, res, counts = drive("streaming_main_path",
                                 ("sdcm_rates_ragged",),
                                 window_size=STREAM_WINDOW)
    if res.to_json() != exact.to_json():
        fail("exact streaming predict differs from the in-memory one")
    windows = counts["rd_windows"]["cuda"]
    line("streaming_vs_in_memory", bit_identical=True, windows=windows,
         host_ms_per_window={k: v / windows * 1e3 for k, v in
                             counts["rd_window_seconds"].items()})
    w, req, sess, res_b, _ = drive(
        "binned_streaming_main_path",
        ("reuse_hist_moments", "sdcm_rates_ragged"),
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
    return {"sdcm_rates_ragged": checks["sdcm_max_abs_err"],
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


# --- exact-LRU ground truth, sampled profiles, the registry ------------------


def timed(fn):
    """(result, host seconds) of ``fn``, ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_per_set(n: int = 1 << 20, segments: int = 1000, seed: int = 6):
    """Per-set distances on the card at every Table-5 level geometry
    (line 64) against the CPU port, each method value accepted and
    giving the same integers (every value is the same one pass); then
    the batched engine on ``segments`` mixed segments at every engine
    and at 1 and 3 shards (one pass for every value), against the CPU
    port."""
    from repro_torch.core.reuse.batched import reuse_distances_batched
    from repro_torch.core.reuse.distance import per_set_reuse_distances
    from repro_torch.hw.targets import ALL_TARGETS

    rng = np.random.default_rng(seed)
    hot = rng.random(n) < 0.5  # a 256 KiB hot set inside a 256 MiB range
    addrs = np.where(hot, rng.integers(0, 1 << 15, n),
                     rng.integers(0, 1 << 25, n)) * 8
    sets = sorted({lvl.num_sets for name in TABLE5
                   for lvl in ALL_TARGETS[name].levels})
    for num_sets in sets:
        outs = {}
        for method in ("monolithic", "batched", "auto"):
            outs[method], gpu_s = timed(lambda: per_set_reuse_distances(
                addrs, line_size=64, num_sets=num_sets, method=method,
                device="cuda"))
        t0 = time.perf_counter()
        want = per_set_reuse_distances(addrs, line_size=64,
                                       num_sets=num_sets, device="cpu")
        cpu_s = time.perf_counter() - t0
        for method, got in outs.items():
            if got.device.type != "cuda" or not torch.equal(got.cpu(), want):
                fail(f"per-set distances ({method}, {num_sets} sets) on the "
                     "card differ from the CPU port")
        line("per_set", n=n, num_sets=num_sets, bit_identical=True,
             gpu_s=gpu_s, cpu_s=cpu_s)
    lengths = np.where(rng.random(segments) < 0.05, 0,
                       rng.integers(1, 2000, segments))
    segs = [rng.integers(0, max(int(k) // 3, 1), int(k)) * 8
            for k in lengths]
    t0 = time.perf_counter()
    want = [t.numpy() for t in reuse_distances_batched(
        segs, line_size=64, num_shards=1, device="cpu")]
    cpu_s = time.perf_counter() - t0
    for engine in ("auto", "fenwick", "offline"):
        for shards in (1, 3):
            got, gpu_s = timed(
                lambda: reuse_distances_batched(
                    segs, line_size=64, engine=engine, num_shards=shards,
                    device="cuda"))
            if not all(g.device.type == "cuda"
                       and np.array_equal(g.cpu().numpy(), x)
                       for g, x in zip(got, want)):
                fail(f"batched distances (engine {engine}, {shards} shards)"
                     " on the card differ from the CPU port")
    line("batched_segments", segments=segments, refs=int(lengths.sum()),
         bit_identical=True, gpu_s=gpu_s, cpu_s=cpu_s)


def exact_lru_results(art, target, device) -> list:
    """Every ``simulate_hierarchy`` result ExactLRU reads for one cell,
    as (hits, accesses) per level."""
    from repro_torch.api.stages import shared_level_index
    from repro_torch.core.cachesim import simulate_hierarchy

    levels = list(target.levels)
    runs = ([p.addresses for p in art.privates] if art.cores > 1 else [])
    out = [[(r.hits, r.accesses) for r in simulate_hierarchy(
        a, levels[:shared_level_index(target)], device=device)]
        for a in runs]
    out.append([(r.hits, r.accesses) for r in simulate_hierarchy(
        art.shared.addresses, levels, device=device)])
    return out


def phase_ground_truth(exact) -> dict:
    """``Session(device="cuda").ground_truth_hit_rates`` over the main
    grid at ``SIZES``, per cell and in all; against the CPU port at
    every cell at ``validation`` and at one full-size cell (hits and
    accesses of every simulated hierarchy, and the rates); and, ungated,
    |SDCM - ground truth| per level (the paper's Table 6)."""
    from repro_torch.api import Session
    from repro_torch.hw.targets import resolve_target
    from repro_torch.workloads.polybench import make_workload

    def grid(sess, w) -> dict:
        return {(t, c): sess.ground_truth_hit_rates(w, t, c)
                for t in TABLE5 for c in CORES}

    w = make_workload(MAIN_WORKLOAD, SIZES)
    sess = Session(device="cuda")
    reset_counts()
    t_all = time.perf_counter()
    gt, cell_s = {}, {}
    for target in TABLE5:
        for cores in CORES:
            gt[target, cores], cell_s[f"{target}/{cores}"] = timed(
                lambda: sess.ground_truth_hit_rates(w, target, cores))
    total_s = time.perf_counter() - t_all
    counts = read_counts()
    passes = counts["rd_passes"]
    if passes.get("cuda", 0) <= 0 or passes.get("cpu", 0):
        fail(f"ground truth: reuse distances not on the GPU: {passes}")
    errs: dict = {}
    for pred in exact:
        for lvl, rate in pred.hit_rates.items():
            errs.setdefault(lvl, []).append(
                abs(rate - gt[pred.target, pred.cores][lvl]))
    # bit for bit against the CPU port
    wv = make_workload(MAIN_WORKLOAD, "validation")
    gpu_v, cpu_v = Session(device="cuda"), Session(device="cpu")
    if grid(gpu_v, wv) != grid(cpu_v, wv):
        fail("ground truth at validation differs from the CPU port")
    for t in TABLE5:
        target = resolve_target(t)
        for c in CORES:
            kw = dict(line_size=64)
            if (exact_lru_results(gpu_v.artifacts(wv, c, **kw), target, "cuda")
                    != exact_lru_results(cpu_v.artifacts(wv, c, **kw),
                                         target, "cpu")):
                fail(f"ground truth at validation ({t}, {c} cores): hits "
                     "or accesses differ from the CPU port")
    big = ("i7-5960X", max(CORES))
    cpu_big = Session(device="cpu")
    want_big, cpu_s = timed(lambda: cpu_big.ground_truth_hit_rates(w, *big))
    target = resolve_target(big[0])
    if (want_big != gt[big] or exact_lru_results(
            sess.artifacts(w, big[1], line_size=64), target, "cuda")
            != exact_lru_results(cpu_big.artifacts(w, big[1], line_size=64),
                                 target, "cpu")):
        fail(f"ground truth at {SIZES} {big} differs from the CPU port")
    line("ground_truth", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         cells=len(gt), total_s=total_s, cell_s=cell_s,
         rd_passes=passes, max_memory_allocated=counts["max_memory_allocated"],
         bit_identical_cells={"validation": len(gt), SIZES: 1},
         cpu_s_full_size_cell=cpu_s,
         sdcm_vs_ground_truth={lvl: dict(mean=float(np.mean(e)),
                                         max=float(np.max(e)))
                               for lvl, e in errs.items()})
    return gt


def phase_sampled_main_path(exact) -> None:
    """The main request through ``Session(sampled=R)``, in memory and
    streaming: one SDCM launch per predict, profiles (pairs and error
    bound) equal to the CPU port's, hit rates within ``RATE_TOL`` of the
    CPU port's sampled predict on the same request (the profiles are
    equal, so only the SDCM stage can differ) and within each cell's
    declared bound of the exact predict (the reference's gate; at this
    workload the bound is 1.0); R = 1 equals the exact path."""
    from repro_torch.api import Session

    for rate in SAMPLED_RATES:
        for ws in (None, STREAM_WINDOW):
            kw = dict(sampled=rate) if ws is None else dict(
                sampled=rate, window_size=ws)
            w, req, sess, res, _ = drive("sampled_main_path",
                                         ("sdcm_rates_ragged",), **kw)
            cpu = Session(device="cpu", **kw)
            worst, vs_cpu = 0.0, 0.0
            for got, on_cpu in zip(res, cpu.predict(w, req)):
                for lvl, r in on_cpu.hit_rates.items():
                    diff = abs(got.hit_rates[lvl] - r)
                    vs_cpu = max(vs_cpu, diff)
                    if not np.isfinite(got.hit_rates[lvl]) or diff > RATE_TOL:
                        fail(f"sampled {rate} (window {ws}) {got.target} "
                             f"cores={got.cores} {lvl}: {got.hit_rates[lvl]}"
                             f" vs the CPU port's {r}")
            for got, want in zip(res, exact):
                art = sess.artifacts(w, got.cores, line_size=64)
                ref = cpu.artifacts(w, got.cores, line_size=64)
                for pa, pb in ((art.prd, ref.prd), (art.crd, ref.crd)):
                    if not (np.array_equal(pa.distances, pb.distances)
                            and np.array_equal(pa.counts, pb.counts)
                            and pa.error_bound == pb.error_bound):
                        fail(f"sampled {rate} (window {ws}) cores="
                             f"{got.cores}: profile differs from the CPU "
                             "port's")
                bound = max(art.prd.error_bound, art.crd.error_bound)
                for lvl, r in want.hit_rates.items():
                    diff = abs(got.hit_rates[lvl] - r)
                    worst = max(worst, diff / bound)
                    if not diff < bound:
                        fail(f"sampled {rate} {got.target} cores="
                             f"{got.cores} {lvl}: |{got.hit_rates[lvl]} - "
                             f"{r}| >= declared bound {bound}")
            line("sampled_vs_exact", rate=rate, window_size=ws,
                 profiles_equal_cpu_port=True,
                 max_abs_diff_vs_cpu_port=vs_cpu,
                 worst_diff_over_bound=worst,
                 bounds={c: [a.prd.error_bound, a.crd.error_bound]
                         for c in CORES
                         for a in [sess.artifacts(w, c, line_size=64)]})
    *_, res, _ = drive("sampled_main_path", ("sdcm_rates_ragged",),
                       sampled=1.0)
    if res.to_json() != exact.to_json():
        fail("sampled at rate 1.0 differs from the exact predict")
    line("sampled_rate_one", equals_exact=True)


def phase_registry(exact) -> None:
    """The registry resolves the main workload to the trace the main
    path ran, under the reference's declared fingerprint."""
    from repro_torch.api.stages import trace_content_id
    from repro_torch.workloads import registry

    src = registry.resolve(f"polybench/{MAIN_WORKLOAD}", SIZES)
    cid = trace_content_id(src.trace())
    if cid != exact.trace_id:
        fail(f"registry trace {cid} differs from the main path's "
             f"{exact.trace_id}")
    if src.declared_fingerprint != ATX_XXL_FINGERPRINT:
        fail(f"declared fingerprint {src.declared_fingerprint} differs from "
             f"the reference's {ATX_XXL_FINGERPRINT}")
    line("registry", workload=src.workload_name, sizes=SIZES,
         trace_content_id=cid, declared_fingerprint=src.declared_fingerprint)


# --- the artifact store, the config sweep, the autotuner -----------------------

STORE_DIR = ROOT / "build" / "chip_smoke_store"   # git-ignored, made anew
# the store's cold/warm modes: exact, binned, streaming, sampled
STORE_MODES = (("exact", {}), ("binned", {"binned": True}),
               ("streaming", {"window_size": STREAM_WINDOW}),
               ("sampled", {"sampled": 0.1}))
# benchmarks/explore_sweep.py's spaces: space_10k (16 sets x 4 ways x 2
# line sizes x 5 latencies x 4 betas x 4 cores = 10,240 configs, 8 profile
# groups) and space_1k (8 x 4 x 4 x 4 x 2 = 1,024 configs, 2 groups);
# base i7-5960X, L3 swept, runtime objective
SWEEP_10K = dict(sets=tuple(64 << i for i in range(16)), ways=(2, 4, 8, 16),
                 line_sizes=(64, 128),
                 latency_cy=(12.0, 20.0, 36.0, 48.0, 60.0),
                 beta_cy=(1.0, 2.0, 3.0, 4.0), cores=(1, 2, 4, 8))
SWEEP_1K = dict(sets=(256, 512, 1024, 2048, 4096, 8192, 16384, 32768),
                ways=(2, 4, 8, 16), latency_cy=(12.0, 20.0, 36.0, 60.0),
                beta_cy=(1.0, 2.0, 3.0, 4.0), cores=(1, 2))
SWEEP_SAMPLE = 64      # configs held bit for bit against batched_hit_rates
ECM_RTOL = 1e-12       # sweep's float64 chain vs the host ECM model
EXPLORE_BUDGET = 1024  # hillclimb and ga; random takes the whole space


def store_bytes(root: Path) -> int:
    return sum(f.stat().st_size for f in root.rglob("*") if f.is_file())


def registry_workload():
    from repro_torch.workloads import registry

    return registry.resolve(f"polybench/{MAIN_WORKLOAD}", SIZES)


def phase_store(gt: dict) -> None:
    """The main request through ``Session(artifact_dir=...)`` in each of
    the four profile modes: cold (every cell built and written), then a
    fresh Session on the same directory (every cell from disk: no profile,
    reuse-distance or trace build, the same ``to_json()``); and the
    exact-LRU ground truth over store hits equal to the in-memory one."""
    import shutil

    from repro_torch.api import AnalyticalSDCM, PredictionRequest, Session

    shutil.rmtree(STORE_DIR, ignore_errors=True)
    w = registry_workload()
    req = PredictionRequest(targets=TABLE5, core_counts=CORES,
                            strategies=("round_robin",), counts=w.op_counts)

    def session(**kw):
        return Session(cache_model=AnalyticalSDCM(backend="batched"),
                       device="cuda", artifact_dir=STORE_DIR, **kw)

    for tag, kw in STORE_MODES:
        before = store_bytes(STORE_DIR) if STORE_DIR.exists() else 0
        cold = session(**kw)
        res, cold_s = timed(lambda: cold.predict(registry_workload(), req))
        warm = session(**kw)
        again, warm_s = timed(lambda: warm.predict(registry_workload(), req))
        st = warm.stats
        if (st.profile_builds or st.rd_builds or st.trace_builds
                or st.store_hits != cold.stats.store_puts
                or cold.stats.store_puts != cold.stats.profile_builds):
            fail(f"store {tag}: the warm Session rebuilt work or missed "
                 f"cells: cold {cold.stats}, warm {st}")
        if again.to_json() != res.to_json():
            fail(f"store {tag}: warm-from-disk predict differs from cold")
        line("store", mode=tag, session=kw, cells=len(res),
             store_puts=cold.stats.store_puts, store_hits=st.store_hits,
             cold_s=cold_s, warm_from_disk_s=warm_s,
             warm_store_s=warm.stage_seconds["store"],
             store_bytes=store_bytes(STORE_DIR) - before,
             warm_stats=dict(vars(st)))
    sess = session()
    got, gt_s = timed(lambda: {(t, c): sess.ground_truth_hit_rates(
        registry_workload(), t, c) for t in TABLE5 for c in CORES})
    if got != gt:
        fail("ground truth over store hits differs from the in-memory one")
    if sess.stats.profile_builds or sess.stats.store_hits != len(CORES):
        fail(f"ground truth rebuilt profiles off the store: {sess.stats}")
    line("store_ground_truth", cells=len(got), seconds=gt_s,
         equals_in_memory=True, stats=dict(vars(sess.stats)),
         store_bytes=store_bytes(STORE_DIR))


def sweep_hit_probs_calls(ev, configs) -> list:
    """(distances float32, assoc, blocks) of every ``sdcm_hit_probs``
    launch an ``inner="pallas"`` sweep of ``configs`` makes."""
    calls = []
    groups: dict = {}
    for cfg in configs:
        groups.setdefault((cfg.line_size, cfg.cores, cfg.strategy),
                          []).append(cfg)
    for (line_size, cores, strategy), cfgs in groups.items():
        prd, crd = ev._pack(line_size, cores, strategy)
        geom = ev._geometry(cfgs, line_size, cores)
        for lv in range(geom.assoc.shape[1]):
            prof = prd if lv < ev.shared_idx else crd
            d32 = prof.d[:prof.n].to(torch.float32)
            pairs = sorted({(int(a), int(b)) for a, b in
                            zip(geom.assoc[:, lv], geom.blocks[:, lv])
                            if a < b})
            calls += [(d32, a, b) for a, b in pairs]
    return calls


def phase_sweep() -> dict:
    """``FusedSweepEvaluator`` (``sweep_grid``) on the main workload over
    the 10,240-config space: seconds, configs/s, one ragged SDCM launch
    per ``sweep_grid`` call; a sample of configs bit for bit against
    ``batched_hit_rates`` on the applied targets; every ``t_pred_s``
    within ``ECM_RTOL`` of the host ECM model; ``inner="pallas"`` (B1's
    per-reference form) on the 1,024-config space within ``RATE_TOL`` of
    ``inner="vmap"``, its launches counted; the warm per-config
    ``Session.predict`` loop on that space, timed beside the sweep.
    Returns the kernels-line record of ``sdcm_hit_probs``."""
    from repro_torch.api import PredictionRequest, Session
    from repro_torch.api.batched import batched_hit_rates
    from repro_torch.core.incore import ECMRuntimeModel
    from repro_torch.explore import FusedSweepEvaluator, SearchSpace
    from repro_torch.kernels.sdcm import sdcm_hit_probs, sdcm_hit_probs_plain

    w = registry_workload()
    sess = Session(cache_model="batched", device="cuda")
    space = SearchSpace(**SWEEP_10K)
    configs = space.configs()
    ev = FusedSweepEvaluator(w, space, session=sess)
    _, profile_s = timed(lambda: ev.evaluate(configs))   # cold: profiles
    reset_counts()
    res, sweep_s = timed(lambda: ev.evaluate(configs))
    launches = read_counts()["launches"]
    groups = {(c.line_size, c.cores, c.strategy) for c in configs}
    if (launches["sdcm_rates_ragged"] != len(groups)
            or sum(launches.values()) != len(groups)):
        fail(f"sweep: {launches} for {len(groups)} sweep_grid calls, "
             "expected one sdcm_rates_ragged launch each and nothing else")
    base, li = ev.base, ev.level_idx
    names = [lvl.name for lvl in base.levels]
    pick = np.random.default_rng(0).choice(len(configs), SWEEP_SAMPLE,
                                           replace=False)
    items = [(configs[i].apply(base, li),
              sess.artifacts(w, configs[i].cores, strategy=configs[i].strategy,
                             line_size=configs[i].line_size)) for i in pick]
    for i, rates in zip(pick, batched_hit_rates(items, device="cuda")):
        if res.rates[i].tolist() != [rates[n] for n in names]:
            fail(f"sweep config {configs[i]}: rates {res.rates[i].tolist()}"
                 f" are not batched_hit_rates' {rates}")
    ecm = ECMRuntimeModel()
    worst_ecm = 0.0
    for i, cfg in enumerate(configs):
        host = ecm.runtime(cfg.apply(base, li), dict(zip(names, res.rates[i])),
                           w.op_counts, cfg.cores)["t_pred_s"]
        rel = abs(res.t_pred_s[i] - host) / host
        worst_ecm = max(worst_ecm, rel)
        if not rel <= ECM_RTOL:
            fail(f"sweep config {cfg}: t_pred_s {res.t_pred_s[i]} vs host "
                 f"ECM {host} (rel {rel} > {ECM_RTOL})")
    best = int(np.argmin(res.scores))
    line("sweep", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         configs=len(configs), profile_groups=len(groups),
         cold_with_profiles_s=profile_s, sweep_s=sweep_s,
         configs_per_s=len(configs) / sweep_s,
         sdcm_rates_ragged_launches=launches["sdcm_rates_ragged"],
         bit_identical_sample=SWEEP_SAMPLE, max_rel_vs_host_ecm=worst_ecm,
         best=configs[best].to_json(), best_t_pred_s=float(res.scores[best]))

    # the 1k space: vmap, pallas (B1's per-reference form), predict loop
    small = SearchSpace(**SWEEP_1K)
    cfgs = small.configs()
    vm = FusedSweepEvaluator(w, small, session=sess)
    pa = FusedSweepEvaluator(w, small, session=sess, inner="pallas")
    vm.evaluate(cfgs)
    pa.evaluate(cfgs)                       # warm: profiles, shapes
    vres, vmap_s = timed(lambda: vm.evaluate(cfgs))
    reset_counts()
    pres, pallas_s = timed(lambda: pa.evaluate(cfgs))
    launches = read_counts()["launches"]
    calls = sweep_hit_probs_calls(pa, cfgs)
    if (launches["sdcm_hit_probs"] != len(calls)
            or sum(launches.values()) != len(calls)):
        fail(f"pallas sweep: {launches}, expected {len(calls)} "
             "sdcm_hit_probs launches and nothing else")
    diff = float(np.max(np.abs(pres.rates - vres.rates)))
    if not diff <= RATE_TOL:
        fail(f"pallas sweep vs vmap sweep: {diff} > {RATE_TOL}")

    def loop():
        out = []
        for cfg in cfgs:
            req = PredictionRequest(
                targets=(cfg.apply(base, li),), core_counts=(cfg.cores,),
                strategies=(cfg.strategy,), counts=w.op_counts,
                runtime_model="ecm", respect_core_limit=False)
            (cell,) = sess.predict(w, req)
            out.append(cell.t_pred_s)
        return np.asarray(out)

    loop()                                  # warm
    naive, loop_s = timed(loop)
    rel = float(np.max(np.abs(naive - vres.t_pred_s) / naive))
    if not rel <= ECM_RTOL:
        fail(f"1k sweep vs the predict loop: rel {rel} > {ECM_RTOL}")
    line("sweep_1k", configs=len(cfgs), vmap_s=vmap_s, pallas_s=pallas_s,
         predict_loop_s=loop_s, vmap_configs_per_s=len(cfgs) / vmap_s,
         loop_configs_per_s=len(cfgs) / loop_s, speedup=loop_s / vmap_s,
         sdcm_hit_probs_launches=launches["sdcm_hit_probs"],
         pallas_vs_vmap_max_abs=diff, loop_vs_sweep_max_rel=rel)

    # B1's per-reference form at the pallas sweep's own calls
    err = 0.0
    for d, a, b in calls:
        err = max(err, float((sdcm_hit_probs(d, a, b)
                              - sdcm_hit_probs_plain(d, a, b)).abs().max()))
    if not err <= PHIT_TOL:
        fail(f"sdcm_hit_probs at the sweep's shapes: {err} > {PHIT_TOL}")

    def every(fn):
        return lambda: [fn(d, a, b) for d, a, b in calls]

    n_elems = sum(int(d.numel()) for d, _, _ in calls)
    terms = sum(phit_terms(d.cpu().numpy(), np.full(d.numel(), a),
                           np.full(d.numel(), b)) for d, a, b in calls)
    b_ms, b_by = bound_ms(8.0 * n_elems, terms * OPS_PER_TERM)
    k = len(calls)
    rec = dict(ms=cuda_ms(every(sdcm_hit_probs)) / k,
               graph_ms=graph_ms(every(sdcm_hit_probs)) / k,
               plain_ms=cuda_ms(every(sdcm_hit_probs_plain), reps=3,
                                warmup=1) / k,
               bound_ms=b_ms / k, bound_by=b_by, max_abs_err=err)
    line("sweep_hit_probs", launches_per_sweep=k,
         distances_per_launch=n_elems / k, terms=terms, **rec)
    return {
        "name": "sdcm_hit_probs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdcm/csrc/sdcm.cu",
        "replaces": "src/repro/kernels/sdcm/sdcm.py:32",
        "launches": launches["sdcm_hit_probs"],
        **{key: rec[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by")},
        "library_ms": None,
        "graph_ms": rec["graph_ms"],
    }


def phase_explore() -> None:
    """``run_explore`` on the 10,240-config space: random at the whole
    space (the exhaustive oracle), hillclimb and ga at
    ``EXPLORE_BUDGET``, each against the oracle's best; then again on a
    fresh Session over the same store, which must serve every search
    from disk with no build and no new launch shape."""
    from repro_torch.api import Session
    from repro_torch.explore import SearchSpace, run_explore

    space = SearchSpace(**SWEEP_10K)
    runs = (("random", space.size), ("hillclimb", EXPLORE_BUDGET),
            ("ga", EXPLORE_BUDGET))
    name = f"polybench/{MAIN_WORKLOAD}"

    def search(sess, agent, budget):
        return timed(lambda: run_explore(
            registry_workload(), space, agent=agent, budget=budget, seed=0,
            session=sess, workload=name))

    cold = Session(cache_model="batched", device="cuda",
                   artifact_dir=STORE_DIR)
    oracle = None
    for agent, budget in runs:
        res, secs = search(cold, agent, budget)
        oracle = oracle or res
        if res["cached"] or res["trajectory"]["evaluations"] > budget:
            fail(f"explore {agent}: cached={res['cached']}, "
                 f"{res['trajectory']['evaluations']} evaluations")
        if res["best"]["score"] < oracle["best"]["score"]:
            fail(f"explore {agent} beat the exhaustive oracle: "
                 f"{res['best']['score']} < {oracle['best']['score']}")
        line("explore", agent=agent, budget=budget, seconds=secs,
             evaluations=res["trajectory"]["evaluations"],
             best_score=res["best"]["score"],
             oracle_score=oracle["best"]["score"],
             best_over_oracle=res["best"]["score"] / oracle["best"]["score"],
             best=res["best"]["config"], stats=res["stats"])
    warm = Session(cache_model="batched", device="cuda",
                   artifact_dir=STORE_DIR)
    for agent, budget in runs:
        res, secs = search(warm, agent, budget)
        st = warm.stats
        if not res["cached"] or (st.profile_builds + st.rd_builds
                                 + st.trace_builds + st.kernel_shapes):
            fail(f"explore {agent} warm: cached={res['cached']}, {st}")
        line("explore_warm", agent=agent, seconds=secs, cached=True,
             stats=dict(vars(st)))


def reuse_stage(window_size):
    """A function that runs the reuse-profile stage of one cold predict
    of the main request on a fresh builder: every cell's PRD and CRD,
    the traces (mimicry, interleaving) made beforehand."""
    from repro_torch.api.stages import MimicProfileBuilder

    w, req, sess = main_path_session(MAIN_WORKLOAD)
    arts = [sess.artifacts(w, c, line_size=64) for c in CORES]

    def run():
        b = MimicProfileBuilder("cuda", window_size=window_size)
        for art in arts:
            if not window_size:
                b.profile(art.privates[0], 64)
                if art.cores > 1:
                    b.profile(art.shared, 64)
                continue
            b.profile_windows(art.privates[0], 64)
            if art.cores > 1:
                b.shared_profile(art.privates, "round_robin", 0, 64)
    return run


def phase_reuse_idle() -> None:
    """Device-idle share over the reuse stage of one cold exact predict
    and of one streaming predict (``torch.profiler``)."""
    for ws in (None, STREAM_WINDOW):
        fn = reuse_stage(ws)
        fn()  # the same work once before the profiled run
        line("reuse_stage_profile", window_size=ws,
             **device_breakdown(fn))


# --- the prediction service and the validation harness ----------------------

SERVICE_CLIENTS = (1, 8, 64)   # concurrent ServiceClients a load
SERVICE_REQUESTS = 16          # requests each client sends
SERVICE_EXPLORE_BUDGET = 256   # the /explore put on the lane under load
SERVICE_STORE = ROOT / "build" / "chip_smoke_service_store"
VALIDATE_STORE = ROOT / "build" / "chip_smoke_validate_store"
# tests/validate/test_runtime_golden.py: the golden matrix and its
# committed aggregates (error in %), the reference's on its CPU
GOLDEN_SPEC = dict(workloads=("polybench/atx", "polybench/mvt",
                              "polybench/jcb"),
                   core_counts=(1, 4), strategies=("round_robin",),
                   sizes="smoke", binned_check=False)
GOLDEN_HIT_ERR_PCT = 0.259646889555145
GOLDEN_RUNTIME_ERR_PCT = 1.367613486290153
GOLDEN_MODEL_ERR_PCT = {"eq": 1.367613486290153, "ecm": 71.663113522307130,
                        "roofline": 90.851810925179830}
GOLDEN_CELLS = 18
GOLDEN_TOL = 1e-6


def service_payloads() -> tuple:
    """The reference selftest's mix at the main path's size: the main
    request's cores, its alias as a duplicate, another target subset and
    strategy, and the whole grid with both strategies."""
    name = f"polybench/{MAIN_WORKLOAD}"
    return (
        {"workload": name, "sizes": SIZES, "core_counts": [1, 2, 4]},
        {"workload": MAIN_WORKLOAD, "sizes": SIZES, "core_counts": [1, 2, 4]},
        {"workload": name, "sizes": SIZES, "core_counts": [1, 8],
         "targets": [TABLE5[0]], "strategies": ["uniform"]},
        {"workload": name, "sizes": SIZES, "core_counts": list(CORES),
         "targets": list(TABLE5), "strategies": ["round_robin", "uniform"]},
    )


def percentile(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def service_load(url: str, clients: int, expected: list) -> dict:
    """``clients`` ServiceClients at once, ``SERVICE_REQUESTS`` each,
    cycling through the payloads from a different start; every response
    held bit for bit against ``expected``.  Fails on any mismatch or
    failed request."""
    import threading

    from repro_torch.service.client import ServiceClient

    payloads = service_payloads()
    latencies, failures = [], []
    lock = threading.Lock()
    barrier = threading.Barrier(clients + 1)

    def run(i: int) -> None:
        client = ServiceClient(url, timeout=300)
        barrier.wait()
        for r in range(SERVICE_REQUESTS):
            k = (i + r) % len(payloads)
            t0 = time.perf_counter()
            try:
                got = client.predict(**payloads[k])
            except Exception as exc:  # noqa: BLE001 — collected, then failed
                with lock:
                    failures.append(f"client {i}: {exc!r}")
                continue
            dt = time.perf_counter() - t0
            with lock:
                latencies.append(dt)
                if got["predictions"] != expected[k]:
                    failures.append(f"client {i} payload {k}: response "
                                    "differs from sequential predict")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        fail(f"service load with {clients} clients did not finish")
    if failures:
        fail(f"service load with {clients} clients: {failures[:5]}")
    return dict(clients=clients, requests=len(latencies), wall_s=wall,
                requests_per_s=len(latencies) / wall,
                p50_ms=percentile(latencies, 50) * 1e3,
                p99_ms=percentile(latencies, 99) * 1e3)


def service_delta(before: dict, after: dict) -> dict:
    keys = ("submitted", "completed", "failed", "shed", "batches",
            "batched_requests", "coalesced", "deduped", "kernel_calls")
    d = {k: after["service"][k] - before["service"][k] for k in keys}
    d["mean_batch_size"] = d["batched_requests"] / max(d["batches"], 1)
    # per request: submit -> batch formed, batch formed -> result ready
    # (the rest of a request's latency is HTTP, JSON and the GIL)
    for k in ("queue_wait_s", "service_s"):
        d[f"mean_{k[:-2]}_ms"] = ((after["service"][k] - before["service"][k])
                                  / max(d["completed"], 1) * 1e3)
    return d


def explore_comparable(res: dict) -> dict:
    """An explore result without what depends on the process's history
    (new launch shapes) or on the store (``cached``)."""
    out = {k: v for k, v in res.items() if k not in ("stats", "cached")}
    out["stats"] = {k: v for k, v in res["stats"].items()
                    if k != "kernel_compiles"}
    return json.loads(json.dumps(out))


def phase_service() -> None:
    """The port's PredictionServer on the card with a warm Session:
    1, 8 and 64 concurrent clients (``[service]``), every response bit
    for bit a sequential ``Session.predict``'s, one ragged SDCM launch per
    batch; the 64-client load under ``torch.profiler`` (device busy and
    idle share); then the same load with one ``/explore`` on the lane
    (``[service_explore]``), its result equal to the same search alone."""
    import threading

    from repro_torch.api import AnalyticalSDCM, Session
    from repro_torch.explore import SearchSpace, run_explore
    from repro_torch.service import PredictionService, ServiceConfig
    from repro_torch.service.client import ServiceClient
    from repro_torch.service.server import PredictionServer, build_request

    t_phase = time.perf_counter()
    svc = PredictionService(config=ServiceConfig(device="cuda"))
    with svc:
        server = PredictionServer(svc, "127.0.0.1", 0)
        reference = Session(cache_model=AnalyticalSDCM(backend="batched"),
                            device="cuda")
        expected = []
        for payload in service_payloads():
            w = server.resolver.get(payload["workload"], payload["sizes"])
            res = reference.predict(w, build_request(payload, w))
            expected.append(json.loads(res.to_json())["predictions"])
        server.serve_background()
        try:
            client = ServiceClient(server.url, timeout=300)
            client.wait_ready()
            t0 = time.perf_counter()
            for payload in service_payloads():      # warm the Session
                client.predict(**payload)
            warm_s = time.perf_counter() - t0
            p99_alone = None
            for n in SERVICE_CLIENTS:
                before = svc.snapshot()
                reset_counts()
                rec = service_load(server.url, n, expected)
                launches = read_counts()["launches"]
                d = service_delta(before, svc.snapshot())
                ragged = launches["sdcm_rates_ragged"]
                if (ragged != d["kernel_calls"]
                        or sum(launches.values()) != ragged
                        or d["failed"] or d["shed"]
                        or d["completed"] != n * SERVICE_REQUESTS):
                    fail(f"service {n} clients: {ragged} ragged launches "
                         f"for {d['kernel_calls']} kernel calls, "
                         f"{launches}, {d}")
                line("service", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
                     **rec, mean_batch_size=d["mean_batch_size"],
                     mean_queue_wait_ms=d["mean_queue_wait_ms"],
                     mean_service_ms=d["mean_service_ms"],
                     batches=d["batches"], deduped=d["deduped"],
                     coalesced=d["coalesced"],
                     kernel_calls=d["kernel_calls"],
                     sdcm_rates_ragged_launches=ragged,
                     bit_identical=True, warm_up_s=warm_s)
                p99_alone = rec["p99_ms"]
            prof = device_breakdown(
                lambda: service_load(server.url, SERVICE_CLIENTS[-1],
                                     expected))
            line("service_profile", clients=SERVICE_CLIENTS[-1],
                 requests=SERVICE_CLIENTS[-1] * SERVICE_REQUESTS, **prof)

            # one /explore on the lane while the 64-client load runs
            space = dict(SWEEP_1K)
            name = f"polybench/{MAIN_WORKLOAD}"
            result = {}

            def explore():
                t = time.perf_counter()
                result["res"] = ServiceClient(server.url, timeout=600).explore(
                    name, sizes=SIZES, space={k: list(v) for k, v in
                                              space.items()},
                    agent="hillclimb", budget=SERVICE_EXPLORE_BUDGET, seed=0)
                result["s"] = time.perf_counter() - t

            before = svc.snapshot()
            reset_counts()
            th = threading.Thread(target=explore)
            th.start()
            rec = service_load(server.url, SERVICE_CLIENTS[-1], expected)
            th.join(600)
            if th.is_alive() or "res" not in result:
                fail("service explore: the /explore request did not finish")
            launches = read_counts()["launches"]
            d = service_delta(before, svc.snapshot())
            got = result["res"]
            fused = got["stats"]["fused_dispatches"]
            if launches["sdcm_rates_ragged"] != d["kernel_calls"] + fused:
                fail(f"service explore: {launches} for {d['kernel_calls']} "
                     f"predict batches and {fused} sweep launches")
        finally:
            server.shutdown()
            server.server_close()
    alone = run_explore(registry_workload(), SearchSpace(**space),
                        agent="hillclimb", budget=SERVICE_EXPLORE_BUDGET,
                        seed=0, session=Session(cache_model="batched",
                                                device="cuda"),
                        workload=name)
    if explore_comparable(got) != explore_comparable(alone):
        fail("service explore: the /explore result differs from the same "
             "search run alone")
    line("service_explore", clients=SERVICE_CLIENTS[-1], explore_s=result["s"],
         explore_evaluations=got["trajectory"]["evaluations"],
         best_score=got["best"]["score"], equals_alone=True,
         p99_ms_with_explore=rec["p99_ms"], p99_ms_without=p99_alone,
         p50_ms_with_explore=rec["p50_ms"],
         requests_per_s=rec["requests_per_s"],
         mean_batch_size=d["mean_batch_size"],
         mean_queue_wait_ms=d["mean_queue_wait_ms"],
         mean_service_ms=d["mean_service_ms"],
         kernel_calls=d["kernel_calls"], explore_sweep_launches=fused,
         sdcm_rates_ragged_launches=launches["sdcm_rates_ragged"],
         bit_identical=True, phase_s=time.perf_counter() - t_phase)


def phase_service_warm() -> None:
    """The selftest flow (``python -m repro_torch.service --selftest``)
    twice on one store: both bit-identical, the second with no profile or
    reuse-distance build."""
    import shutil

    from repro_torch.service import ServiceConfig
    from repro_torch.service.__main__ import run_selftest

    shutil.rmtree(SERVICE_STORE, ignore_errors=True)
    config = ServiceConfig(device="cuda", artifact_dir=str(SERVICE_STORE))
    runs = []
    for i in range(2):
        summary, secs = timed(lambda: run_selftest(config))
        if summary["selftest"] != "ok":
            fail(f"service selftest run {i + 1}: {summary['failures']}")
        runs.append(summary)
        line("service_warm", run=i + 1, seconds=secs,
             requests=summary["requests"], session=summary["session"],
             store=summary.get("store"),
             deduped=summary["service"]["deduped"],
             kernel_calls=summary["service"]["kernel_calls"])
    second = runs[1]["session"]
    if second["profile_builds"] or second["rd_builds"]:
        fail(f"service selftest on a warm store rebuilt work: {second}")


def phase_validate_golden() -> None:
    """The reference's golden matrix on the card, within ``GOLDEN_TOL`` of
    its committed aggregates."""
    from repro_torch.validate import MatrixSpec, run_validation

    summary, secs = timed(lambda: run_validation(
        MatrixSpec(**GOLDEN_SPEC), artifact_dir=None, processes=1,
        device="cuda"))
    agg = summary["aggregates"]
    got = {"hit": agg["overall"]["hit_rate_err_pct"]["ours"],
           "runtime": agg["overall"]["runtime_err_pct"]["ours"],
           **{m: agg["runtime_models"][m]["overall_rel_err_pct"]
              for m in GOLDEN_MODEL_ERR_PCT}}
    want = {"hit": GOLDEN_HIT_ERR_PCT, "runtime": GOLDEN_RUNTIME_ERR_PCT,
            **GOLDEN_MODEL_ERR_PCT}
    diff = {k: abs(got[k] - want[k]) for k in want}
    if agg["overall"]["cells"] != GOLDEN_CELLS or not all(
            v <= GOLDEN_TOL for v in diff.values()):
        fail(f"golden matrix on the card: {got} vs {want} "
             f"({agg['overall']['cells']} cells)")
    line("validate_golden", cells=agg["overall"]["cells"], seconds=secs,
         got=got, abs_diff=diff, tol=GOLDEN_TOL)


def phase_validate_smoke() -> None:
    """The full roster at ``smoke`` sizes, binned and sampled checks on,
    twice on one store: the second run builds no profile and no reuse
    distances; the binned gate (1e-3) and the sampling gate hold."""
    import shutil

    from repro_torch.validate import MatrixSpec, run_validation
    from repro_torch.validate.__main__ import (
        check_runtime_gate,
        check_sampling_gate,
    )
    from repro_torch.workloads.polybench import MAKERS

    shutil.rmtree(VALIDATE_STORE, ignore_errors=True)
    spec = MatrixSpec(workloads=tuple(MAKERS), sizes="smoke")
    for run in (1, 2):
        reset_counts()
        summary, secs = timed(lambda: run_validation(
            spec, artifact_dir=VALIDATE_STORE, processes=1, device="cuda"))
        launches = read_counts()["launches"]
        agg, st = summary["aggregates"], summary["session_stats"]
        line("validate_smoke", run=run, workloads=len(spec.workloads),
             cells=agg["overall"]["cells"], seconds=secs,
             reuse_hist_moments_launches=launches["reuse_hist_moments"],
             launches=launches, session_stats=st,
             hit_err_pct=agg["overall"]["hit_rate_err_pct"]["ours"],
             runtime_err_pct=agg["overall"]["runtime_err_pct"]["ours"],
             binned=agg["binned_profile"], sampled=agg["sampled_profile"],
             runtime_gate=check_runtime_gate(agg)[1])
        if run == 1 and launches["reuse_hist_moments"] <= 0:
            fail("validation smoke: the binned check launched no B2")
    if st["profile_builds"] or st["rd_builds"]:
        fail(f"validation smoke: the second run rebuilt work: {st}")
    if not agg["binned_profile"]["within_tolerance"]:
        fail(f"validation smoke: binned gate: {agg['binned_profile']}")
    passed, msg = check_sampling_gate(agg)
    if not passed:
        fail(f"validation smoke: {msg}")


def phase_validate_xxl() -> None:
    """``run_workload`` on the main workload at full size: 3 CPUs x cores
    1/2/4/8 x both strategies, binned and sampled checks on, with the
    seconds of each part (predict, binned, sampled, exact LRU)."""
    import collections

    from repro_torch.api import Session
    from repro_torch.validate import MatrixSpec, run_workload

    parts = collections.defaultdict(float)
    predict, ground_truth = Session.predict, Session.ground_truth_hit_rates

    def part(self) -> str:
        if getattr(self.builder, "binned", False):
            return "binned"
        return "sampled" if getattr(self.builder, "sampled", None) else \
            "predict"

    def timed_predict(self, *a, **kw):
        out, secs = timed(lambda: predict(self, *a, **kw))
        parts[part(self)] += secs
        return out

    def timed_ground_truth(self, *a, **kw):
        out, secs = timed(lambda: ground_truth(self, *a, **kw))
        parts["exact_lru"] += secs
        return out

    spec = MatrixSpec(workloads=(f"polybench/{MAIN_WORKLOAD}",), sizes=SIZES)
    Session.predict = timed_predict
    Session.ground_truth_hit_rates = timed_ground_truth
    try:
        reset_counts()
        payload, secs = timed(lambda: run_workload(
            f"polybench/{MAIN_WORKLOAD}", spec, None, device="cuda"))
        counts = read_counts()
    finally:
        Session.predict = predict
        Session.ground_truth_hit_rates = ground_truth
    recs = payload["records"]
    want = len(TABLE5) * len(CORES) * len(spec.strategies)
    binned = max(v for r in recs for v in r["binned_abs_dev"].values())
    exceed = sum(dev > r["sampled_bound"][lvl] for r in recs
                 for lvl, dev in r["sampled_abs_dev"].items())
    if len(recs) != want or binned > BINNED_TOL or exceed:
        fail(f"validation xxl: {len(recs)} cells (want {want}), binned "
             f"deviation {binned}, {exceed} sampled cells over their bound")
    if counts["launches"]["reuse_hist_moments"] <= 0:
        fail("validation xxl: the binned check launched no B2")
    line("validate_xxl", workload=f"polybench/{MAIN_WORKLOAD}@{SIZES}",
         refs=payload["refs"], cells=len(recs), seconds=secs,
         part_s=dict(parts), launches=counts["launches"],
         max_memory_allocated=counts["max_memory_allocated"],
         max_binned_abs_dev=binned,
         hit_err_pct=float(np.mean([e["abs_err_pct"] for r in recs
                                    for e in r["levels"].values()])),
         runtime_err_pct=float(np.mean([r["runtime_rel_err_pct"]
                                        for r in recs])),
         session_stats=payload["session_stats"])


# --- the model zoo: flash attention (B4), SSD scan (B5), serving --------------

SERVE_BATCH, SERVE_PROMPT = 4, 2048
ZAMBA_GEN, MAMBA_GEN = 32, 16
ZAMBA_CACHE = SERVE_PROMPT + ZAMBA_GEN   # the serving KV cache's length


def cuda_rand(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rand


def flash_work(q, k, causal: bool, q_offset: int, kv_len: int):
    """(bytes, operations) of one attention call: q, o and the visible
    K/V rows once each; 4·D operations per visible (row, column) pair
    (Q K^T and P V; the softmax's exps are not counted)."""
    b, h, sq, d = q.shape
    rows = np.arange(sq)
    vis = (np.minimum(kv_len, q_offset + rows + 1) if causal
           else np.full(sq, kv_len))
    nbytes = q.element_size() * d * (2 * b * h * sq + 2 * b * k.shape[1]
                                     * kv_len)
    return float(nbytes), 4.0 * d * float(vis.sum()) * b * h


def sdpa_library(q, k, v, causal: bool, q_offset: int, kv_len: int):
    """The same attention by ``scaled_dot_product_attention`` (timed as a
    yardstick only; the port never calls it)."""
    k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    sq = q.shape[2]
    kw = dict(enable_gqa=q.shape[1] != k.shape[1])
    if causal and q_offset == 0 and sq == kv_len:
        kw["is_causal"] = True
    elif causal and q_offset < kv_len - 1:
        rows = torch.arange(sq, device=q.device)[:, None]
        kw["attn_mask"] = (torch.arange(kv_len, device=q.device)[None, :]
                           <= q_offset + rows)
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, **kw)


def phase_flash() -> dict:
    """B4 against its plain version and SDPA, one row per case, each on
    the kernel form the wrapper picks for it (checked); returns the
    kernels record at the zamba2-1.2b serving prefill shape (bf16, its
    cache of 2080) with one entry per form under ``forms``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        kernel_form,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    b, s, cache = SERVE_BATCH, SERVE_PROMPT, ZAMBA_CACHE
    cases = [  # tag, form, B, H, Hkv, Sq, Sk, D, dtype, q_offset, kv_len
        ("zamba2_prefill", "tensor_core", b, 32, 32, s, cache, 64, bf16, 0,
         s),
        ("zamba2_decode", "split_kv", b, 32, 32, 1, cache, 64, bf16, s - 1,
         s),
        # kv_len 2000, not a multiple of the 128-column split
        ("zamba2_decode_kv2000", "split_kv", b, 32, 32, 1, cache, 64, bf16,
         s - 49, s - 48),
        ("gqa_32_over_8_d128_decode", "split_kv", b, 32, 8, 1, cache, 128,
         bf16, s - 1, s),
        ("zamba2_prefill_f32", "simt", b, 32, 32, s, cache, 64, f32, 0, s),
        ("gqa_32_over_8_d128", "tensor_core", 2, 32, 8, s, s, 128, bf16, 0,
         s),
        ("ragged_1000", "tensor_core", 2, 32, 32, 1000, 1000, 64, bf16, 0,
         1000),
    ]
    records, worst, forms = {}, 0.0, {}
    for i, (tag, form, b, h, hkv, sq, sk, d, dt, off, kvl) in enumerate(
            cases):
        rand = cuda_rand(10 + i)
        q = rand(b, sq, h, d, dtype=dt).transpose(1, 2)
        k = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        v = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        if kernel_form(q, k, v) != form:
            fail(f"flash_attention {tag}: runs on the {kernel_form(q, k, v)} "
                 f"form, expected {form}")
        kw = dict(causal=True, q_offset=off, kv_len=kvl)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= FLASH_TOL[dt]:
            fail(f"flash_attention {tag}: max |kernel - plain| = {err} > "
                 f"{FLASH_TOL[dt]}")
        scaled = err / float(want.float().abs().max())
        if dt == bf16 and not scaled <= FLASH_SCALED_TOL_BF16:
            fail(f"flash_attention {tag}: max |kernel - plain| / max |plain| "
                 f"= {scaled} > {FLASH_SCALED_TOL_BF16}")
        worst = max(worst, err)
        lib = sdpa_library(q, k, v, True, off, kvl)
        lib_err = float((lib.float() - want.float()).abs().max())
        nbytes, ops = flash_work(q, k, True, off, kvl)
        b_ms, b_by = bound_ms(nbytes, ops,
                              PEAK_BF16_S if dt == bf16 else PEAK_FP32_S)
        rec = dict(form=form, shape=[b, h, hkv, sq, sk, d], dtype=str(dt),
                   q_offset=off, kv_len=kvl, max_abs_err=err,
                   tol=FLASH_TOL[dt], scaled_err=scaled,
                   ms=cuda_ms(lambda: flash_attention(q, k, v, **kw)),
                   graph_ms=graph_ms(lambda: flash_attention(q, k, v, **kw)),
                   plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                                  **kw),
                                    reps=3, warmup=1),
                   library_ms=cuda_ms(lambda: sdpa_library(q, k, v, True,
                                                           off, kvl)),
                   library_graph_ms=graph_ms(lambda: sdpa_library(
                       q, k, v, True, off, kvl)),
                   library_max_abs_diff=lib_err, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, operations=ops)
        line("flash", case=tag, **rec)
        records[tag] = rec
        forms.setdefault(form, dict(case=tag, **{
            key: rec[key] for key in ("ms", "graph_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "library_graph_ms", "max_abs_err",
                                      "scaled_err")}))
        del q, k, v, got, want, lib
    path = records["zamba2_prefill"]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:27",
        "launches": 0,
        "max_abs_err": worst,
        **{k: path[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "graph_ms",
                                "library_graph_ms")},
        "forms": forms,
    }


def ssd_ops(s: int, b: int, h: int, p: int, n: int, chunk: int) -> float:
    """Operations of the chunked scan: per chunk of ``lc`` steps, the
    lc(lc+1)/2 score pairs times N (c·b, once per batch row: it does not
    depend on the head) and, per head, times P (scores·x), and lc·N·P
    twice per head (c·h_in and the state update); two per multiply-add."""
    total = 0.0
    for c0 in range(0, s, chunk):
        lc = min(chunk, s - c0)
        total += 2.0 * (lc * (lc + 1) / 2 * (n + h * p)
                        + 2.0 * h * lc * n * p)
    return total * b


def phase_ssd() -> dict:
    """B5 against its plain version; returns the record at the
    zamba2-1.2b prefill shape."""
    from repro_torch.kernels.ssd_scan import CHUNK, ssd_scan, ssd_scan_plain

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # tag, B, S, H, P, N, dtype of b and c (x f32, with h0)
        ("zamba2_prefill", SERVE_BATCH, SERVE_PROMPT, 64, 64, 64, f32),
        ("mamba2_780m_prefill", SERVE_BATCH, SERVE_PROMPT, 48, 64, 128, f32),
        ("prime_2039", 2, 2039, 64, 64, 64, f32),  # the largest prime < 2048
        # the served models' layout: b and c in bf16, read as they are
        ("zamba2_prefill_bf16_bc", SERVE_BATCH, SERVE_PROMPT, 64, 64, 64,
         bf16),
        ("mamba2_780m_prefill_bf16_bc", SERVE_BATCH, SERVE_PROMPT, 48, 64,
         128, bf16),
    ]
    records, worst = {}, 0.0
    for i, (tag, b, s, h, p, n, bc_dt) in enumerate(cases):
        rand = cuda_rand(20 + i)
        x = rand(b, s, h, p)
        la = -torch.nn.functional.softplus(rand(b, s, h) - 1.0)
        bb = rand(b, s, n, dtype=bc_dt) * 0.3
        cc = rand(b, s, n, dtype=bc_dt) * 0.3
        h0 = rand(b, h, n, p)
        y, final = ssd_scan(x, la, bb, cc, h0)
        y_p, final_p = ssd_scan_plain(x, la, bb, cc, h0)
        torch.cuda.synchronize()
        errs = [float((got - want).abs().max()) / float(want.abs().max())
                for got, want in ((y, y_p), (final, final_p))]
        if not max(errs) <= SSD_TOL:
            fail(f"ssd_scan {tag}: scaled |kernel - plain| = {errs} > "
                 f"{SSD_TOL}")
        err = max(float((y - y_p).abs().max()),
                  float((final - final_p).abs().max()))
        worst = max(worst, err)
        nbytes = (4.0 * (2 * b * s * h * p + b * s * h + 2 * b * h * n * p)
                  + bb.element_size() * 2.0 * b * s * n)
        ops = ssd_ops(s, b, h, p, n, CHUNK)
        b_ms, b_by = bound_ms(nbytes, ops, PEAK_FP32_S)
        rec = dict(shape=[b, s, h, p, n], bc_dtype=str(bc_dt),
                   scaled_err_y=errs[0],
                   scaled_err_final=errs[1], max_abs_err=err, tol=SSD_TOL,
                   ms=cuda_ms(lambda: ssd_scan(x, la, bb, cc, h0)),
                   graph_ms=graph_ms(lambda: ssd_scan(x, la, bb, cc, h0)),
                   plain_ms=cuda_ms(lambda: ssd_scan_plain(x, la, bb, cc, h0),
                                    reps=3, warmup=1),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=ops)
        line("ssd_scan", case=tag, **rec)
        records[tag] = rec
    path = records["zamba2_prefill_bf16_bc"]  # the served models' inputs
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:36",
        "launches": 0,
        "max_abs_err": worst,
        **{k: path[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
        "graph_ms": path["graph_ms"],
    }


def sdpa_attention(q, k, v, *, causal: bool, scale=None, q_offset: int = 0,
                   kv_len=None):
    """B4's function by SDPA, for ``plain_kernels(flash="sdpa")``."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    return sdpa_library(q, k, v, causal, q_offset, kv_len)


class plain_kernels:
    """Inside ``with plain_kernels():`` the models call B4's and B5's
    plain versions on the card instead of the kernels; ``flash`` and
    ``scan`` pick each one ("plain", "kernel", or for B4 "sdpa")."""

    def __init__(self, flash: str = "plain", scan: str = "plain"):
        self.flash, self.scan = flash, scan

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as scan

        self.saved = (fa.flash_attention, scan.ssd_scan)
        fa.flash_attention = {"plain": fa.flash_attention_plain,
                              "kernel": fa.flash_attention,
                              "sdpa": sdpa_attention}[self.flash]
        scan.ssd_scan = {"plain": scan.ssd_scan_plain,
                         "kernel": scan.ssd_scan}[self.scan]

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssd_scan as scan

        fa.flash_attention, scan.ssd_scan = self.saved


def teacher_forced(spec, cfg, model, prompt, tokens) -> torch.Tensor:
    """Logits [gen, B, V] of the prefill of ``prompt`` and of one decode
    step per generated token, fed the given ``tokens``."""
    fam = spec.family
    b, plen = prompt.shape
    caches = fam.init_caches(cfg, b, plen + tokens.shape[1], device="cuda")
    logits, caches = fam.prefill(
        model, {"tokens": torch.from_numpy(prompt).long().cuda()}, cfg,
        caches)
    out = [logits.float()]
    for t in range(tokens.shape[1] - 1):
        tok = torch.from_numpy(tokens[:, t:t + 1]).long().cuda()
        logits, caches = fam.decode_step(model, {"token": tok}, cfg, caches,
                                         plen + t)
        out.append(logits.float())
    return torch.stack(out)[..., :spec.vocab]


def kernel_vs_plain_logits(spec, cfg, model, res, tag: str) -> dict:
    """Teacher-forced logits through the kernels and through the plain
    versions on the card: in the model's dtype, then with the same
    weights in f32.  In bf16 with attention, ``spread`` also gives the
    distance from the plain path with one kernel at a time, and with
    SDPA for B4 (a library's rounding: how far any other bf16
    attention lands); the gate reads only the path with both kernels."""
    import dataclasses

    out = {}
    for dt, tol in ((cfg.dtype, SERVE_REL_TOL),
                    (torch.float32, SERVE_REL_TOL_F32)):
        cfg_dt = dataclasses.replace(cfg, dtype=dt)
        model = model.to(dt)
        got = teacher_forced(spec, cfg_dt, model, res["prompt"],
                             res["tokens"])
        with plain_kernels():
            want = teacher_forced(spec, cfg_dt, model, res["prompt"],
                                  res["tokens"])
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"{tag} {dt}: non-finite logits")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not diff / scale <= tol:
            fail(f"{tag} {dt}: kernel-path logits differ from the plain "
                 f"path's by {diff} (scale {scale}, > {tol} relative)")
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        rec = dict(steps=got.shape[0], max_abs_diff=diff, logit_scale=scale,
                   rel=diff / scale, tol=tol, argmax_agreement=agree)
        if dt != torch.float32 and spec.family_name == "hybrid":
            rec["spread"] = {}
            for name, kw in (("b4_kernel_only", dict(flash="kernel")),
                             ("b5_kernel_only", dict(scan="kernel")),
                             ("sdpa_b4_plain_b5", dict(flash="sdpa"))):
                with plain_kernels(**kw):
                    other = teacher_forced(spec, cfg_dt, model,
                                           res["prompt"], res["tokens"])
                rec["spread"][name] = float(
                    (other - want).abs().max()) / scale
        out[str(dt).replace("torch.", "")] = rec
    return out


def serve_path(arch: str, gen: int, want_launches: dict):
    """Serve ``arch`` at full width and depth with counts set to 0 just
    before and read just after; fails unless each kernel of the path
    launched exactly as often as the path needs."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    spec = get_arch(arch)
    model = spec.family.init(spec.config, device="cuda", seed=0)
    reset_counts()
    res = serve.serve(arch, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                      gen=gen, seed=0, device="cuda", model=model)
    counts = read_counts()
    launches = counts["launches"]
    for name, n in want_launches.items():
        if launches[name] != n:
            fail(f"{arch} serve path launched {name} {launches[name]} "
                 f"times, expected {n}: {launches}")
    rec = dict(arch=arch, dtype=res["dtype"], batch=SERVE_BATCH,
               prompt_len=SERVE_PROMPT, gen=gen,
               params=sum(t.numel() for t in model.parameters()),
               prefill_s=res["prefill_s"], decode_s=res["decode_s"],
               decode_ms_per_step=res["decode_ms_per_step"],
               decode_tok_s=res["decode_tok_s"],
               max_memory_allocated=counts["max_memory_allocated"],
               launches={k: launches[k] for k in want_launches},
               sample_tokens=res["tokens"][0, :8].tolist())
    return spec, model, res, rec


def device_breakdown(fn) -> dict:
    """Wall time of ``fn`` (ending in a synchronise), the device's busy
    time in it (the sum of every kernel's and copy's device time in a
    ``torch.profiler`` trace; one stream, so no overlap) and the idle
    share, with the kernels that take the most device time.  The
    profiler adds host time to every launch, so the idle share is an
    upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(ms for _, ms, _ in rows)
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    top = sorted(rows, key=lambda r: -r[1])[:8]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms,
                top=[dict(kernel=k[:80], ms=ms, count=n) for k, ms, n in top])


def profile_serve(spec, model, res, steps: int = 4) -> dict:
    """``device_breakdown`` of one prefill of the served prompt and of
    ``steps`` decode steps after it."""
    fam, cfg = spec.family, spec.config
    b, plen = res["prompt"].shape
    caches = fam.init_caches(cfg, b, plen + steps, device="cuda")
    state = {}

    def prefill():
        state["out"] = fam.prefill(
            model, {"tokens": torch.from_numpy(res["prompt"]).long().cuda()},
            cfg, caches)

    def decode():
        logits, c = state["out"]
        for t in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            logits, c = fam.decode_step(model, {"token": tok}, cfg, c,
                                        plen + t)

    return dict(prefill=device_breakdown(prefill),
                decode_steps=steps, decode=device_breakdown(decode))


def decode_consistency(spec, layers: int, total: int, split: int) -> dict:
    """At full width and ``layers`` depth in f32: prefill of the whole
    prompt against the prefix plus one decode step per remaining token,
    through the kernels (gated) and through the plain versions (for
    comparison)."""
    import dataclasses

    cfg = dataclasses.replace(spec.config, layers=layers, dtype=torch.float32)
    fam = spec.family
    model = fam.init(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, spec.vocab, (2, total))).cuda()

    def run():
        full, _ = fam.prefill(model, {"tokens": toks}, cfg,
                              fam.init_caches(cfg, 2, total, device="cuda"))
        logits, caches = fam.prefill(
            model, {"tokens": toks[:, :split]}, cfg,
            fam.init_caches(cfg, 2, total, device="cuda"))
        for t in range(split, total):
            logits, caches = fam.decode_step(
                model, {"token": toks[:, t:t + 1]}, cfg, caches, t)
        got, want = logits[:, :spec.vocab], full[:, :spec.vocab]
        diff = (got - want).abs()
        scale = float(want.abs().max())
        return dict(max_abs_diff=float(diff.max()), logit_scale=scale,
                    rel=float(diff.max()) / scale,
                    elementwise_excess=float((diff - CONSISTENCY_TOL
                                              - CONSISTENCY_TOL
                                              * want.abs()).max()))

    kernels = run()
    with plain_kernels():
        plain = run()
    if not kernels["rel"] <= CONSISTENCY_TOL:
        fail(f"{spec.arch_id} f32 depth {layers}: prefix + decode differs "
             f"from the whole prefill: {kernels} (plain versions: {plain})")
    return dict(layers=layers, dtype="float32", prompt=total, split=split,
                tol=CONSISTENCY_TOL, kernels=kernels, plain=plain)


def phase_zamba2_serve() -> dict:
    """The zamba2-1.2b serve path; returns its B4 (in all and by form)
    and B5 launches.  The 6 prefill attentions run on B4's tensor-core
    form, the 6 of each of the 31 decode steps on its split-KV form."""
    spec, model, res, rec = serve_path(
        "zamba2-1.2b", ZAMBA_GEN,
        {"flash_attention": 6 * ZAMBA_GEN, "tensor_core": 6,
         "split_kv": 6 * (ZAMBA_GEN - 1), "simt": 0, "ssd_scan": 38})
    line("zamba2_serve", **rec)
    line("zamba2_profile", **profile_serve(spec, model, res))
    line("zamba2_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "zamba2 serve"))
    del model
    torch.cuda.empty_cache()
    # 2 groups of 6 Mamba2 layers plus 2 trailing ones, as in the full 38
    line("zamba2_decode_consistency",
         **decode_consistency(spec, 14, 300, 290))
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_mamba2_serve() -> None:
    spec, model, res, rec = serve_path(
        "mamba2-780m", MAMBA_GEN,
        {"ssd_scan": 48, "flash_attention": 0, "tensor_core": 0,
         "split_kv": 0, "simt": 0})
    line("mamba2_serve", **rec)
    line("mamba2_profile", **profile_serve(spec, model, res))
    line("mamba2_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "mamba2 serve"))
    del model
    torch.cuda.empty_cache()



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
    phase_per_set()
    exact, sdcm_kernel = phase_main_path()
    binned_sess, hist_kernels, binned_errs = phase_binned_main_path(exact)
    streaming_errs = phase_streaming_main_path(exact, binned_sess)
    phase_reuse_idle()
    gt = phase_ground_truth(exact)
    phase_sampled_main_path(exact)
    phase_registry(exact)
    phase_store(gt)
    hit_probs_kernel = phase_sweep()
    phase_explore()
    phase_service()
    phase_service_warm()
    phase_validate_golden()
    phase_validate_smoke()
    phase_validate_xxl()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    flash_kernel, ssd_kernel = phase_flash(), phase_ssd()
    serve_launches = phase_zamba2_serve()
    for rec in (flash_kernel, ssd_kernel):
        rec["launches"] = serve_launches[rec["name"]]
    for form, rec in flash_kernel["forms"].items():
        rec["launches"] = serve_launches[form]
    phase_mamba2_serve()
    phase_more_workloads(t_start)
    kernels = ([sdcm_kernel, hit_probs_kernel] + hist_kernels
               + [flash_kernel, ssd_kernel])
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
