"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--out results.json]

Needs one CUDA device; exits non-zero without one.  Phases, each
printing its results on lines of its own, and any failure ends the run
with a non-zero exit:

1. device — the card's name and power limit; builds every CUDA kernel
   of the port from this checkout's sources (one nvcc per source, in
   parallel) and prints the build time and register use.
2. SDCM kernel vs its plain PyTorch version, per-reference form
   (``sdcm_hit_probs``, the binomial's terms summed from its mode): ~4M
   seeded distances at every Table-5 level geometry, gpu-sm's, A = 1,
   A = 64 and fully associative, and a stream on which a sum started at
   k = 0 or at A - 1 would underflow, at five geometries.  ``python3
   chip_smoke.py --phase hit_probs`` runs it alone.
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
    and at a GQA decode step (32 over 8, head dim 128: llama3-8b's, whose
    prefill shape is a row too); the tensor-core f32 form (3xTF32) at the
    prefill shape; the f32 split-KV form at f32 decode steps (zamba2's,
    at kv_len 2,000, llama3's GQA at D 128, mixtral's past its window,
    phi-3's at D 96, and seamless's cross-attention step, not causal);
    and with mixtral's sliding window of 4,096 the
    tensor-core form at its prefill (B 2, S 6,144), the split-KV form at a
    decode step past the window (splits below the band skipped) and the
    tensor-core f32 form with the band's edge mid-tile (W 1,000); at
    phi-3-vision's head dim 96 the tensor-core form at its prefill, the
    split-KV form at a decode step and the tensor-core f32 form; the
    CUDA-core form in f32 at D 16 and in bf16 at D 32 at the prefill shape,
    and at an f32 decode step whose rows are not 16-byte aligned; and
    without causality, at
    seamless-m4t-medium's shapes, the tensor-core form at its encoder and
    its cross-attention prefill and the split-KV form at a cross-attention
    decode step (one row over the 2,048-frame source).  Each bf16 row is also held to
    ``FLASH_SCALED_TOL_BF16`` of the plain version's largest output; the
    f32 rows on the tensor-core f32 form also give ``bound_tc_ms`` (their
    operations as 3xTF32 at the TF32 rate) beside ``bound_ms``.
    ``ms`` and SDPA's ``library_ms`` time the calls issued one by one,
    as every kernel's ``ms`` does; ``graph_ms`` and
    ``library_graph_ms`` time the same calls replayed from a CUDA graph,
    which leaves the host's cost per call out.  ``python3 chip_smoke.py
    --phase flash`` runs it alone.
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
    scale).  Each f32 check reports its launches by form (prefills on
    B4's tensor-core f32 form, decode steps on its f32 split-KV form, and
    none on its CUDA-core form) and counts on that form's path in the
    kernels line.
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
    space ``inner="pallas"`` (B1's per-reference form: one
    ``sdcm_hit_probs_ragged`` launch per ``sweep_grid`` call, counted, and
    timed at the sweep's own calls beside the one-geometry launches it
    replaces) within 1e-6 of ``inner="vmap"``, and the warm per-config
    ``Session.predict`` loop timed beside the sweep (``--phase sweep``
    runs the sweep alone).  The autotuner (``run_explore``) on the 10k
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
9d. Model-derived traces: every ``model/<slug>/{prefill,decode}`` cell
    (20) resolved on a store under ``build/chip_smoke_model_store`` and
    recorded on the host (``analysis/aten_trace.py``: seconds of the
    recording and of the trace build, refs, blocks, touched bytes);
    predicted on the card over the Table-5 CPUs x cores {1, 2, 4, 8} x
    round_robin and tpu-v5e at core 1 (one ``predict_many`` a cell, one
    SDCM launch cold and warm), within 1e-6 of the float64 oracle and of
    the CPU port's predict; all 20 cells in one ``predict_many`` (one
    launch) with B1 against its plain version and timed at those rows;
    the service on the reference's selftest payload
    (``model/llama3_8b/decode`` on tpu-v5e: 200, ``Session.predict``'s
    answer) and on a ``train`` cell (200, the same); every cell again from
    the warm store with no recording and no build; ``run_validation`` on
    ``model/llama3_8b/decode`` over the Table-5 CPUs x cores {1, 2, 4}
    (exact LRU on the card, B2's binned check), and B2 against its plain
    version on every distance stream that check feeds it (counts and
    masses equal).
13. The mamba2-780m serve path: batch 4, prompt 2048, 16 tokens, B5
    launches read around it, the same profile and the same
    teacher-forced check.
14. The llama3-8b serve path at full width and depth (32 layers, bf16,
    seeded, 8,030,261,248 parameters): batch 4, prompt 2048, 32 tokens;
    B4 launches exactly 32 tensor-core and 992 split-KV; the same
    profile, teacher-forced check (bf16 and f32) and, at 8 layers in
    f32, the decode consistency.
14b. ``[moe]``: the MoE layer's expert pipeline (``kernels/moe``) at
    mixtral's widths (8 experts, d 4,096, f 14,336) and the mixtral
    benchmark cells' routing, seeded (4,480 and 3,520 tokens, expert load
    1.71 and 1.46): the dispatch and the combine bit for bit against
    their plain versions, both grouped GEMMs within bf16 rounding of
    theirs, the whole pipeline within 2e-2 of the host loop; the two GEMMs
    timed (``ms``, ``graph_ms``) beside their bound (6·d·f a pair at 989
    TFLOP/s), the plain versions, the per-expert ``torch.matmul`` calls of
    the same products (``library_ms``), the whole pipeline and the loop;
    ``[moe_decode]``: the pipeline and the loop at a decode step's 2 and
    16 tokens.  ``python3 chip_smoke.py --phase moe`` builds the MoE library alone and
    runs it.
15. The mixtral-8x7b serve path at full widths and 16 of its 32 layers
    (the whole model does not fit one card): batch 2, prompt 6,144 past
    the 4,096-token window, 16 tokens; B4 launches exactly 16 tensor-core
    and 240 split-KV, every one windowed; the MoE pipeline exactly 256
    dispatches, 512 grouped GEMMs and 256 combines (16 layers, the
    prefill and 15 decode steps); ``[mixtral_decode_vs_loop]``, the
    decode steps' ms with the MoE layers on the pipeline and on the host
    loop, two rounds each; the profile, the bf16
    teacher-forced check (the MoE layers on their grouped kernels against
    the pipeline's plain version), and at 2 layers in f32 the decode
    consistency over 4,200 tokens split at 4,190.
16. The seamless-m4t-medium serve path at full width and depth (12
    encoder and 12 decoder layers, 977,860,608 parameters, bf16): batch
    4, 2,048 seeded source frames, a 2,048-token prompt, 32 tokens; B4
    launches exactly 36 tensor-core (12 encoder, 12 self, 12 cross) and
    744 split-KV (12 self and 12 cross a step); the profile, the
    teacher-forced check (bf16 and f32) and, at 4 + 4 layers in f32, the
    decode consistency (300 frames, prompt 300 split at 290).
17. The phi-3-vision-4.2b serve path at full width and depth (32 layers,
    head dim 96, 3,824,618,496 parameters): batch 4, 1,024 seeded patch
    embeddings ahead of a 1,024-token prompt, 32 tokens, decode steps at
    ``num_patches + prompt + t``; B4 exactly 32 tensor-core and 992
    split-KV, all at D 96; the profile, the teacher-forced check (bf16 and
    f32) and, at 8 layers in f32, the decode consistency (1,024 patches and
    300 tokens split at 290).
17b. ``[kernel_backward]`` (ROADMAP B8): the backward kernels of B4
    (``flash_bwd.cu``: tensor-core, tensor-core f32 and CUDA-core forms,
    each case checked to run on its form) and B5
    (``ssd_scan_bwd.cu``) against their plain versions on the card: B4's
    against ``flash_attention_bwd`` and autograd through
    ``flash_attention_plain``, B5's against ``ssd_scan_bwd_plain`` and
    autograd through ``ssd_scan_plain``, each gradient's max |kernel -
    plain| over its largest |plain| within ``BWD_TOL`` and each row's over
    the row's rms within ``BWD_ROW_TOL``, every case launched twice with
    equal bits; at the train shapes in bf16 and f32
    and, for B4, GQA, a window, not causal with Sq != Sk, D 96, D 16 and
    ``q_offset`` / ``kv_len`` (in f32 on both the tensor-core f32 form and
    the CUDA-core form), and in f32 at D 64 and D 128 with GQA with q and
    k scaled so that |scale q k^T| reaches 20 (``BWD_FLASH_SHARP``: held
    to the plain versions in f64, the same tolerances, their distance from
    the plain version in f32 reported beside); for B5 N 128, ragged S,
    ``h0``, a final-state gradient, bf16 x, b and c.  B4's tensor-core
    forms read the forward's
    log-sum-exp (held to the plain version's, ``LSE_TOL``) and output.
    Timed at the train shapes (eager, replayed, each launch's device ms,
    the plain versions; SDPA's backward beside B4's, the 3xTF32
    tensor-core bound beside B5's and B4's f32), B4 in bf16, in f32 and,
    for its CUDA-core form, at D 16 in f32.
    ``python3 chip_smoke.py --phase kernel_backward`` runs it alone.
18. Training (ROADMAP A-11b): ``repro_torch.launch.train.train`` on
    zamba2-1.2b at full width and depth (38 Mamba2 layers, the shared
    attention at 6 sites, about 1.1e9 parameters), bf16, AdamW, batch 4
    x 2,048 tokens of seeded ``SyntheticStream`` data: one warm-up and 4
    timed steps, the loss, gradient norm and every parameter finite
    after each update; B4 exactly 6 launches a step (tensor-core form,
    not remat'ed) and B5 exactly 76 (each Mamba2 layer's forward and its
    remat recomputation), and their backward kernels 6 (tensor-core) and
    38; seconds a step, tokens/s, peak memory; a
    ``torch.profiler`` split of one more step into forward, backward and
    optimizer (the backward kernels' own times are 17b's); the
    kernel path against the plain path on the same weights and batch (in
    bf16 at full depth the loss within 1e-2 and the gradient norm within
    ``SERVE_REL_TOL``; in f32 at 6 layers the loss within 1e-4 and every
    gradient leaf within 1e-4 of its largest value, B4 forward and
    backward on its tensor-core f32 forms); one step of each
    architecture's reduced config (arctic-480b with Adafactor and bf16
    accumulators); and the 10 ``model/<slug>/train`` cells recorded and
    predicted as in 9d, one SDCM launch each.  More validation-xxl
    workloads follow while time allows.
18b. ``[checkpoint]`` (ROADMAP A-11c): phase 18's zamba2-1.2b state
    saved through ``runtime.checkpoint.CheckpointManager`` (async, the
    reference's format, about 13.4 GB, under ``build/``, deleted after):
    snapshot, write and restore seconds and bytes; the restore into a
    freshly built model, in place, bit-equal to the saved state; 2 steps
    from the live state and 2 from the restored one under
    ``torch.use_deterministic_algorithms(True)``, losses, gradient norms
    and every leaf bit-equal (an op without a deterministic CUDA form is
    named and the two runs held to ``SERVE_REL_TOL`` instead); B4 and
    B5 launches on the resumed steps (``launches_by_path
    ["zamba2-1.2b/resume"]``); ``plan_remesh`` onto the host mesh with
    ``fits`` against the card's memory.
18c. ``[dryrun]``: ``launch.dryrun.run_cell`` on the host mesh for one
    full-size cell a family (``prefill_32k``), recorded on the meta
    device; the dry-run's predicted peak (arguments + temporaries)
    against ``max_memory_allocated`` for zamba2-1.2b's train step and
    llama3-8b's prefill, both at 4 x 2,048, each ratio within
    [0.9, 1.15].
18d. ``[dryrun_partition]`` (ROADMAP A-11d): ``launch.dryrun.dry_run``
    of zamba2-1.2b x prefill_32k on the 16 x 16 pod mesh, partitioned
    on the meta device (DTensor over a fake process group of 256):
    per-partition FLOPs, ``ici_bytes``, collective counts and
    ``device_bytes``; then rank 0's partition of that step run on the
    card (its local shards made on the card from a seed, the
    collectives through the fake group, which allocates their results
    and moves nothing), its predicted peak (arguments + temporaries)
    within [0.9, 1.15] of ``max_memory_allocated``, the logits finite;
    B4 and B5 launched on the local shards (``launches_by_path
    ["pod/zamba2-1.2b/prefill_32k"]``: 6 and 38) and, on a second run,
    their first launch's outputs held to their plain versions on the
    same local shards (``FLASH_TOL``, ``SSD_TOL``).
19. ``[lint]``: ``python -m repro_torch.lint --check`` with the committed
    baseline over src, tools and tests (exit 0 or the run fails), with
    files, findings and inline suppressions per family and the seconds.
20. ``[lint_runtime]``: paths run under
    ``torch.cuda.set_sync_debug_mode("warn")`` with every warning
    recorded and charged to the port line that synchronised: one warm
    exact predict of 7 (B1), one cold binned predict (B1, B2), one cold
    streaming predict at 2^16 (B1), and a 256-token prefill plus three
    decode steps (``serve.serve``, batch 2) of mixtral-8x7b and
    llama3-8b at full width and 2 layers and zamba2-1.2b at 8 (B4, B5),
    and zamba2-1.2b's loss and gradient at 8 layers (B4, B5 and their
    backward kernels, whose wrappers may not sync at all); mixtral's
    MoE layers on the grouped GEMM.
    A line that syncs more than once in one call is a sync in a loop:
    the TS lint rules must report it (flagged or suppressed), or it is
    in ``KNOWN_MISSED`` with the reason they cannot see it; never
    ``models/moe.py:210`` and never a site of a predict path.

The backward kernels' records carry ``launches_by_path`` with the
training path, the resumed steps and ``lint_runtime``.
B4's and B5's kernel records carry ``launches_by_path`` with the
training path (``zamba2-1.2b/train``), the resumed steps
(``zamba2-1.2b/resume``) and the pod partition
(``pod/zamba2-1.2b/prefill_32k``), B1's with ``model_traces/train``,
and B1's, B2's (moments), B4's and B5's with ``lint_runtime``.  The
grouped GEMM's record (``moe_gemm``) carries the mixtral serve path's
launches and ``lint_runtime``'s.
Every kernel's ``ms`` times 20 calls issued one by one (what a caller
pays, host work included), its ``graph_ms`` the same calls replayed from
a CUDA graph (the device time).  Every predict in 7-9b and 9d must make
exactly one SDCM launch, and every service batch in 9c.  The last lines are the
``{"kernels": [...]}`` record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import logging
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
PEAK_TF32_S = 495e12  # tensor cores, dense
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
# bf16 attention on a long causal row, besides FLASH_TOL: the largest
# |kernel - plain| of a row over that row's rms of plain, over every row.
# Row i averages ~i values, so its outputs are ~1/sqrt(i) of the first
# rows': at 32,768 rows they are ~0.03, as small as FLASH_TOL.  On the pod
# partition's shards a sound kernel reads 0.0297 (two bf16 ulps of a
# row's largest output, ~3x its rms); one that drops a KV tile of 64 from
# every row past 16,384 reads 0.224, while its absolute error (0.0078)
# passes FLASH_TOL (H100, PERF.md).
FLASH_ROW_TOL_BF16 = 6e-2
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


def phase_device(names=None):
    """The card, and the build of the libraries ``names`` (every one by
    default)."""
    from repro_torch.kernels import build

    smi = nvidia_smi()
    line("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    report = build.build_all(names)
    wall = time.perf_counter() - t0
    for name, rec in report.items():
        regs = [ln.strip() for ln in rec["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        line("build", kernel=name, seconds=rec["seconds"], ptxas=regs)
    line("build", wall_seconds=wall)
    return smi


#: where a sum of P(h|D)'s terms started at k = 0 or at A - 1 underflows
UNDERFLOW_GEOMS = ((63, 64), (64, 1 << 26), (16, 1 << 26), (1, 512),
                   (8, 16))


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
    # where a sum started at k = 0 ((1 - p)^D < 1e-308) or at A - 1 (p^(A-1)
    # < 1e-308) would underflow
    low = torch.from_numpy(np.concatenate([
        np.arange(60, 400), [710, 720, 1000, 5000, 45_000, 1 << 20, 1 << 26],
        rng.integers(0, 1 << 26, 1 << 16)]).astype(np.float32)).cuda()
    for assoc, blocks in UNDERFLOW_GEOMS:
        err = float((sdcm_hit_probs(low, assoc, blocks)
                     - sdcm_hit_probs_plain(low, assoc, blocks)).abs().max())
        if not np.isfinite(err) or err > PHIT_TOL:
            fail(f"sdcm_hit_probs on the underflow stream, assoc={assoc} "
                 f"blocks={blocks}: max |kernel - plain| = {err} > "
                 f"{PHIT_TOL}")
        rec = dict(input="underflow", assoc=assoc, blocks=blocks,
                   n=low.numel(), max_abs_err=err)
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
    from repro_torch.kernels import (flash_attention, moe, reuse_hist, sdcm,
                                     ssd_scan)

    return (sdcm.LAUNCHES, reuse_hist.LAUNCHES, flash_attention.LAUNCHES,
            flash_attention.LAUNCHES_BY_FORM,
            flash_attention.LAUNCHES_BY_BWD_FORM, ssd_scan.LAUNCHES,
            moe.LAUNCHES)


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


#: B4's and B5's counters as the f32 checks report them
ATTENTION_COUNTS = ("flash_attention", "tensor_core", "split_kv",
                    "tensor_core_f32", "split_kv_f32", "simt",
                    "flash_attention_bwd",
                    "tensor_core_bwd", "tensor_core_f32_bwd", "simt_bwd",
                    "ssd_scan", "ssd_scan_bwd")
#: B4's and B5's launches on the check paths, by path: the f32 checks
#: (``<arch>/f32_vs_plain``, ``<arch>/f32_consistency``,
#: ``zamba2-1.2b/train_f32``; the main path of B4's tensor-core f32 and
#: f32 split-KV forms) and the reduced configs' training steps
#: (``reduced/train``; B4's CUDA-core forms, forward and backward), which
#: ``main`` adds to B4's launches by path.
CHECK_PATHS: dict = {}
#: The forms an f32 check at D 64-128 never launches: its prefills run on
#: the tensor-core f32 form, its decode steps on the f32 split-KV form.
F32_CHECK_ABSENT = ("simt", "simt_bwd")


def check_path(path: str, launches: dict, needs: tuple,
               absent: tuple = ()) -> dict:
    """Keep a check path's B4/B5 launches under ``path``; fails unless
    each form in ``needs`` launched in it and none in ``absent`` did."""
    kept = {k: launches[k] for k in ATTENTION_COUNTS}
    for form in needs:
        if not kept[form]:
            fail(f"{path}: the {form} form never launched: {kept}")
    for form in absent:
        if kept[form]:
            fail(f"{path}: the {form} form launched {kept[form]} times: "
                 f"{kept}")
    CHECK_PATHS[path] = kept
    return kept


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
    """One ``(d, meta, size, geometries)`` per ``sdcm_hit_probs_ragged``
    launch that an ``inner="pallas"`` sweep of ``configs`` makes (one a
    ``sweep_grid`` call): its float32 distances and records on the card,
    and the (distances, assoc, blocks) of each record, which the
    one-geometry form takes one launch each."""
    from repro_torch.api.batched import hit_probs_plan

    calls = []
    groups: dict = {}
    for cfg in configs:
        groups.setdefault((cfg.line_size, cfg.cores, cfg.strategy),
                          []).append(cfg)
    for (line_size, cores, strategy), cfgs in groups.items():
        prd, crd = ev._pack(line_size, cores, strategy)
        plan = hit_probs_plan(prd, crd, ev._geometry(cfgs, line_size, cores),
                              ev.shared_idx)
        d = torch.cat([prd.d[:prd.n], crd.d[:crd.n]]).to(torch.float32)
        geoms = [(d[int(off):int(off) + int(n)], int(a), int(b))
                 for off, n, a, b, _, _ in plan.meta.tolist()]
        calls.append((d, torch.from_numpy(plan.meta).cuda(), plan.size,
                      geoms))
    return calls


def phase_sweep() -> dict:
    """``FusedSweepEvaluator`` (``sweep_grid``) on the main workload over
    the 10,240-config space: seconds, configs/s, one ragged SDCM launch
    per ``sweep_grid`` call; a sample of configs bit for bit against
    ``batched_hit_rates`` on the applied targets; every ``t_pred_s``
    within ``ECM_RTOL`` of the host ECM model; ``inner="pallas"`` (B1's
    per-reference form, one ragged launch per ``sweep_grid`` call) on the
    1,024-config space within ``RATE_TOL`` of ``inner="vmap"``, its
    launches counted; the warm per-config ``Session.predict`` loop on
    that space, timed beside the sweep.  Returns the kernels-line record
    of B1's per-reference form (``sdcm_hit_probs``)."""
    from repro_torch.api import PredictionRequest, Session
    from repro_torch.api.batched import batched_hit_rates
    from repro_torch.core.incore import ECMRuntimeModel
    from repro_torch.explore import FusedSweepEvaluator, SearchSpace
    from repro_torch.kernels.sdcm import (
        sdcm_hit_probs,
        sdcm_hit_probs_ragged,
        sdcm_hit_probs_ragged_plain,
    )

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
    small_groups = {(c.line_size, c.cores, c.strategy) for c in cfgs}
    if (launches["sdcm_hit_probs_ragged"] != len(small_groups)
            or sum(launches.values()) != len(small_groups)
            or len(calls) != len(small_groups)):
        fail(f"pallas sweep: {launches}, expected one sdcm_hit_probs_ragged "
             f"launch for each of {len(small_groups)} sweep_grid calls and "
             "nothing else")
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
         sdcm_hit_probs_ragged_launches=launches["sdcm_hit_probs_ragged"],
         sweep_grid_calls=len(small_groups),
         pallas_vs_vmap_max_abs=diff, loop_vs_sweep_max_rel=rel)

    # B1's per-reference form at the pallas sweep's own calls: each ragged
    # launch against its plain version, and element for element against
    # the one-geometry launches it replaces (one a record)
    err = 0.0
    for d, meta, size, geoms in calls:
        got = sdcm_hit_probs_ragged(d, meta, size)
        err = max(err, float((got - sdcm_hit_probs_ragged_plain(
            d, meta, size)).abs().max()))
        if not torch.equal(got, torch.cat([sdcm_hit_probs(g, a, b)
                                           for g, a, b in geoms])):
            fail("sdcm_hit_probs_ragged differs from the one-geometry "
                 "launches on the same records")
    if not err <= PHIT_TOL:
        fail(f"sdcm_hit_probs_ragged at the sweep's calls: {err} > "
             f"{PHIT_TOL}")

    def ragged(fn):
        return lambda: [fn(d, meta, size) for d, meta, size, _ in calls]

    def per_geometry():
        return [sdcm_hit_probs(g, a, b) for *_, geoms in calls
                for g, a, b in geoms]

    geoms = [g for *_, gs in calls for g in gs]
    n_elems = sum(int(g.numel()) for g, _, _ in geoms)
    terms = sum(phit_terms(g.cpu().numpy(), np.full(g.numel(), a),
                           np.full(g.numel(), b)) for g, a, b in geoms)
    b_ms, b_by = bound_ms(8.0 * n_elems, terms * OPS_PER_TERM)
    k = len(calls)
    rec = dict(ms=cuda_ms(ragged(sdcm_hit_probs_ragged)) / k,
               graph_ms=graph_ms(ragged(sdcm_hit_probs_ragged)) / k,
               plain_ms=cuda_ms(ragged(sdcm_hit_probs_ragged_plain), reps=3,
                                warmup=1) / k,
               bound_ms=b_ms / k, bound_by=b_by, max_abs_err=err,
               # the same records as one-geometry launches
               per_geometry_ms=cuda_ms(per_geometry) / k,
               per_geometry_graph_ms=graph_ms(per_geometry) / k)
    line("sweep_hit_probs", launches_per_sweep_call=1,
         records_per_call=len(geoms) / k,
         distances_per_record=n_elems / len(geoms), terms=terms, **rec)
    return {
        "name": "sdcm_hit_probs",
        "route": "cuda",
        "source": "src/repro_torch/kernels/sdcm/csrc/sdcm.cu",
        "replaces": "src/repro/kernels/sdcm/sdcm.py:32",
        "launches": launches["sdcm_hit_probs_ragged"],
        "launches_by_entry": {key: launches[key] for key in (
            "sdcm_hit_probs_ragged", "sdcm_hit_probs")},
        **{key: rec[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "graph_ms",
                                     "per_geometry_ms")},
        "library_ms": None,
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


# --- model-derived traces (model/<arch>/{prefill,decode}) ---------------------

MODEL_STORE = ROOT / "build" / "chip_smoke_model_store"  # made anew
MODEL_CELLS = 20            # 10 archs x prefill, decode
MODEL_VALIDATE = "model/llama3_8b/decode"


def model_requests(src) -> list:
    """A cell's grid: the Table-5 CPUs x cores x round_robin, and
    tpu-v5e at core 1, both with the cell's op counts."""
    from repro_torch.api import PredictionRequest

    return [PredictionRequest(targets=TABLE5, core_counts=CORES,
                              strategies=("round_robin",),
                              counts=src.op_counts),
            PredictionRequest(targets=("tpu-v5e",), core_counts=(1,),
                              counts=src.op_counts)]


def same_rates(got, want, tag: str) -> float:
    """Every hit rate of two result lists within ``RATE_TOL``."""
    worst = 0.0
    for res, ref in zip(got, want):
        for a, b in zip(res, ref):
            for lvl, rate in b.hit_rates.items():
                diff = abs(a.hit_rates[lvl] - rate)
                worst = max(worst, diff)
                if not diff <= RATE_TOL:
                    fail(f"{tag} {a.target} cores={a.cores} {lvl}: card "
                         f"{a.hit_rates[lvl]} vs CPU port {rate}")
    return worst


def phase_model_traces(smi: str) -> dict:
    """Every ``model/<slug>/{prefill,decode}`` cell: resolved on a store
    under ``build/`` and its trace recorded on the host (seconds of the
    recording and of the trace build); predicted on the card over the
    Table-5 CPUs x cores {1, 2, 4, 8} x round_robin and tpu-v5e at core 1
    (one ``predict_many`` of the two requests a cell: one SDCM launch,
    cold and warm), within 1e-6 of the float64 oracle and of the CPU
    port's predict on the same trace; then all 20 cells in one
    ``predict_many`` (one launch), with B1 held against its plain version
    and timed at those rows.  Then the service warm on the reference's
    selftest payload and on a ``train`` cell (200, equal to
    ``Session.predict``); every cell resolved again from the warm store with
    no recording; and the validation harness on one decode cell (exact
    LRU on the card, B2's binned check), with B2 held against its plain
    version on every distance stream that check feeds it.  Returns B1's
    launches on the path (the 20 cells' predicts and the 20-cell batch),
    B2's launches in the harness run and B2's max |kernel - plain|."""
    import shutil

    from repro_torch.analysis import aten_trace
    from repro_torch.api import AnalyticalSDCM, Session
    from repro_torch.api.batched import grid_rows, pack_ragged
    from repro_torch.kernels.sdcm import (
        sdcm_rates_ragged,
        sdcm_rates_ragged_plain,
    )
    from repro_torch.validate.store import ArtifactStore
    from repro_torch.workloads import registry

    shutil.rmtree(MODEL_STORE, ignore_errors=True)
    store = ArtifactStore(MODEL_STORE)
    names = [n for n in registry.workload_names("model")
             if not n.endswith("/train")]
    if len(names) != MODEL_CELLS:
        fail(f"{len(names)} model prefill/decode cells, want {MODEL_CELLS}")
    card = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cuda", store=store)
    host = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cpu")
    sources, items = {}, []
    reset_counts()
    for name in names:
        src = registry.resolve(name, "smoke", store=store)
        trace, trace_s = timed(src.trace)
        reqs = model_requests(src)
        pairs = [(src, r) for r in reqs]
        before = read_counts()["launches"]["sdcm_rates_ragged"]
        res, cold_s = timed(lambda: card.predict_many(pairs))
        after = read_counts()["launches"]["sdcm_rates_ragged"]
        warm, warm_s = timed(lambda: card.predict_many(pairs))
        if (after - before != 1
                or read_counts()["launches"]["sdcm_rates_ragged"] != after + 1):
            fail(f"{name}: a predict made other than one SDCM launch")
        if [r.to_json() for r in warm] != [r.to_json() for r in res]:
            fail(f"{name}: warm predict differs from cold predict")
        oracle = max(check_against_oracle(card, src, r, out, name)
                     for r, out in zip(reqs, res))
        cpu = same_rates(res, host.predict_many(pairs), name)
        sources[name] = src
        items += pairs
        info = src.info
        line("model_traces", workload=name, card=smi,
             fingerprint=src.declared_fingerprint, refs=len(trace),
             blocks=info["num_blocks"], buffers=info["num_buffers"],
             touched_bytes=info["touched_bytes"],
             shared_refs=int(trace.shared_mask.sum()),
             record_s=src.timings["record_s"],
             trace_s=src.timings["trace_s"], resolve_and_trace_s=trace_s,
             cold_predict_s=cold_s, warm_predict_s=warm_s,
             cells=sum(len(r) for r in res), max_abs_err_vs_oracle=oracle,
             max_abs_diff_vs_cpu_port=cpu,
             op_counts=dict(vars(src.op_counts)),
             tpu_vmem_hit_rate=res[1].predictions[0].hit_rates["VMEM"])

    before = read_counts()["launches"]["sdcm_rates_ragged"]
    batch, batch_s = timed(lambda: card.predict_many(items))
    launches = read_counts()["launches"]
    if launches["sdcm_rates_ragged"] - before != 1 or launches["sdcm_rates"]:
        fail(f"20-cell predict_many: {launches}")
    if [r.to_json() for r in batch] != [
            r.to_json() for r in card.predict_many(items)]:
        fail("20-cell predict_many is not repeatable")
    path_launches = launches["sdcm_rates_ragged"]

    # B1 at this path's rows: every cell's grid in one ragged launch
    rows = grid_rows([item for src, req in items
                      for item in path_items(card, src, req)])
    args = pack_ragged(rows, device="cuda")
    err = float((sdcm_rates_ragged(*args) - sdcm_rates_ragged_plain(*args))
                .abs().max())
    if not err <= RATE_TOL:
        fail(f"B1 at the model cells' rows: {err} > {RATE_TOL}")
    d, _, meta = (x.cpu().numpy() for x in args)
    row_of = np.repeat(np.arange(len(rows)), meta[:, 1].astype(np.int64))
    terms = phit_terms(d, meta[row_of, 2], meta[row_of, 3])
    b_ms, b_by = bound_ms(8.0 * (2 * d.size + meta.size + len(rows)),
                          terms * OPS_PER_TERM + 2.0 * d.size)
    kernel = dict(
        ms=cuda_ms(lambda: sdcm_rates_ragged(*args), reps=200, warmup=10),
        graph_ms=graph_ms(lambda: sdcm_rates_ragged(*args)),
        plain_ms=cuda_ms(lambda: sdcm_rates_ragged_plain(*args), reps=20),
        bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    line("model_traces_batch", card=smi, cells=len(names),
         requests=len(items), rows=len(rows), entries=int(d.size),
         predict_many_s=batch_s, launches=path_launches,
         max_row_entries=int(meta[:, 1].max()),
         max_assoc=int(meta[:, 2].max()), max_blocks=int(meta[:, 3].max()),
         **kernel)

    model_service(smi)

    # every cell again from the warm store: no recording, no build
    recorded = []
    record = aten_trace.record_model_step
    aten_trace.record_model_step = lambda *a, **kw: recorded.append(a) or \
        record(*a, **kw)
    try:
        warm_sess = Session(cache_model=AnalyticalSDCM(backend="batched"),
                            device="cuda", store=store)
        again = [(registry.resolve(n, "smoke", store=store), r)
                 for n in names for r in model_requests(sources[n])[:1]]
        for src, _ in again:
            if src.info != sources[src.workload_name].info:
                fail(f"{src.workload_name}: info from the store differs")
        warm_res, warm_s = timed(lambda: warm_sess.predict_many(again))
    finally:
        aten_trace.record_model_step = record
    st = warm_sess.stats
    if recorded or st.trace_builds or st.profile_builds or st.rd_builds:
        fail(f"model cells from a warm store: {len(recorded)} recordings, "
             f"{vars(st)}")
    same_rates(warm_res, batch[::2], "warm store")
    line("model_traces_warm", card=smi, cells=len(again), seconds=warm_s,
         recordings=len(recorded), stats=dict(vars(st)))

    hist_launches = model_validate(smi)
    return {"sdcm_rates_ragged": path_launches,
            "reuse_hist_moments": hist_launches,
            "reuse_hist_moments_err": model_hist_checks(smi)}


def model_service(smi: str) -> None:
    """The reference's selftest payload through the port's server on the
    card, warm on the model store, and the same request on a ``train``
    cell: 200 and ``Session.predict``'s answer for each."""
    from repro_torch.api import AnalyticalSDCM, Session
    from repro_torch.service import PredictionService, ServiceConfig
    from repro_torch.service.client import ServiceClient
    from repro_torch.service.server import PredictionServer, build_request

    payloads = [{"workload": f"model/llama3_8b/{step}", "sizes": "smoke",
                 "targets": ["tpu-v5e"], "core_counts": [1]}
                for step in ("decode", "train")]
    svc = PredictionService(config=ServiceConfig(
        device="cuda", artifact_dir=str(MODEL_STORE)))
    with svc:
        server = PredictionServer(svc, "127.0.0.1", 0)
        wants = []
        for payload in payloads:
            w = server.resolver.get(payload["workload"], payload["sizes"])
            want = Session(cache_model=AnalyticalSDCM(backend="batched"),
                           device="cuda").predict(w,
                                                  build_request(payload, w))
            wants.append(json.loads(want.to_json())["predictions"])
        server.serve_background()
        try:
            client = ServiceClient(server.url, timeout=300)
            client.wait_ready()
            secs = []
            for payload, want in zip(payloads, wants):
                got, t = timed(lambda: client.predict(**payload))
                if got["predictions"] != want:
                    fail(f"service on {payload['workload']}: {got} vs "
                         f"{want}")
                secs.append(t)
            stats = client.stats()
        finally:
            server.shutdown()
            server.server_close()
    line("model_service", card=smi, workload=payloads[0]["workload"],
         status=200, seconds=secs[0], train_workload=payloads[1]["workload"],
         train_status=200, train_seconds=secs[1], session=stats["session"])


def model_validate(smi: str) -> int:
    """``run_validation`` on one decode cell over the Table-5 CPUs x
    cores {1, 2, 4}: exact LRU on the card, B2's binned check.  Returns
    B2's launches in that run."""
    from repro_torch.validate import MatrixSpec, run_validation

    spec = MatrixSpec(workloads=(MODEL_VALIDATE,), targets=TABLE5,
                      core_counts=(1, 2, 4), strategies=("round_robin",),
                      sizes="smoke")
    reset_counts()
    summary, secs = timed(lambda: run_validation(
        spec, artifact_dir=None, processes=1, device="cuda"))
    launches = read_counts()["launches"]
    recs = summary["records"]
    binned = max(v for r in recs for v in r["binned_abs_dev"].values())
    if len(recs) != len(TABLE5) * 3 or binned > BINNED_TOL:
        fail(f"validation on {MODEL_VALIDATE}: {len(recs)} cells, binned "
             f"deviation {binned}")
    if launches["reuse_hist_moments"] <= 0:
        fail(f"validation on {MODEL_VALIDATE}: the binned check launched "
             "no B2")
    line("model_validate", card=smi, workload=MODEL_VALIDATE,
         cells=len(recs), seconds=secs, launches=launches,
         max_binned_abs_dev=binned,
         hit_err_pct=float(np.mean([e["abs_err_pct"] for r in recs
                                    for e in r["levels"].values()])),
         runtime_err_pct=float(np.mean([r["runtime_rel_err_pct"]
                                        for r in recs])))
    return launches["reuse_hist_moments"]


def model_hist_checks(smi: str) -> float:
    """``reuse_hist_moments`` against its plain version on the card, on
    every distance stream the binned check of ``MODEL_VALIDATE`` feeds
    it: at each Table-5 line size and cores {1, 2, 4}, the first private
    trace's and the shared trace's reuse distances (unit weights, so
    counts and masses must be equal).  Returns the max |kernel - plain|."""
    from repro_torch.api import Session
    from repro_torch.core.reuse.distance import reuse_distances
    from repro_torch.hw.targets import resolve_target
    from repro_torch.kernels import reuse_hist as rh
    from repro_torch.workloads import registry

    w = registry.resolve(MODEL_VALIDATE, "smoke")
    sess = Session(device="cuda")
    err, sizes = 0.0, []
    for line_size in sorted({resolve_target(t).levels[0].line_size
                             for t in TABLE5}):
        for cores in (1, 2, 4):
            art = sess.artifacts(w, cores, strategy="round_robin",
                                 line_size=line_size, need_traces=True)
            streams = [art.privates[0]] + (
                [art.shared] if art.shared is not art.privates[0] else [])
            for trace in streams:
                d = reuse_distances(trace.addresses, line_size,
                                    device="cuda")
                got = rh.reuse_histogram_moments(d)
                want = rh.reuse_histogram_moments_plain(d)
                if not torch.equal(got, want):
                    fail(f"B2 on {MODEL_VALIDATE}'s distances (line "
                         f"{line_size}, cores={cores}, {d.numel()} refs) "
                         "differs from its plain version")
                err = max(err, float((got - want).abs().max()))
                sizes.append(d.numel())
    line("model_reuse_hist", card=smi, workload=MODEL_VALIDATE,
         streams=len(sizes), smallest=min(sizes), largest=max(sizes),
         max_abs_err=err)
    return err


# --- the model zoo: flash attention (B4), SSD scan (B5), serving --------------

SERVE_BATCH, SERVE_PROMPT = 4, 2048
ZAMBA_GEN, MAMBA_GEN, LLAMA_GEN = 32, 16, 32
ZAMBA_CACHE = SERVE_PROMPT + ZAMBA_GEN   # the serving KV cache's length
# mixtral-8x7b: a prompt past its 4,096-token window, at 16 of its 32
# layers (23,482,470,400 parameters, 47.0 GB in bf16; the whole model's
# 93 GB does not fit one 80 GB card)
MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_GEN = 2, 6144, 16
MIXTRAL_LAYERS, MIXTRAL_WINDOW = 16, 4096
# seamless-m4t-medium (12 + 12 layers, source as long as the prompt) and
# phi-3-vision-4.2b (1,024 patches ahead of the prompt): whole, batch 4
SEAMLESS_GEN, PHI3V_GEN = 32, 32
PHI3V_PATCHES, PHI3V_PROMPT = 1024, 1024   # 2,048 positions in prefill
PHI3V_CACHE = PHI3V_PATCHES + PHI3V_PROMPT + PHI3V_GEN


def cuda_rand(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    return rand


def flash_work(q, k, causal: bool, q_offset: int, kv_len: int,
               window=None):
    """(bytes, operations) of one attention call: q, o and the K/V rows
    that some row sees once each; 4·D operations per visible (row,
    column) pair (Q K^T and P V; the softmax's exps are not counted)."""
    b, h, sq, d = q.shape
    rows = np.arange(sq)
    hi = (np.minimum(kv_len, q_offset + rows + 1) if causal
          else np.full(sq, kv_len))
    lo = (np.maximum(0, q_offset + rows - window + 1) if window
          else np.zeros(sq, np.int64))
    vis = hi - lo
    extent = int(hi.max() - lo.min())
    nbytes = q.element_size() * d * (2 * b * h * sq + 2 * b * k.shape[1]
                                     * extent)
    return float(nbytes), 4.0 * d * float(vis.sum()) * b * h


def sdpa_library(q, k, v, causal: bool, q_offset: int, kv_len: int,
                 window=None):
    """The same attention by ``scaled_dot_product_attention`` (timed as a
    yardstick only; the port never calls it); a window goes in as a
    boolean band mask."""
    k, v = k[:, :, :kv_len], v[:, :, :kv_len]
    sq = q.shape[2]
    kw = dict(enable_gqa=q.shape[1] != k.shape[1])
    if window is not None:
        pos = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(kv_len, device=q.device)[None, :]
        mask = cols > pos - window
        kw["attn_mask"] = mask & (cols <= pos) if causal else mask
    elif causal and q_offset == 0 and sq == kv_len:
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
    cache of 2080) with one entry per form under ``forms`` (the first
    case of each form), and a ``window`` entry at mixtral's windowed
    prefill.  The f32 rows on the tensor-core f32 form also give
    ``bound_tc_ms``: their operations as 3xTF32 at the tensor cores'
    TF32 rate, beside ``bound_ms`` at the CUDA cores' f32 rate."""
    from repro_torch.kernels.flash_attention import (
        flash_attention,
        flash_attention_plain,
        kernel_form,
    )

    bf16, f32 = torch.bfloat16, torch.float32
    b, s, cache = SERVE_BATCH, SERVE_PROMPT, ZAMBA_CACHE
    mb, ms, w = MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_WINDOW
    pv = PHI3V_PATCHES + PHI3V_PROMPT   # phi-3-vision's prefill positions
    causal_cases = [  # tag, form, B, H, Hkv, Sq, Sk, D, dtype, q_offset,
        #              kv_len, window
        ("zamba2_prefill", "tensor_core", b, 32, 32, s, cache, 64, bf16, 0,
         s, None),
        ("zamba2_decode", "split_kv", b, 32, 32, 1, cache, 64, bf16, s - 1,
         s, None),
        # kv_len 2000, not a multiple of the 128-column split
        ("zamba2_decode_kv2000", "split_kv", b, 32, 32, 1, cache, 64, bf16,
         s - 49, s - 48, None),
        # llama3-8b's decode step and prefill (GQA 32 over 8, D 128)
        ("gqa_32_over_8_d128_decode", "split_kv", b, 32, 8, 1, cache, 128,
         bf16, s - 1, s, None),
        ("llama3_prefill", "tensor_core", b, 32, 8, s, cache, 128, bf16, 0,
         s, None),
        ("zamba2_prefill_f32", "tensor_core_f32", b, 32, 32, s, cache, 64,
         f32, 0, s, None),
        ("gqa_32_over_8_d128", "tensor_core", 2, 32, 8, s, s, 128, bf16, 0,
         s, None),
        ("ragged_1000", "tensor_core", 2, 32, 32, 1000, 1000, 64, bf16, 0,
         1000, None),
        # mixtral-8x7b's sliding window: its prefill, a decode step past
        # the window, and the f32 form with the band's edge mid-tile
        ("mixtral_prefill_window", "tensor_core", mb, 32, 8, ms, ms, 128,
         bf16, 0, ms, w),
        ("mixtral_decode_window", "split_kv", mb, 32, 8, 1, ms + 32, 128,
         bf16, ms + MIXTRAL_GEN, ms + MIXTRAL_GEN + 1, w),
        ("window_f32_mid_tile", "tensor_core_f32", 2, 32, 8, s, s, 128, f32,
         0, s, 1000),
        # phi-3-vision-4.2b's head dim 96: its prefill (patches and text)
        # and a decode step against its cache, and the f32 form
        ("phi3_prefill_d96", "tensor_core", b, 32, 32, pv, PHI3V_CACHE, 96,
         bf16, 0, pv, None),
        ("phi3_decode_d96", "split_kv", b, 32, 32, 1, PHI3V_CACHE, 96, bf16,
         pv - 1, pv, None),
        ("simt_f32_d96", "tensor_core_f32", 2, 32, 32, 1024, 1024, 96, f32,
         0, 1024, None),
        # f32 decode steps on the f32 split-KV form: zamba2's, at kv_len
        # 2000 (not a multiple of its
        # 64-column split), llama3's GQA at D 128, mixtral's past its
        # window, phi-3's at D 96
        ("zamba2_decode_f32", "split_kv_f32", b, 32, 32, 1, cache, 64, f32,
         s - 1, s, None),
        ("zamba2_decode_kv2000_f32", "split_kv_f32", b, 32, 32, 1, cache, 64,
         f32, s - 49, s - 48, None),
        ("llama3_decode_f32", "split_kv_f32", b, 32, 8, 1, cache, 128, f32,
         s - 1, s, None),
        ("mixtral_decode_window_f32", "split_kv_f32", mb, 32, 8, 1, ms + 32,
         128, f32, ms + MIXTRAL_GEN, ms + MIXTRAL_GEN + 1, w),
        ("phi3_decode_d96_f32", "split_kv_f32", b, 32, 32, 1, PHI3V_CACHE,
         96, f32, pv - 1, pv, None),
        # what stays on the CUDA-core form: f32 and bf16 at D <= 32 (the
        # prefill shape at D 16 and 32), and rows that are not 16-byte
        # aligned (zamba2's f32 decode step, q 4 bytes off)
        ("simt_f32_d16", "simt", b, 32, 32, s, cache, 16, f32, 0, s, None),
        ("simt_bf16_d32", "simt", b, 32, 32, s, cache, 32, bf16, 0, s,
         None),
        ("simt_f32_decode_unaligned", "simt", b, 32, 32, 1, cache, 64, f32,
         s - 1, s, None),
    ]
    # seamless-m4t-medium's calls without causality: its bidirectional
    # encoder, cross-attention in prefill (target rows over the source)
    # and at a decode step (one row over the whole source)
    bidirectional = [
        ("encoder_noncausal", "tensor_core", b, 16, 16, s, s, 64, bf16, 0, s,
         None),
        ("cross_prefill", "tensor_core", b, 16, 16, s, s, 64, bf16, 0, s,
         None),
        ("cross_decode", "split_kv", b, 16, 16, 1, s, 64, bf16, 0, s, None),
        ("cross_decode_f32", "split_kv_f32", b, 16, 16, 1, s, 64, f32, 0, s,
         None),
    ]
    cases = ([(True, *c) for c in causal_cases]
             + [(False, *c) for c in bidirectional])
    records, worst, forms, form_worst = {}, 0.0, {}, {}
    for i, (causal, tag, form, b, h, hkv, sq, sk, d, dt, off, kvl,
            win) in enumerate(cases):
        rand = cuda_rand(10 + i)
        q = rand(b, sq, h, d, dtype=dt).transpose(1, 2)
        if tag.endswith("_unaligned"):   # q starts 4 bytes off 16
            q = rand(b * sq * h * d + 1, dtype=dt)[1:].view(
                b, sq, h, d).transpose(1, 2)
        k = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        v = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        if kernel_form(q, k, v) != form:
            fail(f"flash_attention {tag}: runs on the {kernel_form(q, k, v)} "
                 f"form, expected {form}")
        kw = dict(causal=causal, q_offset=off, kv_len=kvl, window=win)
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
        form_worst[form] = max(form_worst.get(form, 0.0), err)
        if form in ("split_kv", "split_kv_f32") and not torch.equal(
                got, flash_attention(q, k, v, **kw)):
            fail(f"flash_attention {tag}: two launches differ")
        # SDPA faults on a q that starts off 16 bytes: its yardstick reads
        # a copy in a fresh (aligned) allocation
        q_lib = q.clone() if tag.endswith("_unaligned") else q
        lib = sdpa_library(q_lib, k, v, causal, off, kvl, win)
        lib_err = float((lib.float() - want.float()).abs().max())
        nbytes, ops = flash_work(q, k, causal, off, kvl, win)
        b_ms, b_by = bound_ms(nbytes, ops,
                              PEAK_BF16_S if dt == bf16 else PEAK_FP32_S)
        # f32 on the tensor cores: 3 TF32 products a multiply-add
        tc_ms = (bound_ms(nbytes, 3 * ops, PEAK_TF32_S)[0]
                 if form == "tensor_core_f32" else None)
        rec = dict(form=form, shape=[b, h, hkv, sq, sk, d], dtype=str(dt),
                   causal=causal, q_offset=off, kv_len=kvl, window=win,
                   max_abs_err=err,
                   tol=FLASH_TOL[dt], scaled_err=scaled,
                   ms=cuda_ms(lambda: flash_attention(q, k, v, **kw)),
                   graph_ms=graph_ms(lambda: flash_attention(q, k, v, **kw)),
                   plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v,
                                                                  **kw),
                                    reps=3, warmup=1),
                   library_ms=cuda_ms(lambda: sdpa_library(
                       q_lib, k, v, causal, off, kvl, win)),
                   library_graph_ms=graph_ms(lambda: sdpa_library(
                       q_lib, k, v, causal, off, kvl, win)),
                   library_max_abs_diff=lib_err, bound_ms=b_ms, bound_by=b_by,
                   bound_tc_ms=tc_ms, bytes=nbytes, operations=ops)
        line("flash", case=tag, **rec)
        records[tag] = rec
        forms.setdefault("window" if win else form, dict(case=tag, **{
            key: rec[key] for key in ("ms", "graph_ms", "plain_ms",
                                      "bound_ms", "bound_by", "bound_tc_ms",
                                      "library_ms", "library_graph_ms",
                                      "max_abs_err", "scaled_err")}))
        del q, k, v, q_lib, got, want, lib
        torch.cuda.empty_cache()
    for name, rec in forms.items():   # each form's worst over its cases
        if name != "window":
            rec["max_abs_err"] = form_worst[name]
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
                   kv_len=None, window=None):
    """B4's function by SDPA, for ``plain_kernels(flash="sdpa")``."""
    kv_len = k.shape[2] if kv_len is None else kv_len
    return sdpa_library(q, k, v, causal, q_offset, kv_len, window)


class plain_kernels:
    """Inside ``with plain_kernels():`` the models call B4's and B5's
    plain versions on the card instead of the kernels, and the MoE
    layers' grouped pipeline its plain version; ``flash``, ``scan`` and
    ``moe`` pick each one ("plain", "kernel", or for B4 "sdpa")."""

    def __init__(self, flash: str = "plain", scan: str = "plain",
                 moe: str = "plain"):
        self.flash, self.scan, self.moe = flash, scan, moe

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import moe
        from repro_torch.kernels import ssd_scan as scan

        self.saved = (fa.flash_attention, scan.ssd_scan, moe.experts)
        fa.flash_attention = {"plain": fa.flash_attention_plain,
                              "kernel": fa.flash_attention,
                              "sdpa": sdpa_attention}[self.flash]
        scan.ssd_scan = {"plain": scan.ssd_scan_plain,
                         "kernel": scan.ssd_scan}[self.scan]
        moe.experts = {"plain": moe.experts_plain,
                       "kernel": moe.experts}[self.moe]

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import moe
        from repro_torch.kernels import ssd_scan as scan

        fa.flash_attention, scan.ssd_scan, moe.experts = self.saved


def teacher_forced(spec, cfg, model, res) -> torch.Tensor:
    """Logits [gen, B, V] of the prefill of the served prompt (with its
    frames or patches) and of one decode step per generated token, fed
    the served ``tokens``, at the served decode lengths."""
    from repro_torch.launch import serve

    fam = spec.family
    prompt, tokens, sources = res["prompt"], res["tokens"], res["sources"]
    b, plen = prompt.shape
    caches = serve.new_caches(spec, cfg, b, plen + tokens.shape[1], sources,
                              device="cuda")
    logits, caches = fam.prefill(
        model, serve.prefill_batch(cfg, prompt, sources, "cuda"), cfg, caches)
    out = [logits.float()]
    start = serve.prefix_len(spec, cfg) + plen
    for t in range(tokens.shape[1] - 1):
        tok = torch.from_numpy(tokens[:, t:t + 1]).long().cuda()
        logits, caches = fam.decode_step(model, {"token": tok}, cfg, caches,
                                         start + t)
        out.append(logits.float())
    return torch.stack(out)[..., :spec.vocab]


class moe_routing:
    """Teacher forcing of the MoE layers' expert choice.  With ``record``
    (a list) each layer's top-k experts are appended in call order; with
    ``replay`` every layer routes each token to the experts recorded at
    the same call, weighted by its own router probabilities there
    (renormalised), and ``flips`` counts the (token, choice) pairs whose
    own top-k set differed.  A model without MoE layers never routes."""

    def __init__(self, record=None, replay=None):
        self.record, self.replay = record, replay
        self.calls = self.flips = self.choices = 0

    def __enter__(self):
        from repro_torch.models import moe

        self.saved = own = moe.route

        def route(params, xt, cfg):
            probs, gate, idx = own(params, xt, cfg)
            if self.record is not None:
                self.record.append(idx)
            if self.replay is not None:
                forced = self.replay[self.calls]
                self.calls += 1
                self.flips += int((idx.sort(-1).values
                                   != forced.sort(-1).values).sum())
                self.choices += forced.numel()
                gate = probs.gather(-1, forced)
                gate, idx = gate / gate.sum(-1, keepdim=True), forced
            return probs, gate, idx

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.route = self.saved


def kernel_vs_plain_logits(spec, cfg, model, res, tag: str,
                           f32: bool = True) -> dict:
    """Teacher-forced logits through the kernels and through the plain
    versions on the card: in the model's dtype, then (``f32``) with the
    same weights in f32, each kernel pass with its launches by form (the
    f32 one also kept in ``CHECK_PATHS``; its prefill on B4's tensor-core
    f32 form).  With MoE layers the expert choice is teacher
    forced too (``moe_routing``: the kernel path takes the plain path's
    choices), since a choice that flips on a rounding difference moves a
    token's whole MLP; the kernel path's own routing is reported beside
    it, ungated (``free_routing``: its distance and flipped choices).  In
    bf16 with attention, ``spread`` also gives the distance from the
    plain path with one kernel at a time (the MoE pipeline's with MoE
    layers), and with SDPA for B4 and every other version plain (a
    library's rounding: how far any other bf16 attention lands); the
    gate reads only the path with every kernel."""
    from repro_torch.launch import serve

    def forced(routes, **kw):
        with plain_kernels(**kw), moe_routing(replay=routes) as r:
            logits = teacher_forced(spec, cfg_dt, model, res)
        return logits, r

    out = {}
    own = serve.config_dtype(cfg)
    passes = [(own, SERVE_REL_TOL)]
    if f32:
        passes.append((torch.float32, SERVE_REL_TOL_F32))
    for dt, tol in passes:
        cfg_dt = serve.with_config(cfg, dtype=dt)
        if dt != own:  # a MoE router stays f32 in the model's dtype
            model = model.to(dt)
        routes = []
        with plain_kernels(), moe_routing(record=routes):
            want = teacher_forced(spec, cfg_dt, model, res)
        reset_counts()
        got, routing = forced(routes, flash="kernel", scan="kernel",
                              moe="kernel")
        launches = read_counts()["launches"]
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"{tag} {dt}: non-finite logits")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not diff / scale <= tol:
            fail(f"{tag} {dt}: kernel-path logits differ from the plain "
                 f"path's by {diff} (scale {scale}, > {tol} relative)")
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        rec = dict(steps=got.shape[0], max_abs_diff=diff, logit_scale=scale,
                   rel=diff / scale, tol=tol, argmax_agreement=agree,
                   launches={k: launches[k] for k in ATTENTION_COUNTS})
        if dt == torch.float32:
            # f32 prefill rows on the tensor-core f32 form, decode steps on
            # the f32 split-KV form (B4 where the model has attention)
            check_path(f"{spec.arch_id}/f32_vs_plain", launches,
                       () if spec.family_name == "ssm" else
                       ("tensor_core_f32", "split_kv_f32"), F32_CHECK_ABSENT)
        if routes:
            free = teacher_forced(spec, cfg_dt, model, res)
            rec["free_routing"] = dict(
                rel=float((free - want).abs().max()) / scale,
                argmax_agreement=float(
                    (free.argmax(-1) == want.argmax(-1)).float().mean()),
                flipped_choices=routing.flips, choices=routing.choices)
        if dt != torch.float32 and spec.family_name != "ssm":
            rec["spread"] = {}
            variants = [("sdpa_b4_plain_b5", dict(flash="sdpa"))]
            if spec.family_name == "hybrid":
                variants += [("b4_kernel_only", dict(flash="kernel")),
                             ("b5_kernel_only", dict(scan="kernel"))]
            if routes:
                variants.append(("moe_kernel_only", dict(moe="kernel")))
            for name, kw in variants:
                other, _ = forced(routes, **kw)
                rec["spread"][name] = float(
                    (other - want).abs().max()) / scale
        out[str(dt).replace("torch.", "")] = rec
    return out


def serve_path(arch: str, gen: int, want_launches: dict, *,
               batch: int = SERVE_BATCH, prompt_len: int = SERVE_PROMPT,
               layers: int | None = None):
    """Serve ``arch`` at full width (and depth unless ``layers`` cuts
    it) with counts set to 0 just before and read just after; fails
    unless each kernel of the path launched exactly as often as the path
    needs.  Returns the spec with the served config."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    spec = get_arch(arch)
    if layers is not None:
        spec = dataclasses.replace(spec, config=serve.with_config(
            spec.config, layers=layers))
    model = spec.family.init(spec.config, device="cuda", seed=0)
    reset_counts()
    res = serve.serve(arch, batch=batch, prompt_len=prompt_len, gen=gen,
                      seed=0, device="cuda", layers=layers, model=model)
    counts = read_counts()
    launches = counts["launches"]
    for name, n in want_launches.items():
        if launches[name] != n:
            fail(f"{arch} serve path launched {name} {launches[name]} "
                 f"times, expected {n}: {launches}")
    rec = dict(arch=arch, **serve.depth(spec.config), dtype=res["dtype"],
               batch=batch, prompt_len=prompt_len, gen=gen,
               prefix_len=serve.prefix_len(spec, spec.config),
               params=sum(t.numel() for t in model.parameters()),
               prefill_s=res["prefill_s"], decode_s=res["decode_s"],
               decode_ms_per_step=res["decode_ms_per_step"],
               decode_tok_s=res["decode_tok_s"],
               max_memory_allocated=counts["max_memory_allocated"],
               launches={k: launches[k] for k in want_launches},
               sample_tokens=res["tokens"][0, :8].tolist())
    return spec, model, res, rec


def _top(kernels, n: int = 8) -> list:
    """The ``n`` kernel names that take the most device time among the
    profiler's raw ``kernels``, with their ms and counts."""
    by_name: dict = {}
    for e in kernels:
        ms, k = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (ms + e.duration_ns() / 1e6, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [dict(kernel=k[:80], ms=ms, count=c) for k, (ms, c) in top]


def device_breakdown(fn, ranges: tuple = ()) -> dict:
    """Wall time of ``fn`` (ending in a synchronise), the device's busy
    time in it (the sum of every kernel's and copy's device time among a
    ``torch.profiler`` trace's raw events, not the device-side spans of
    its ranges, the program's layer spans among them; one stream, so no
    overlap) and the idle share, with the kernels that take the most
    device time.
    The raw events are read because ``key_averages()`` over a training
    step's ~250,000 events takes minutes.  The profiler adds host time to
    every launch, so the idle share is an upper bound.  With ``ranges``
    (a training step's ``record_function`` names: forward, backward,
    optimizer) the busy time is also split by range: a kernel belongs to
    the first or last range whose device-side span holds its start; the
    rest (launched by the autograd engine's own thread, outside any
    range) to the middle one; each of the two outer ranges lists its top
    kernels too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import _annotation

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in events if _annotation(e) and e.name() in ranges}
    kernels = [e for e in events if not _annotation(e)]
    busy_ms = sum(e.duration_ns() for e in kernels) / 1e6
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms, top=_top(kernels))
    if ranges:
        split, tops = {}, {}
        for name in (ranges[0], ranges[-1]):
            if name not in spans:
                fail(f"no device-side span of the range {name}")
            lo, hi = spans[name]
            inside = [e for e in kernels if lo <= e.start_ns() < hi]
            split[name] = sum(e.duration_ns() for e in inside) / 1e6
            tops[name] = _top(inside)
        split[ranges[1]] = busy_ms - split[ranges[0]] - split[ranges[-1]]
        out.update(ranges_ms=split, ranges_top=tops)
    return out


def profile_serve(spec, model, res, steps: int = 4) -> dict:
    """``device_breakdown`` of one prefill of the served prompt and of
    ``steps`` decode steps after it."""
    from repro_torch.launch import serve

    fam, cfg = spec.family, spec.config
    b, plen = res["prompt"].shape
    sources = res["sources"]
    caches = serve.new_caches(spec, cfg, b, plen + steps, sources,
                              device="cuda")
    batch = serve.prefill_batch(cfg, res["prompt"], sources, "cuda")
    start = serve.prefix_len(spec, cfg) + plen
    state = {}

    def prefill():
        state["out"] = fam.prefill(model, batch, cfg, caches)

    def decode():
        logits, c = state["out"]
        for t in range(steps):
            tok = logits.argmax(-1, keepdim=True)
            logits, c = fam.decode_step(model, {"token": tok}, cfg, c,
                                        start + t)

    return dict(prefill=device_breakdown(prefill),
                decode_steps=steps, decode=device_breakdown(decode))


def decode_consistency(spec, layers: int, total: int, split: int) -> dict:
    """At full width and ``layers`` depth in f32: prefill of the whole
    prompt against the prefix plus one decode step per remaining token,
    through the kernels (gated; launches by form, kept in
    ``CHECK_PATHS``) and through the plain versions (for comparison).  An
    encoder-decoder's two stacks are each cut to
    ``layers`` and its source is ``total`` frames; a VLM's patches come
    first, and its decode steps run at ``num_patches + t``."""
    from repro_torch.launch import serve

    cfg = serve.with_config(spec.config, layers=layers, dtype=torch.float32)
    fam = spec.family
    model = fam.init(cfg, device="cuda", seed=1)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, spec.vocab, (2, total))
    sources = serve.source_inputs(spec, cfg, rng, 2, total)
    start = serve.prefix_len(spec, cfg)

    def run():
        full, _ = fam.prefill(
            model, serve.prefill_batch(cfg, toks, sources, "cuda"), cfg,
            serve.new_caches(spec, cfg, 2, total, sources, device="cuda"))
        logits, caches = fam.prefill(
            model, serve.prefill_batch(cfg, toks[:, :split], sources, "cuda"),
            cfg, serve.new_caches(spec, cfg, 2, total, sources,
                                  device="cuda"))
        for t in range(split, total):
            tok = torch.from_numpy(toks[:, t:t + 1]).cuda()
            logits, caches = fam.decode_step(model, {"token": tok}, cfg,
                                             caches, start + t)
        got, want = logits[:, :spec.vocab], full[:, :spec.vocab]
        diff = (got - want).abs()
        scale = float(want.abs().max())
        return dict(max_abs_diff=float(diff.max()), logit_scale=scale,
                    rel=float(diff.max()) / scale,
                    elementwise_excess=float((diff - CONSISTENCY_TOL
                                              - CONSISTENCY_TOL
                                              * want.abs()).max()))

    reset_counts()
    kernels, kernel_s = timed(run)
    launches = read_counts()["launches"]
    with plain_kernels():
        plain, plain_s = timed(run)
    if not kernels["rel"] <= CONSISTENCY_TOL:
        fail(f"{spec.arch_id} f32 depth {layers}: prefix + decode differs "
             f"from the whole prefill: {kernels} (plain versions: {plain})")
    # both prefills on B4's tensor-core f32 form, the decode steps (at most
    # 16 rows a kv head) on its f32 split-KV form
    kept = check_path(f"{spec.arch_id}/f32_consistency", launches,
                      ("tensor_core_f32", "split_kv_f32"), F32_CHECK_ABSENT)
    return dict(**serve.depth(cfg), dtype="float32", prompt=total,
                split=split, prefix_len=start, tol=CONSISTENCY_TOL,
                kernels=kernels, plain=plain, kernel_s=kernel_s,
                plain_s=plain_s, launches=kept)


def phase_zamba2_serve() -> dict:
    """The zamba2-1.2b serve path; returns its B4 (in all and by form)
    and B5 launches.  The 6 prefill attentions run on B4's tensor-core
    form, the 6 of each of the 31 decode steps on its split-KV form."""
    spec, model, res, rec = serve_path(
        "zamba2-1.2b", ZAMBA_GEN,
        {"flash_attention": 6 * ZAMBA_GEN, "tensor_core": 6,
         "split_kv": 6 * (ZAMBA_GEN - 1), "tensor_core_f32": 0,
         "split_kv_f32": 0, "simt": 0,
         "ssd_scan": 38})
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
         "split_kv": 0, "tensor_core_f32": 0, "split_kv_f32": 0,
         "simt": 0})
    line("mamba2_serve", **rec)
    line("mamba2_profile", **profile_serve(spec, model, res))
    line("mamba2_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "mamba2 serve"))
    del model
    torch.cuda.empty_cache()



def phase_llama3_serve() -> dict:
    """The llama3-8b serve path at full width and depth; returns its B4
    launches.  32 prefill attentions on B4's tensor-core form, 32 a
    decode step on its split-KV form."""
    layers = 32
    spec, model, res, rec = serve_path(
        "llama3-8b", LLAMA_GEN,
        {"flash_attention": layers * LLAMA_GEN, "tensor_core": layers,
         "split_kv": layers * (LLAMA_GEN - 1), "tensor_core_f32": 0,
         "split_kv_f32": 0, "simt": 0, "ssd_scan": 0})
    line("llama3_serve", **rec)
    line("llama3_profile", **profile_serve(spec, model, res))
    line("llama3_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "llama3 serve"))
    del model
    torch.cuda.empty_cache()
    line("llama3_decode_consistency",
         **decode_consistency(spec, 8, 300, 290))
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_mixtral_serve() -> dict:
    """The mixtral-8x7b serve path at full width and 16 of 32 layers,
    prompt 6,144 past the 4,096-token window (every prefill row past
    4,096 and every decode step cut by it); returns its B4 launches.
    The f32 kernel-vs-plain pass would need 94 GB of weights; the f32
    check is the decode consistency at 2 layers, through the window.
    Each MoE layer of the prefill and of every decode step runs on the
    grouped pipeline: one dispatch, two grouped GEMMs and one combine.
    ``mixtral_decode_vs_loop`` times the decode steps with the MoE
    layers on the grouped pipeline and on the host loop that it
    replaced (``models/moe.py::_experts``), alternately."""
    layers = MIXTRAL_LAYERS
    spec, model, res, rec = serve_path(
        "mixtral-8x7b", MIXTRAL_GEN,
        {"flash_attention": layers * MIXTRAL_GEN, "tensor_core": layers,
         "split_kv": layers * (MIXTRAL_GEN - 1), "tensor_core_f32": 0,
         "split_kv_f32": 0, "simt": 0, "ssd_scan": 0,
         "moe_dispatch": layers * MIXTRAL_GEN,
         "moe_gemm": 2 * layers * MIXTRAL_GEN,
         "moe_combine": layers * MIXTRAL_GEN},
        batch=MIXTRAL_BATCH, prompt_len=MIXTRAL_PROMPT, layers=layers)
    if spec.config.window != MIXTRAL_WINDOW:
        fail(f"mixtral's window is {spec.config.window}")
    rec["reduced"] = {"layers": f"{layers} of 32: the whole model is 93 GB "
                                "in bf16, one card holds 80 GB"}
    line("mixtral_serve", **rec)
    line("mixtral_decode_vs_loop", **decode_vs_loop(
        "mixtral-8x7b", model, MIXTRAL_BATCH, MIXTRAL_PROMPT, MIXTRAL_GEN,
        layers))
    line("mixtral_profile", **profile_serve(spec, model, res))
    line("mixtral_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "mixtral serve", f32=False))
    del model
    torch.cuda.empty_cache()
    line("mixtral_decode_consistency",
         **decode_consistency(spec, 2, 4200, 4190))
    torch.cuda.empty_cache()
    return rec["launches"]


class loop_moe:
    """Inside ``with loop_moe():`` every MoE layer runs the host loop
    (``models/moe.py::_experts``), as before the grouped pipeline."""

    def __enter__(self):
        from repro_torch.models import moe

        self.saved = moe.grouped_path
        moe.grouped_path = lambda *a: False

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.grouped_path = self.saved


def decode_vs_loop(arch: str, model, batch: int, prompt_len: int, gen: int,
                   layers: int, rounds: int = 2) -> dict:
    """The serve path's decode steps (ms a step) with the MoE layers on
    the grouped pipeline and on the host loop, ``rounds`` times each,
    the loop first in each round; and the first tokens of each, which
    the two paths' roundings may part."""
    from repro_torch.launch import serve

    def run():
        return serve.serve(arch, batch=batch, prompt_len=prompt_len,
                           gen=gen, seed=0, device="cuda", layers=layers,
                           model=model)

    out = {"grouped_ms_per_step": [], "loop_ms_per_step": []}
    for _ in range(rounds):
        with loop_moe():
            loop = run()
        grouped = run()
        out["loop_ms_per_step"].append(loop["decode_ms_per_step"])
        out["grouped_ms_per_step"].append(grouped["decode_ms_per_step"])
    out["loop_prefill_s"], out["grouped_prefill_s"] = (
        loop["prefill_s"], grouped["prefill_s"])
    out["same_first_tokens"] = bool(
        (loop["tokens"][:, :4] == grouped["tokens"][:, :4]).all())
    return dict(arch=arch, batch=batch, prompt_len=prompt_len, gen=gen,
                layers=layers, **out)


#: The benchmark's mixtral cells' routing: tokens a layer (the long mix's
#: mean prompt, a chat batch of 4 at the mean length) and the weight of
#: expert 0 in the seeded draw of each token's two experts (the others
#: 1).  At the phase's seed that gives expert loads of 1.71 (long) and
#: 1.46 (chat), near the cells' traced 1.63 and 1.42.
MOE_CELLS = {"prefill-long": (4480, 2.0), "prefill-chat": (3520, 1.6)}
#: Decode steps' tokens a layer (the serve path's batch, and a batch of
#: 16, whose 32 pairs spread over the experts), uniform routing: the
#: pipeline against the host loop it replaced.
MOE_DECODE = (2, 16)
MOE_D, MOE_F, MOE_E = 4096, 14336, 8


def moe_library_loop(xs, h, bounds, wi, wg, wo):
    """The per-expert ``torch.matmul`` calls of the same three products
    (the library yardstick; the offsets read beforehand)."""
    for ex, (a, b) in enumerate(zip(bounds, bounds[1:])):
        if b > a:
            xs[a:b] @ wg[ex]
            xs[a:b] @ wi[ex]
            h[a:b] @ wo[ex]


def phase_moe(seed: int = 11) -> dict:
    """``[moe]``: the MoE layer's expert pipeline (``kernels/moe``) at
    mixtral's widths and the mixtral cells' routing, seeded: the two
    grouped GEMMs against their plain versions (bf16 rounding, the
    test suite's bound), the dispatch and the combine bit for bit, the
    whole pipeline against the host loop (``models/moe.py::_experts``,
    bf16).  Times
    (20 calls, eager and replayed): the two grouped GEMMs (``ms``,
    ``graph_ms``) beside their bound (6·d·f a pair at 989 TFLOP/s), the
    plain versions (``plain_ms``, f32 sums), the per-expert
    ``torch.matmul`` calls of the same products (``library_ms``,
    ``library_graph_ms``), the whole pipeline and the loop it replaces.
    ``[moe_decode]``: the whole pipeline against the loop at a decode
    step's tokens (:data:`MOE_DECODE`), beside the bound of reading the
    experts' weights that the step touches.  The record's launches are
    the main paths', which ``main`` fills in."""
    from repro_torch.kernels import moe as kmoe
    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        return (torch.randn(*shape, generator=g, device="cuda")
                / shape[-2] ** 0.5).bfloat16()

    wi, wg, wo = (draw(MOE_E, MOE_D, MOE_F), draw(MOE_E, MOE_D, MOE_F),
                  draw(MOE_E, MOE_F, MOE_D))
    cfg = moe.MoEConfig(num_experts=MOE_E, top_k=2)
    out = {}
    for cell, (tokens, hot) in MOE_CELLS.items():
        cpu = torch.Generator().manual_seed(seed + tokens)
        p = torch.ones(MOE_E)
        p[0] = hot
        idx = torch.multinomial(p.expand(tokens, MOE_E), 2,
                                generator=cpu).cuda()
        gate = torch.rand(tokens, 2, generator=cpu) + 0.1
        gate = (gate / gate.sum(-1, keepdim=True)).cuda()
        xt = torch.randn(tokens, MOE_D, generator=g,
                         device="cuda").bfloat16()
        offs, slot, xs = kmoe.dispatch(xt, idx, MOE_E)
        want = kmoe.dispatch_plain(xt, idx, MOE_E)
        if not all(torch.equal(a, b) for a, b in zip((offs, slot, xs), want)):
            fail(f"moe {cell}: the dispatch differs from its plain version")
        h = kmoe.grouped_swiglu(xs, offs, wg, wi)
        yp = kmoe.grouped_down(h, offs, wo)
        errs = {}
        for name, got, ref in (
                ("h", h, kmoe.grouped_swiglu_plain(xs, offs, wg, wi)),
                ("yp", yp, kmoe.grouped_down_plain(h, offs, wo))):
            excess = (got.float() - ref.float()).abs() - 2 ** -7 * \
                ref.float().abs() - 1e-4 * float(ref.float().abs().max())
            errs[name] = float((got.float() - ref.float()).abs().max())
            if float(excess.max()) > 0:
                fail(f"moe {cell}: grouped GEMM {name} differs from its "
                     f"plain version beyond bf16 rounding ({errs[name]})")
        y = kmoe.combine(yp, slot, gate, idx)
        if not torch.equal(y, kmoe.combine_plain(yp, slot, gate, idx)):
            fail(f"moe {cell}: the combine differs from its plain version")
        loop = moe._experts(xt, gate, idx, cfg, False, tokens, 0,
                            (wi, wg, wo)).bfloat16()
        rel = float((y.float() - loop.float()).abs().max()) / float(
            loop.float().abs().max())
        if not rel <= 2e-2:
            fail(f"moe {cell}: the pipeline is {rel} from the loop")
        bounds = offs.tolist()
        counts = np.diff(bounds)
        pairs = tokens * 2
        ops = kmoe.gemm_ops(pairs, MOE_D, MOE_F)
        reset_counts()
        gemms = lambda: kmoe.grouped_down(  # noqa: E731
            kmoe.grouped_swiglu(xs, offs, wg, wi), offs, wo)
        ms = cuda_ms(gemms)
        launches = read_counts()["launches"]["moe_gemm"]
        if launches != 2 * 22:
            fail(f"moe {cell}: {launches} GEMM launches for 22 calls")
        library = lambda: moe_library_loop(  # noqa: E731
            xs, h, bounds, wi, wg, wo)
        rec = dict(
            cell=cell, tokens=tokens, pairs=pairs, d=MOE_D, f=MOE_F,
            experts=MOE_E, counts=counts.tolist(),
            expert_load=float(counts.max() * MOE_E / pairs),
            ms=ms, graph_ms=graph_ms(gemms),
            bound_ms=ops / PEAK_BF16_S * 1e3, bound_by="operations",
            tflops=ops / ms / 1e9,
            plain_ms=cuda_ms(lambda: kmoe.grouped_down_plain(
                kmoe.grouped_swiglu_plain(xs, offs, wg, wi), offs, wo),
                reps=3, warmup=1),
            library_ms=cuda_ms(library),
            library_graph_ms=graph_ms(library),
            pipeline_ms=cuda_ms(lambda: kmoe.experts(xt, gate, idx, wi, wg,
                                                      wo)),
            pipeline_graph_ms=graph_ms(lambda: kmoe.experts(
                xt, gate, idx, wi, wg, wo)),
            loop_ms=cuda_ms(lambda: moe._experts(
                xt, gate, idx, cfg, False, tokens, 0, (wi, wg, wo)), reps=5),
            dispatch_ms=cuda_ms(lambda: kmoe.dispatch(xt, idx, MOE_E)),
            combine_ms=cuda_ms(lambda: kmoe.combine(yp, slot, gate, idx)),
            max_abs_err=errs, pipeline_vs_loop=rel)
        rec["bound_ratio"] = rec["ms"] / rec["bound_ms"]
        line("moe", **rec)
        out[cell] = rec
        del h, yp, xs, y, loop
        torch.cuda.empty_cache()
    decode = {}
    for tokens in MOE_DECODE:
        cpu = torch.Generator().manual_seed(seed + tokens)
        idx = torch.multinomial(torch.ones(tokens, MOE_E), 2,
                                generator=cpu).cuda()
        gate = torch.rand(tokens, 2, generator=cpu) + 0.1
        gate = (gate / gate.sum(-1, keepdim=True)).cuda()
        xt = torch.randn(tokens, MOE_D, generator=g,
                         device="cuda").bfloat16()
        y, _ = kmoe.experts(xt, gate, idx, wi, wg, wo)
        loop = moe._experts(xt, gate, idx, cfg, False, tokens, 0,
                            (wi, wg, wo)).bfloat16()
        rel = float((y.float() - loop.float()).abs().max()) / float(
            loop.float().abs().max())
        if not rel <= 2e-2:
            fail(f"moe decode {tokens}: the pipeline is {rel} from the loop")
        touched = int(idx.unique().numel())
        rec = dict(
            tokens=tokens, pairs=2 * tokens, experts_touched=touched,
            bound_ms=3 * touched * MOE_D * MOE_F * 2 / PEAK_BYTES_S * 1e3,
            bound_by="bytes",
            pipeline_ms=cuda_ms(lambda: kmoe.experts(xt, gate, idx, wi, wg,
                                                      wo)),
            pipeline_graph_ms=graph_ms(lambda: kmoe.experts(
                xt, gate, idx, wi, wg, wo)),
            loop_ms=cuda_ms(lambda: moe._experts(
                xt, gate, idx, cfg, False, tokens, 0, (wi, wg, wo))),
            pipeline_vs_loop=rel)
        line("moe_decode", **rec)
        decode[tokens] = rec
    long = out["prefill-long"]
    return {
        "name": "moe_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/moe/csrc/moe.cu",
        "replaces": "none (src/repro/models/moe.py::moe_apply's expert "
                    "products, left to XLA)",
        "max_abs_err": max(max(r["max_abs_err"].values())
                           for r in out.values()),
        "case": "prefill-long",
        **{k: long[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "graph_ms",
                                "library_graph_ms")},
        "cells": out,
        "decode": decode,
    }


def phase_seamless_serve() -> dict:
    """The seamless-m4t-medium serve path at full width and depth
    (12 + 12 layers, source frames as long as the prompt); returns its B4
    launches.  Prefill: 12 encoder, 12 decoder self and 12 cross
    attentions on the tensor-core form (24 of them not causal); each
    decode step: 12 self and 12 cross on the split-KV form."""
    layers = 12
    spec, model, res, rec = serve_path(
        "seamless-m4t-medium", SEAMLESS_GEN,
        {"flash_attention": 3 * layers + 2 * layers * (SEAMLESS_GEN - 1),
         "tensor_core": 3 * layers,
         "split_kv": 2 * layers * (SEAMLESS_GEN - 1), "tensor_core_f32": 0,
         "split_kv_f32": 0, "simt": 0, "ssd_scan": 0})
    line("seamless_serve", **rec)
    line("seamless_profile", **profile_serve(spec, model, res))
    line("seamless_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "seamless serve"))
    del model
    torch.cuda.empty_cache()
    line("seamless_decode_consistency",
         **decode_consistency(spec, 4, 300, 290))
    torch.cuda.empty_cache()
    return rec["launches"]


def phase_phi3v_serve() -> dict:
    """The phi-3-vision-4.2b serve path at full width and depth (32
    layers, head dim 96, 1,024 patches ahead of a 1,024-token prompt);
    returns its B4 launches: 32 prefill attentions on the tensor-core
    form, 32 a decode step on the split-KV form, every one at D 96."""
    layers = 32
    spec, model, res, rec = serve_path(
        "phi-3-vision-4.2b", PHI3V_GEN,
        {"flash_attention": layers * PHI3V_GEN, "tensor_core": layers,
         "split_kv": layers * (PHI3V_GEN - 1), "tensor_core_f32": 0,
         "split_kv_f32": 0, "simt": 0, "ssd_scan": 0},
        prompt_len=PHI3V_PROMPT)
    if spec.config.num_patches != PHI3V_PATCHES:
        fail(f"phi-3-vision has {spec.config.num_patches} patches")
    line("phi3v_serve", **rec)
    line("phi3v_profile", **profile_serve(spec, model, res))
    line("phi3v_serve_vs_plain", **kernel_vs_plain_logits(
        spec, spec.config, model, res, "phi3v serve"))
    del model
    torch.cuda.empty_cache()
    line("phi3v_decode_consistency",
         **decode_consistency(spec, 8, 300, 290))
    torch.cuda.empty_cache()
    return rec["launches"]


# --- training (ROADMAP A-11b): zamba2-1.2b at full width and depth ---------

TRAIN_ARCH = "zamba2-1.2b"
TRAIN_BATCH, TRAIN_SEQ = 4, 2048   # 8,192 tokens a step
TRAIN_STEPS = 4                    # timed, after one warm-up step
TRAIN_F32_LAYERS = 6               # one group: one shared-attention site
TRAIN_LOSS_TOL = 1e-2              # bf16 loss, kernel vs plain path
TRAIN_GRAD_TOL_F32 = 1e-4          # each gradient leaf / its largest |g|
TRAIN_CELLS = 10                   # model/<arch>/train


def train_launches(cfg, steps: int) -> dict:
    """What ``steps`` training steps of a hybrid launch: B4 once per
    shared-attention site (not remat'ed, as in the reference), B5 once
    per Mamba2 layer in the forward and once more in its remat
    recomputation; each backward kernel once per site and per layer;
    every B4 call, forward and backward, on the tensor-core form (bf16,
    D 64, 2,048 rows)."""
    sites = cfg.num_groups
    return {"flash_attention": steps * sites, "tensor_core": steps * sites,
            "split_kv": 0, "tensor_core_f32": 0, "split_kv_f32": 0,
            "simt": 0,
            "ssd_scan": steps * 2 * cfg.layers,
            "flash_attention_bwd": steps * sites,
            "tensor_core_bwd": steps * sites, "tensor_core_f32_bwd": 0,
            "simt_bwd": 0,
            "ssd_scan_bwd": steps * cfg.layers}


def loss_and_grads(spec, cfg, model, batch):
    """The family's loss of ``batch`` and its gradient for every
    parameter (``torch.autograd.grad``), as one train step takes them."""
    loss = spec.family.loss_fn(model, batch, cfg)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


def train_vs_plain(spec, smi: str) -> dict:
    """The same weights and batch through the kernels and through the
    plain versions on the card: at full depth in bf16 the loss (1e-2
    relative) and the gradient norm (``SERVE_REL_TOL``); at 6 layers in
    f32 the loss (``SERVE_REL_TOL_F32``) and every gradient leaf (1e-4 of
    its largest |g|), B4 forward and backward on its tensor-core f32
    forms (launches kept in ``CHECK_PATHS``).  A kernel output without
    autograd history would leave the gradients upstream of attention and
    the scan wrong."""
    import dataclasses

    from repro_torch.configs.base import Shape
    from repro_torch.launch import serve
    from repro_torch.train import global_norm
    from repro_torch.train.data import synthetic_batch
    from repro_torch.train.optimizer import leaf_tensors

    out = {}
    for tag, dt, layers in (("bf16_full_depth", torch.bfloat16, None),
                            ("f32_6_layers", torch.float32,
                             TRAIN_F32_LAYERS)):
        cfg = serve.with_config(spec.config, dtype=dt, layers=layers)
        sp = dataclasses.replace(spec, config=cfg)
        batch = {k: v.cuda() for k, v in synthetic_batch(
            sp.input_shapes(Shape("train", TRAIN_SEQ, TRAIN_BATCH, "train")),
            sp.vocab, seed=1, step=0).items()}
        model = sp.family.init(cfg, device="cuda", seed=2)
        model.requires_grad_(True)
        reset_counts()
        (loss_k, grads_k), kernel_s = timed(
            lambda: loss_and_grads(sp, cfg, model, batch))
        launches = read_counts()["launches"]
        with plain_kernels():
            (loss_p, grads_p), plain_s = timed(
                lambda: loss_and_grads(sp, cfg, model, batch))
        rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        norm_k, norm_p = float(global_norm(grads_k)), float(
            global_norm(grads_p))
        rec = dict(layers=serve.depth(cfg)["layers"], dtype=str(dt),
                   loss_kernel=float(loss_k), loss_plain=float(loss_p),
                   loss_rel=rel_loss, grad_norm_kernel=norm_k,
                   grad_norm_plain=norm_p,
                   grad_norm_rel=abs(norm_k - norm_p) / norm_p,
                   kernel_path_s=kernel_s, plain_path_s=plain_s,
                   launches={k: launches[k] for k in ATTENTION_COUNTS})
        if dt == torch.float32:
            # B4 forward and backward on the tensor-core f32 forms
            check_path(f"{TRAIN_ARCH}/train_f32", launches,
                       ("tensor_core_f32", "tensor_core_f32_bwd"),
                       F32_CHECK_ABSENT)
            leaves_k = leaf_tensors(model, grads_k)
            leaves_p = leaf_tensors(model, grads_p)
            worst, worst_leaf = 0.0, None
            for leaf, gp in leaves_p.items():
                scale = float(gp.abs().max())
                err = float((leaves_k[leaf] - gp).abs().max()) / scale
                if err > worst:
                    worst, worst_leaf = err, leaf
            rec.update(worst_leaf_rel=worst, worst_leaf=worst_leaf,
                       leaves=len(leaves_p), leaf_tol=TRAIN_GRAD_TOL_F32,
                       loss_tol=SERVE_REL_TOL_F32)
            if not (rel_loss <= SERVE_REL_TOL_F32
                    and worst <= TRAIN_GRAD_TOL_F32):
                fail(f"training f32 kernel vs plain: {rec}")
        else:
            rec.update(loss_tol=TRAIN_LOSS_TOL, grad_norm_tol=SERVE_REL_TOL)
            if not (rel_loss <= TRAIN_LOSS_TOL
                    and rec["grad_norm_rel"] <= SERVE_REL_TOL):
                fail(f"training bf16 kernel vs plain: {rec}")
        if not all(bool(torch.isfinite(g).all()) for g in grads_k):
            fail(f"training {tag}: a non-finite gradient")
        out[tag] = rec
        del model, grads_k, grads_p
        torch.cuda.empty_cache()
    line("train_vs_plain", card=smi, **out)
    return out


# backward kernels vs their plain versions: max |kernel - plain| over the
# plain gradient's largest |value|, per gradient.  f32: sums in other
# orders (B5 also its warp-scan cumsum), readings up to 1.9e-6 (B4) and
# 4.6e-6 (B5) in the first runs (H100, PERF.md); bf16 gradients: B4's
# tensor-core form rounds P and dS to bf16 as operands (readings up to
# 6.8e-3), and a bf16 output is one rounding of the f32 sum (one bf16
# step is at most 2^-7 = 7.8e-3 of a value; B5's readings up to 2.1e-3).
BWD_TOL = {"flash_attention_bwd": {torch.float32: 1e-5,
                                   torch.bfloat16: 2e-2},
           "ssd_scan_bwd": {torch.float32: 2e-5, torch.bfloat16: 1e-2}}
# ... and row by row (``bwd_row_err``): a gradient's rows differ in size
# (causal B4: a late kv row of dk, dv sees few q rows), and a term lost
# from small rows hides under the largest value.  Each row is held to its
# own rms.  Set from my chip readings (H100, PERF.md, PR 26): B4 bf16
# tensor-core up to 0.0352 (bf16 P and dS operands, the output's rounding:
# a few bf16 steps of a row's largest element), f32 1.07e-4 (the late kv
# rows of dk, few terms that cancel); B5 f32 5.7e-3 (dla's in-chunk suffix
# sums of ds terms that cancel), bf16 outputs 1.85e-2.  A dK/dV that drops
# the diagonal q row of the last KV tile's kv rows (a causal off-by-one)
# reads ~0.012 of the largest value and passes ``BWD_TOL``; its row error
# is ~4 and fails these.
BWD_ROW_TOL = {"flash_attention_bwd": {torch.float32: 5e-4,
                                       torch.bfloat16: 6e-2},
               "ssd_scan_bwd": {torch.float32: 2e-2, torch.bfloat16: 5e-2}}
# the forward's log-sum-exp (bf16 forms, under autograd) against the plain
# version's, absolute: both sum exactly the same bf16 products in f32, in
# other orders, and the kernel's exp2 is the SFU's (rows of ~8 here)
LSE_TOL = 1e-4
# a row's rms is floored at this share of the whole gradient's rms: a row
# that is zero up to rounding (dq of a row that sees one column) has no
# relative error to speak of
BWD_ROW_FLOOR = 1e-3


_BF16, _F32 = torch.bfloat16, torch.float32
# [kernel_backward]'s cases: the train shapes (zamba2-1.2b) in bf16 and
# f32, then each case class training reaches or the kernel takes
BWD_FLASH_CASES = [  # tag, dtype, B, H, Hkv, Sq, Sk, D, kwargs
    ("train", _BF16, TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64,
     dict(causal=True)),
    ("train_f32", _F32, TRAIN_BATCH, 32, 32, TRAIN_SEQ, TRAIN_SEQ, 64,
     dict(causal=True)),
    ("gqa_32_over_8_d128", _BF16, 2, 32, 8, 1024, 1024, 128,
     dict(causal=True)),
    ("window_1000", _BF16, 2, 32, 8, 2048, 2048, 128,
     dict(causal=True, window=1000)),
    ("window_f32_d16", _F32, 2, 4, 2, 1000, 1000, 16,
     dict(causal=True, window=100)),
    ("noncausal_sq_ne_sk", _BF16, 2, 16, 16, 1000, 2048, 64,
     dict(causal=False)),
    ("noncausal_f32", _F32, 2, 16, 16, 300, 1000, 64, dict(causal=False)),
    ("d96", _BF16, 2, 32, 32, 1024, 1024, 96, dict(causal=True)),
    ("d96_f32", _F32, 2, 8, 8, 500, 500, 96, dict(causal=True)),
    ("d16", _BF16, 4, 4, 4, 512, 512, 16, dict(causal=True)),
    ("d16_f32", _F32, 4, 4, 4, 512, 512, 16, dict(causal=True)),
    ("offsets", _BF16, 2, 32, 8, 300, 1000, 64,
     dict(causal=True, q_offset=600, kv_len=900)),
    ("offsets_f32", _F32, 2, 8, 8, 300, 1000, 8,
     dict(causal=True, q_offset=600, kv_len=900)),
    # the tensor-core f32 form's case classes beside train_f32,
    # noncausal_f32 and d96_f32 (GQA and a window at D 128, offsets), and
    # an f32 chunk of 16 rows a kv head at D 64, which keeps the CUDA-core
    # form both ways
    ("window_gqa_f32_d128", _F32, 2, 32, 8, 2048, 2048, 128,
     dict(causal=True, window=1000)),
    ("offsets_f32_d64", _F32, 2, 8, 2, 300, 1000, 64,
     dict(causal=True, q_offset=600, kv_len=900)),
    ("few_rows_f32_d64", _F32, 2, 8, 2, 4, 300, 64,
     dict(causal=True, q_offset=290, kv_len=294)),
    # f32 with q and k scaled so that the largest |scale q k^T| is 20
    # (BWD_FLASH_SHARP)
    ("sharp_f32_d64", _F32, 2, 8, 8, 1024, 1024, 64, dict(causal=True)),
    ("sharp_gqa_f32_d128", _F32, 2, 16, 4, 1024, 1024, 128,
     dict(causal=True)),
]
# the cases whose softmax is sharp: |scale q k^T| up to this.  A row that
# sees one column far above the rest has a dq that is a difference of
# nearly equal terms, and the plain version in f32 is itself ~1e-3 of the
# row floor from its f64 evaluation there (the tensor-core f32 form ~1e-4):
# these cases are held to the plain versions in f64, at the same
# tolerances, and report their distance from the plain version in f32
# beside it (ungated).
BWD_FLASH_SHARP = {"sharp_f32_d64": 20.0, "sharp_gqa_f32_d128": 20.0}
# the cases timed, one a backward form, and each case's form where the
# form is the point
BWD_FLASH_TIMED = ("train", "train_f32", "d16_f32")
BWD_FLASH_FORMS = {"train": "tensor_core", "train_f32": "tensor_core_f32",
                   "noncausal_f32": "tensor_core_f32",
                   "d96_f32": "tensor_core_f32", "d16_f32": "simt",
                   "window_f32_d16": "simt", "offsets_f32": "simt",
                   "window_gqa_f32_d128": "tensor_core_f32",
                   "offsets_f32_d64": "tensor_core_f32",
                   "few_rows_f32_d64": "simt",
                   "sharp_f32_d64": "tensor_core_f32",
                   "sharp_gqa_f32_d128": "tensor_core_f32"}
# (la = -softplus(randn) takes e^-45 off a chunk of 64 steps, so what one
# chunk carries to the next barely counts; "slow_decay" scales la by 0.01,
# a chunk's decay ~0.6, so that the state and dH carried across chunks do)
BWD_SSD_CASES = [  # tag, B, S, H, P, N, x dtype, b/c dtype, h0, final
    ("train", TRAIN_BATCH, TRAIN_SEQ, 64, 64, 64, _F32, _BF16, False,
     False),
    ("train_f32", TRAIN_BATCH, TRAIN_SEQ, 64, 64, 64, _F32, _F32, False,
     False),
    ("n128_h0_final", 2, 2048, 48, 64, 128, _F32, _F32, True, True),
    ("ragged_2039_h0", 2, 2039, 64, 64, 64, _F32, _F32, True, False),
    ("ragged_final_bf16_bc", 2, 1000, 16, 64, 64, _F32, _BF16, False,
     True),
    ("bf16_x_bc", 2, 2048, 16, 64, 128, _BF16, _BF16, True, True),
    ("n100_p80", 1, 300, 4, 80, 100, _F32, _F32, True, True),
    ("slow_decay", 2, 1000, 16, 64, 64, _F32, _BF16, True, True),
]


def flash_bwd_bytes(q, k) -> float:
    """Bytes B4's backward must move: q, k, v, the output and its
    gradient read once, dq, dk, dv written once."""
    nb = q.numel() * q.element_size()
    return float(4 * nb + 4 * k.numel() * k.element_size())


def scan_bwd_bytes(x, la, bb, cc, gy) -> float:
    """Bytes B5's backward must move: x, la, b, c and dy read once, their
    gradients written once."""
    return float(sum(2 * t.numel() * t.element_size() for t in (x, la, bb, cc))
                 + gy.numel() * gy.element_size())


def sdpa_backward_ms(q, k, v, go) -> tuple[float, float]:
    """(eager, replayed) ms of SDPA's forward + backward minus its forward
    at these inputs (causal, the library's own kernels: a yardstick of
    B4's backward; the port never calls it)."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    kw = dict(is_causal=True, enable_gqa=q.shape[1] != k.shape[1])

    def fwd():
        with torch.no_grad():
            torch.nn.functional.scaled_dot_product_attention(*leaves, **kw)

    def both():
        torch.autograd.grad(torch.nn.functional.scaled_dot_product_attention(
            *leaves, **kw), leaves, go)

    return (cuda_ms(both) - cuda_ms(fwd), graph_ms(both) - graph_ms(fwd))


def kernel_short_name(name: str) -> str:
    """A profiler kernel name without its return type, template and
    function arguments: ``ns::kernel``."""
    name = name.split("(")[0].split("<")[0]
    return name.split(" ")[-1]


#: traces ``launch_split`` takes before it fails when none holds a device
#: event (one of a whole run's traces once held none; the cause is not
#: known)
SPLIT_TRACES = 3
#: the traces ``launch_split`` took again, by kernel set (printed by
#: ``[kernel_backward]``)
SPLIT_RETRIES: dict = {}


def launch_split(fn, calls: int = 10) -> dict:
    """Device ms a launch of each kernel that ``fn`` launches once a call,
    by ``kernel_short_name``: the mean over the launches that
    ``torch.profiler``'s raw events hold for ``calls`` calls after a
    warm-up.  The mean, not the sum over ``calls``: late in a long run
    the trace has been seen to keep only some of the launches, and once
    none, so a trace without device events is taken again (counted in
    ``SPLIT_RETRIES``), up to ``SPLIT_TRACES`` traces, before the run
    fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(SPLIT_TRACES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total: dict = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                name = kernel_short_name(e.name())
                ms, n = total.get(name, (0.0, 0))
                total[name] = (ms + e.duration_ns() / 1e6, n + 1)
        if total:
            if attempt:
                key = ",".join(sorted(total))
                SPLIT_RETRIES[key] = SPLIT_RETRIES.get(key, 0) + attempt
            return {name: ms / n for name, (ms, n) in total.items()}
    fail("the profiler saw no device time")


def bwd_row_err(got: torch.Tensor, plain: torch.Tensor) -> tuple[float,
                                                                   list]:
    """Over the rows (the last dimension) of a gradient, the largest
    max |got - plain| in a row over that row's rms of ``plain`` (floored
    at ``BWD_ROW_FLOOR`` of the whole gradient's rms), and that row's
    index."""
    g, p = got.float(), plain.float()
    rms = p.pow(2).mean(-1).sqrt()
    floor = max(BWD_ROW_FLOOR * float(p.pow(2).mean().sqrt()),
                torch.finfo(torch.float32).tiny)
    rel = (g - p).abs().amax(-1) / rms.clamp_min(floor)
    worst = int(rel.argmax())
    return float(rel.max()), [int(i) for i in np.unravel_index(
        worst, tuple(rel.shape))]


def bwd_errors(name: str, got, wants, tag: str) -> dict:
    """Against every plain version: the worst of each gradient's max
    |kernel - plain| over its largest |plain| (``scaled_err``), the worst
    max |kernel - plain| (``max_abs_err``) and the worst row error
    (``row_err``, ``bwd_row_err``: at gradient ``row_err_at[0]``, row
    ``row_err_at[1]``); fails past ``BWD_TOL`` or ``BWD_ROW_TOL``."""
    out = dict(scaled_err=0.0, max_abs_err=0.0, row_err=0.0, row_err_at=None)
    for want in wants:
        for i, (a, w) in enumerate(zip(got, want)):
            if a.dtype != w.dtype or a.shape != w.shape:
                fail(f"{name} {tag}: a gradient of {a.dtype} {a.shape}, "
                     f"the plain version's {w.dtype} {w.shape}")
            diff = float((a.float() - w.float()).abs().max())
            err = diff / float(w.float().abs().max())
            row, at = bwd_row_err(a, w)
            tol, row_tol = BWD_TOL[name][a.dtype], BWD_ROW_TOL[name][a.dtype]
            if not (err <= tol and row <= row_tol):
                fail(f"{name} {tag}, gradient {i}: |kernel - plain| / max "
                     f"|plain| = {err} (bound {tol}); row {at}: |kernel - "
                     f"plain| / the row's rms = {row} (bound {row_tol})")
            out["scaled_err"] = max(out["scaled_err"], err)
            out["max_abs_err"] = max(out["max_abs_err"], diff)
            if row >= out["row_err"]:
                out.update(row_err=row, row_err_at=[i, at])
    return out


def same_bits(fn, first) -> bool:
    """Whether a second launch gives ``first``'s bits."""
    return all(torch.equal(a, b) for a, b in zip(first, fn())
               if a is not None)


def phase_kernel_backward(smi: str) -> list:
    """The two backward kernels against their plain versions on the
    card, on the same inputs: B4's against ``flash_attention_bwd`` (the
    closed form in torch ops) and autograd through
    ``flash_attention_plain``, B5's against ``ssd_scan_bwd_plain`` (its
    algorithm in torch ops) and autograd through ``ssd_scan_plain``
    (``BWD_TOL``, and row by row ``BWD_ROW_TOL``); each case launched
    twice, the bits equal.  The train
    shapes (zamba2-1.2b: B 4, 32 heads, 2,048 tokens, D 64; 64 SSM heads
    of 64 over a state of 64) in bf16 and f32, and a case list: for B4
    GQA, a window, not causal with Sq != Sk, D 96, D 16, ``q_offset`` /
    ``kv_len``; for B5 N 128, ragged S, ``h0``, a final-state gradient,
    bf16 x, b and c.  B4's tensor-core forms read the forward's
    log-sum-exp and output (``_forward(..., for_grad=True)``, outside the
    timed calls), whose log-sum-exp is held to the plain version's
    (``LSE_TOL``); each case in ``BWD_FLASH_FORMS`` must run on its form.
    Timed at the train shapes in bf16 (the training path's inputs), B4
    also at ``BWD_FLASH_TIMED``'s f32 cases, one a backward form (under
    its record's ``forms``): ``ms`` eager, ``graph_ms`` replayed,
    ``split_ms`` the device ms of each launch (``launch_split``), the
    plain versions, SDPA's backward for B4, and for B5 and B4 in f32
    ``bound_tc_ms`` beside ``bound_ms``: the operations as 3xTF32 at the
    tensor cores' TF32 rate.  Returns their kernel records."""
    # the modules (their packages export functions of the same names)
    fam = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    scm = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")

    flash_rec, worst, forms, form_worst = None, 0.0, {}, {}
    for i, (tag, dt, b, h, hkv, sq, sk, d, kw) in enumerate(
            BWD_FLASH_CASES):
        rand = cuda_rand(60 + i)
        q = rand(b, sq, h, d, dtype=dt).transpose(1, 2)
        k = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        v = rand(b, sk, hkv, d, dtype=dt).transpose(1, 2)
        go = rand(b, h, sq, d, dtype=dt)
        if tag in BWD_FLASH_SHARP:
            c = (BWD_FLASH_SHARP[tag] / d ** -0.5 / float(
                (q @ k.repeat_interleave(h // hkv, dim=1).transpose(-1, -2))
                .abs().max())) ** 0.5
            q, k = q * c, k * c
        if tag in BWD_FLASH_FORMS and \
                fam.backward_form(q, k, v) != BWD_FLASH_FORMS[tag]:
            fail(f"flash_attention_bwd {tag}: runs on the "
                 f"{fam.backward_form(q, k, v)} form, expected "
                 f"{BWD_FLASH_FORMS[tag]}")
        full = dict(causal=kw["causal"], scale=None,
                    q_offset=kw.get("q_offset", 0), kv_len=kw.get("kv_len"),
                    window=kw.get("window"))
        form = fam.backward_form(q, k, v)
        out = lse = out_lo = None
        lse_err = None
        if fam.keeps_lse(q, k, v):
            # the forward under autograd: its output, log-sum-exp and
            # rounding residual, which the tensor-core backward reads
            out, lse, out_lo = fam._forward(
                q, k, v, kw["causal"], None, full["q_offset"],
                full["kv_len"], full["window"], for_grad=True)
            lse_err = float((lse - fam.flash_attention_plain(
                q, k, v, **kw, return_lse=True)[1]).abs().max())
            if not lse_err <= LSE_TOL:
                fail(f"flash_attention {tag}: the forward's log-sum-exp is "
                     f"{lse_err} from the plain version's (bound {LSE_TOL})")

        def kernel():
            return fam._backward(q, k, v, go, **full, out=out, lse=lse,
                                 out_lo=out_lo)

        got = kernel()
        torch.cuda.synchronize()
        sharp = tag in BWD_FLASH_SHARP
        # the plain versions, in f64 where the softmax is sharp
        ins = [t.double() if sharp else t for t in (q, k, v, go)]
        leaves = [t.detach().requires_grad_() for t in ins[:3]]
        auto = torch.autograd.grad(fam.flash_attention_plain(*leaves, **kw),
                                   leaves, ins[3])
        wants = [[w.to(dt) for w in want] for want in (
            fam.flash_attention_bwd(*ins, **kw), auto)]
        errs = bwd_errors("flash_attention_bwd", got, wants, tag)
        if sharp:
            plain32 = fam.flash_attention_bwd(q, k, v, go, **kw)
            errs.update(
                s_max=BWD_FLASH_SHARP[tag], oracle="plain_f64",
                row_err_vs_plain_f32=max(bwd_row_err(a, w)[0]
                                         for a, w in zip(got, plain32)),
                plain_f32_row_err=max(bwd_row_err(a, w)[0]
                                      for a, w in zip(plain32, wants[0])))
            del plain32
        del auto, leaves, ins, wants
        rec = dict(case=tag, form=form, dtype=str(dt),
                   shape=[b, h, hkv, sq, sk, d], **kw, **errs,
                   lse_err=lse_err,
                   tol=BWD_TOL["flash_attention_bwd"][dt],
                   row_tol=BWD_ROW_TOL["flash_attention_bwd"][dt],
                   deterministic=same_bits(kernel, got))
        if not rec["deterministic"]:
            fail(f"flash_attention_bwd {tag}: two launches differ")
        if tag in BWD_FLASH_TIMED:
            # the least time at the inputs' type: bf16 on the tensor cores,
            # f32 on the CUDA cores; and f32 as 3xTF32 on the tensor cores
            ops = fam.attention_bwd_ops(
                b, h, sq, d, causal=kw["causal"], q_offset=full["q_offset"],
                kv_len=full["kv_len"] or sk, window=full["window"])
            b_ms, b_by = bound_ms(flash_bwd_bytes(q, k), ops,
                                  PEAK_BF16_S if dt == _BF16 else PEAK_FP32_S)
            lib_ms, lib_graph_ms = sdpa_backward_ms(q, k, v, go)
            rec.update(ms=cuda_ms(kernel), graph_ms=graph_ms(kernel),
                       split_ms=launch_split(kernel),
                       plain_ms=cuda_ms(lambda: fam.flash_attention_bwd(
                           q, k, v, go, **kw), reps=3, warmup=1),
                       bound_ms=b_ms, bound_by=b_by,
                       bound_tc_ms=(bound_ms(flash_bwd_bytes(q, k), 3 * ops,
                                             PEAK_TF32_S)[0]
                                    if dt == _F32 else None),
                       library_ms=lib_ms, library_graph_ms=lib_graph_ms)
            forms[f"{form}_bwd"] = dict(case=tag, **{
                key: rec[key] for key in (
                    "ms", "graph_ms", "split_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_tc_ms", "library_ms",
                    "library_graph_ms", "max_abs_err", "scaled_err",
                    "row_err")})
            if tag == "train":
                flash_rec = rec
        worst = max(worst, errs["max_abs_err"])
        form_worst[form] = max(form_worst.get(form, 0.0), errs["max_abs_err"])
        line("kernel_backward", kernel="flash_attention_bwd", card=smi,
             **rec)
        del q, k, v, go, got, out, lse, out_lo
        torch.cuda.empty_cache()

    ssd_rec, ssd_worst = None, 0.0
    for i, (tag, b, s, h, p, n, x_dt, bc_dt, with_h0,
            with_final) in enumerate(BWD_SSD_CASES):
        rand = cuda_rand(80 + i)
        x = rand(b, s, h, p, dtype=x_dt)
        la = -torch.nn.functional.softplus(rand(b, s, h))
        if tag == "slow_decay":
            la = la * 0.01
        bb = (rand(b, s, n) * 0.3).to(bc_dt)
        cc = (rand(b, s, n) * 0.3).to(bc_dt)
        h0 = rand(b, h, n, p) if with_h0 else None
        gy = rand(b, s, h, p, dtype=x_dt)
        gf = rand(b, h, n, p) if with_final else None

        def kernel():
            return scm._backward(x, la, bb, cc, h0, gy, gf)

        got = kernel()
        torch.cuda.synchronize()
        inputs = [t for t in (x, la, bb, cc, h0) if t is not None]
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = scm.ssd_scan_plain(*leaves[:4],
                                  leaves[4] if with_h0 else None)
        auto = torch.autograd.grad(outs[:2 if with_final else 1], leaves,
                                   (gy, gf)[:2 if with_final else 1])
        plain = scm.ssd_scan_bwd_plain(x, la, bb, cc, h0, gy, gf)
        kept = [t for t in got if t is not None]
        errs = bwd_errors("ssd_scan_bwd", kept, (
            [t for t in plain if t is not None], auto), tag)
        del auto, leaves, outs, plain
        rec = dict(case=tag, shape=[b, s, h, p, n], x_dtype=str(x_dt),
                   bc_dtype=str(bc_dt), h0=with_h0, grad_final=with_final,
                   **errs, deterministic=same_bits(kernel, got))
        if not rec["deterministic"]:
            fail(f"ssd_scan_bwd {tag}: two launches differ")
        if tag == "train":
            b_ms, b_by = bound_ms(scan_bwd_bytes(x, la, bb, cc, gy),
                                  scm.scan_bwd_ops(b, s, h, p, n),
                                  PEAK_FP32_S)
            rec.update(ms=cuda_ms(kernel), graph_ms=graph_ms(kernel),
                       split_ms=launch_split(kernel),
                       plain_ms=cuda_ms(lambda: scm.ssd_scan_bwd_plain(
                           x, la, bb, cc, h0, gy, gf), reps=3, warmup=1),
                       bound_ms=b_ms, bound_by=b_by,
                       bound_tc_ms=3 * scm.scan_bwd_ops(b, s, h, p, n)
                       / PEAK_TF32_S * 1e3, library_ms=None)
            ssd_rec = rec
        ssd_worst = max(ssd_worst, errs["max_abs_err"])
        line("kernel_backward", kernel="ssd_scan_bwd", card=smi, **rec)
        del x, la, bb, cc, h0, gy, gf, got
        torch.cuda.empty_cache()

    line("launch_split", card=smi, traces_retaken=dict(SPLIT_RETRIES))

    # no Pallas kernel has a VJP: each replaces the gradient that XLA
    # derives from the JAX package's jnp function (and, in the port, the
    # gradient in torch ops)
    def record(name, source, replaces, rec, err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": 0, "max_abs_err": err,
                **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms",
                                       "graph_ms")}}

    flash_bwd = record("flash_attention_bwd", "src/repro_torch/kernels/"
                       "flash_attention/csrc/flash_bwd.cu",
                       "src/repro/models/attention.py:89", flash_rec, worst)
    for name, rec in forms.items():   # each form's worst over its cases
        rec["max_abs_err"] = form_worst[name.removesuffix("_bwd")]
    flash_bwd["forms"] = forms
    return [flash_bwd,
            record("ssd_scan_bwd", "src/repro_torch/kernels/ssd_scan/csrc/"
                   "ssd_scan_bwd.cu", "src/repro/models/ssm.py:141", ssd_rec,
                   ssd_worst)]


def phase_train(smi: str) -> dict:
    """(a) ``repro_torch.launch.train.train`` on zamba2-1.2b at full
    width and depth in bf16: AdamW from ``make_optimizer``, batch 4 x
    2,048 tokens of ``SyntheticStream`` data, one warm-up step and
    ``TRAIN_STEPS`` timed; the loss, gradient norm and every parameter
    finite after each update; B4 and B5 launches exactly as the remat
    placement implies (``train_launches``, counts set to 0 just before
    and read just after); seconds a step, tokens/s and peak memory.  Then
    a ``torch.profiler`` breakdown of one more step, split by the step's
    ranges (``train_step.RANGES``) into the forward (kernels B4 and B5),
    the backward (the backward kernels, the rest of the gradient in
    torch ops and each Mamba2 layer's recomputation) and the optimizer.
    (b) ``train_vs_plain``.  (d) One step of every
    architecture's reduced config on the card, finite.  Returns the
    main run's launches and its state (for ``[checkpoint]``)."""
    from repro_torch.configs.base import Shape
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train import build_train_step
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.train_step import RANGES

    spec = train_cli.train_spec(TRAIN_ARCH)
    cfg = spec.config
    model = spec.family.init(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.parameters())
    steps = 1 + TRAIN_STEPS
    params = list(model.parameters())

    def gate(step, state, metrics):
        finite = torch.stack([torch.isfinite(t).all() for t in params])
        if not (bool(finite.all()) and bool(torch.isfinite(
                metrics["loss"])) and bool(torch.isfinite(
                    metrics["grad_norm"]))):
            fail(f"training step {step}: a non-finite loss, gradient norm "
                 "or parameter")

    logs = []
    reset_counts()
    res, train_s = timed(lambda: train_cli.train(
        TRAIN_ARCH, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=0,
        device="cuda", model=model, log_every=1, callback=gate,
        log=logs.append))
    counts = read_counts()
    want = train_launches(cfg, steps)
    launches = counts["launches"]
    for name, n in want.items():
        if launches[name] != n:
            fail(f"training launched {name} {launches[name]} times in "
                 f"{steps} steps, expected {n}: {launches}")
    timed_s = res["step_s"][1:]
    step_s = float(np.mean(timed_s))
    rec = dict(arch=TRAIN_ARCH, params=n_params, layers=cfg.layers,
               attention_sites=cfg.num_groups, dtype=res["dtype"],
               optimizer=res["optimizer"], batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               tokens_per_step=res["tokens_per_step"],
               warmup_step_s=res["step_s"][0], step_s=timed_s,
               mean_step_s=step_s,
               tokens_per_s=res["tokens_per_step"] / step_s,
               max_memory_allocated=counts["max_memory_allocated"],
               losses=[h["loss"] for h in res["history"]],
               grad_norms=[h["grad_norm"] for h in res["history"]],
               launches={k: launches[k] for k in want},
               launches_per_step={k: n // steps for k, n in want.items()},
               seconds=train_s)
    line("train", card=smi, **rec)

    # the profile of one more step, split by the step's ranges
    state = res["state"]
    step_fn = build_train_step(
        lambda m, b: spec.family.loss_fn(m, b, cfg),
        make_optimizer(spec, total_steps=steps), accum_dtype=spec.accum_dtype)
    batch = {k: (v if v.is_floating_point() else v.long()).cuda()
             for k, v in SyntheticStream(
                 spec.input_shapes(Shape("cli", TRAIN_SEQ, TRAIN_BATCH,
                                         "train")),
                 spec.vocab, seed=0).batch(steps).items()}
    prof, prof_s = timed(lambda: device_breakdown(
        lambda: step_fn(state, batch), RANGES))
    part = {f"{name.split('.')[-1]}_ms": prof["ranges_ms"][name]
            for name in RANGES}
    line("train_profile", card=smi, arch=TRAIN_ARCH, **part,
         step_device_ms=prof["device_busy_ms"],
         step_wall_ms=prof["wall_ms"], idle_share=prof["idle_share"],
         top=prof["top"], forward_top=prof["ranges_top"][RANGES[0]],
         optimizer_top=prof["ranges_top"][RANGES[-1]], profile_s=prof_s)
    del res, step_fn, params
    torch.cuda.empty_cache()

    train_vs_plain(spec, smi)

    # (d) every architecture's reduced config, one step on the card (B4 at
    # head dims 8 and 16: its CUDA-core forms, forward and backward)
    from repro_torch.configs import list_archs

    def reduced_steps():
        for arch in list_archs():
            r, secs = timed(lambda: train_cli.train(
                arch, reduced=True, steps=1, batch=4, seq=64, seed=0,
                device="cuda", log=lambda *a: None))
            h = r["history"][0]
            if not all(np.isfinite(v) for v in h.values()):
                fail(f"{arch} reduced training step: {h}")
            line("train_reduced", card=smi, arch=arch,
                 optimizer=r["optimizer"], accum_dtype=str(
                     train_cli.train_spec(arch, reduced=True).accum_dtype),
                 seconds=secs, **h)

    reset_counts()
    reduced_steps()
    reduced = read_counts()["launches"]
    line("train_reduced_launches", card=smi, **check_path(
        "reduced/train", reduced, ("simt", "simt_bwd")))
    torch.cuda.empty_cache()
    return {k: launches[k] for k in want}, state


def phase_train_cells(smi: str) -> int:
    """(e) Every ``model/<slug>/train`` cell (10) on the model store:
    recorded on the host (the loss and its gradient, remat recomputation
    included), predicted on the card over the Table-5 CPUs x cores {1, 2,
    4, 8} x round_robin and tpu-v5e at core 1 (one ``predict_many`` a
    cell: one SDCM launch), within 1e-6 of the float64 oracle and of the
    CPU port's predict.  Returns B1's launches."""
    from repro_torch.api import AnalyticalSDCM, Session
    from repro_torch.validate.store import ArtifactStore
    from repro_torch.workloads import registry

    store = ArtifactStore(MODEL_STORE)
    names = [n for n in registry.workload_names("model")
             if n.endswith("/train")]
    if len(names) != TRAIN_CELLS:
        fail(f"{len(names)} model train cells, want {TRAIN_CELLS}")
    card = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cuda", store=store)
    host = Session(cache_model=AnalyticalSDCM(backend="batched"),
                   device="cpu")
    reset_counts()
    for name in names:
        src = registry.resolve(name, "smoke", store=store)
        trace, trace_s = timed(src.trace)
        pairs = [(src, r) for r in model_requests(src)]
        before = read_counts()["launches"]["sdcm_rates_ragged"]
        res, cold_s = timed(lambda: card.predict_many(pairs))
        if read_counts()["launches"]["sdcm_rates_ragged"] - before != 1:
            fail(f"{name}: a predict made other than one SDCM launch")
        oracle = max(check_against_oracle(card, src, r, out, name)
                     for (_, r), out in zip(pairs, res))
        cpu = same_rates(res, host.predict_many(pairs), name)
        info = src.info
        line("model_train_traces", workload=name, card=smi,
             refs=len(trace), blocks=info["num_blocks"],
             touched_bytes=info["touched_bytes"],
             record_s=src.timings["record_s"],
             trace_s=src.timings["trace_s"], resolve_and_trace_s=trace_s,
             cold_predict_s=cold_s, max_abs_err_vs_oracle=oracle,
             max_abs_diff_vs_cpu_port=cpu,
             op_counts=dict(vars(src.op_counts)),
             tpu_vmem_hit_rate=res[1].predictions[0].hit_rates["VMEM"])
    launches = read_counts()["launches"]
    if launches["sdcm_rates_ragged"] != len(names) or launches["sdcm_rates"]:
        fail(f"train cells: {launches}")
    return launches["sdcm_rates_ragged"]



# --- checkpoint, resume and the dry-run (ROADMAP A-11c) ---------------------

RESUME_STEPS = 2                   # steps after the restore, each side
DRYRUN_CELLS = (("llama3-8b", "prefill_32k"), ("mixtral-8x7b", "prefill_32k"),
                ("mamba2-780m", "prefill_32k"), ("zamba2-1.2b", "prefill_32k"),
                ("seamless-m4t-medium", "prefill_32k"),
                ("phi-3-vision-4.2b", "prefill_32k"))
# measured / predicted peak bytes: sound predictions read 1.0001
# (zamba2 train) and 1.05 (llama3 prefill, cuBLAS's workspace); leaving
# out AdamW's moments or the saved activations reads about 1.5
DRYRUN_PEAK_RANGE = (0.9, 1.15)
NONDETERMINISTIC = "does not have a deterministic implementation"


def dir_bytes(root: Path) -> int:
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file())


def leaves_equal(a, b) -> tuple[int, list]:
    """(leaves compared, names of those not bit-equal) of two port train
    states: every stacked parameter leaf (one at a time on the card),
    every optimizer moment and the step."""
    from repro_torch.train.optimizer import param_leaves, stack_leaf

    pa, pb = dict(a.params.named_parameters()), dict(
        b.params.named_parameters())
    bad, n = [], 0
    with torch.no_grad():
        for leaf, info in param_leaves(a.params).items():
            n += 1
            x = stack_leaf([pa[k] for k in info.names], info.lead)
            y = stack_leaf([pb[k] for k in info.names], info.lead)
            if x.dtype != y.dtype or not torch.equal(x, y):
                bad.append(leaf)
        for leaf, s in a.opt_state.items():
            for k, t in s.items():
                n += 1
                if not torch.equal(t, b.opt_state[leaf][k]):
                    bad.append(f"opt_state.{leaf}.{k}")
    n += 1
    if not torch.equal(a.step, b.step):
        bad.append("step")
    return n, bad


def resumed_steps(step_fn, state, stream, first: int) -> tuple:
    """``RESUME_STEPS`` steps of ``state`` on the stream's batches from
    ``first``: (state, [loss], [grad norm]) as floats."""
    losses, norms = [], []
    for step in range(first, first + RESUME_STEPS):
        batch = {k: (v if v.is_floating_point() else v.long()).cuda()
                 for k, v in stream.batch(step).items()}
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return state, losses, norms


def phase_checkpoint(smi: str, state) -> dict:
    """``[checkpoint]``: phase 18's zamba2-1.2b state (full width and
    depth, bf16, AdamW) through ``runtime.checkpoint.CheckpointManager``
    (async) under ``build/``: the snapshot's seconds (``save`` returns once
    the state is on the host), the write's and the restore's, bytes on
    disk; the restore into a freshly built model (in place, onto the
    run's one device, allocating at most one tensor's staging beyond
    the state) bit-equal to the saved state, leaf by leaf; then ``RESUME_STEPS`` steps from the live state
    and as many from the restored one under
    ``torch.use_deterministic_algorithms(True)`` (warnings only, each
    op without a deterministic CUDA form named): losses, gradient norms
    and every leaf after them bit-equal (or, with such an op, within
    ``SERVE_REL_TOL``); B4/B5 launches on the resumed steps; and
    ``plan_remesh`` of the checkpoint onto the host mesh with ``fits``
    against the card's memory.  Returns the resumed steps' launches."""
    import os
    import shutil
    import tempfile
    import warnings

    from repro_torch.configs.base import Shape
    from repro_torch.dist.sharding import ShardingRules
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_device_mesh, make_host_mesh
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models.layers import param_axes
    from repro_torch.runtime import CheckpointManager
    from repro_torch.runtime.elastic import fits, plan_remesh
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train.data import SyntheticStream
    from repro_torch.train.train_step import TrainState

    spec = train_cli.train_spec(TRAIN_ARCH)
    cfg = spec.config
    optimizer = make_optimizer(spec, total_steps=1 + TRAIN_STEPS)
    paxes = param_axes(state.params)
    axes = TrainState((), paxes, optimizer.state_axes(paxes))
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt.",
                                     dir=ROOT / "build"))
    try:
        step = int(state.step)
        mgr = CheckpointManager(ckpt_dir, keep=1, async_write=True)
        _, snapshot_s = timed(lambda: mgr.save(step, state, axes))
        _, write_s = timed(mgr.wait)
        nbytes = dir_bytes(ckpt_dir)
        plan = plan_remesh(ckpt_dir / f"step_{step:08d}", make_host_mesh())
        hbm = torch.cuda.get_device_properties(0).total_memory

        fresh = init_state(spec.family.init(cfg, device="cuda", seed=7),
                           optimizer)
        rules = ShardingRules(make_device_mesh(), spec.rules_for("train"))
        # restored in place: the card holds no second copy of the state,
        # only one tensor's staging at a time (f32, twice for slack)
        one_tensor = 2 * 4 * max(t.numel() for t in (
            *fresh.params.parameters(),
            *(x for s in fresh.opt_state.values() for x in s.values())))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (got, restored), restore_s = timed(
            lambda: mgr.restore_latest(fresh, rules))
        restore_extra = torch.cuda.max_memory_allocated() - base
        if got != step:
            fail(f"checkpoint: restored step {got}, saved {step}")
        if restore_extra > one_tensor:
            fail(f"checkpoint: the restore allocated {restore_extra} bytes "
                 f"beyond the state, more than {one_tensor}")
        n_leaves, bad = leaves_equal(state, restored)
        if bad:
            fail(f"checkpoint: restored leaves differ from the saved "
                 f"state: {bad[:8]}")

        step_fn = build_train_step(
            lambda m, b: spec.family.loss_fn(m, b, cfg), optimizer,
            accum_dtype=spec.accum_dtype)
        stream = SyntheticStream(
            spec.input_shapes(Shape("cli", TRAIN_SEQ, TRAIN_BATCH, "train")),
            spec.vocab, seed=0)
        old_cfg = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                live, live_losses, live_norms = resumed_steps(
                    step_fn, state, stream, step)
                reset_counts()
                back, back_losses, back_norms = resumed_steps(
                    step_fn, restored, stream, step)
                counts = read_counts()
        finally:
            torch.use_deterministic_algorithms(False)
            if old_cfg is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_cfg
        nondeterministic = sorted({str(w.message).split(" does not")[0]
                                   for w in caught
                                   if NONDETERMINISTIC in str(w.message)})
        n_after, bad_after = leaves_equal(live, back)
        same = (live_losses == back_losses and live_norms == back_norms
                and not bad_after)
        if nondeterministic:
            line("checkpoint_nondeterministic_ops", card=smi,
                 ops=nondeterministic, bound=SERVE_REL_TOL)
            worst = max(abs(a - b) / abs(b) for a, b in zip(
                live_losses + live_norms, back_losses + back_norms))
            if worst > SERVE_REL_TOL:
                fail(f"resume: losses / grad norms {worst} apart")
        elif not same:
            fail(f"resume: not bit-identical: losses {live_losses} vs "
                 f"{back_losses}, grad norms {live_norms} vs {back_norms}, "
                 f"leaves {bad_after[:8]}")
        want = train_launches(cfg, RESUME_STEPS)
        launches = {k: counts["launches"][k] for k in want}
        if launches != want:
            fail(f"resumed steps launched {launches}, expected {want}")
        line("checkpoint", card=smi, arch=TRAIN_ARCH,
             params=sum(t.numel() for t in state.params.parameters()),
             optimizer=optimizer.name, step=step, bytes=nbytes,
             leaves=n_leaves, snapshot_s=snapshot_s, write_s=write_s,
             restore_s=restore_s, restore_extra_bytes=restore_extra,
             restore_extra_bound=one_tensor, restore_bit_identical=True,
             resume_steps=RESUME_STEPS, live_losses=live_losses,
             resumed_losses=back_losses, live_grad_norms=live_norms,
             resumed_grad_norms=back_norms, resume_bit_identical=same,
             leaves_after_resume=n_after,
             nondeterministic_ops=nondeterministic, launches=launches,
             plan_bytes_per_device=plan.bytes_per_device,
             plan_fallbacks=len(plan.fallbacks), total_memory=hbm,
             fits=fits(plan, hbm))
        del live, back, restored, fresh
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def measured_peak(fn) -> int:
    """Peak bytes allocated on the card while ``fn`` builds its arguments
    and runs, above what was allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def phase_dryrun(smi: str) -> None:
    """``[dryrun]``: ``launch.dryrun.run_cell`` on the host mesh for one
    full-size cell a family (prefill_32k; the MoE layer at the uniform
    load), recorded on the meta device; then the dry-run's predicted
    peak (arguments + temporaries, one device) against the card's
    ``max_memory_allocated`` for two steps it really runs: zamba2-1.2b's
    train step at 4 x 2,048 (phase 18's step) and llama3-8b's prefill
    at 4 x 2,048, each within ``DRYRUN_PEAK_RANGE``."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import Shape
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.train import build_train_step, init_state
    from repro_torch.train.data import synthetic_batch

    out_dir = ROOT / "build" / "chip_smoke_dryrun"
    for arch, shape in DRYRUN_CELLS:
        rec, secs = timed(lambda: dryrun.run_cell(arch, shape, "host",
                                                  out_dir))
        mem = rec["memory"]
        line("dryrun", card=smi, arch=arch, shape=shape, mesh="host",
             lower_s=rec["lower_s"], seconds=secs, ops=rec["ops"],
             flops=rec["cost"]["flops"],
             bytes_accessed=rec["cost"]["bytes accessed"],
             argument_bytes=mem["argument_bytes"],
             temp_bytes=mem["temp_bytes"], device_bytes=rec["device_bytes"],
             fits=rec["fits"], moe_counts=rec.get("moe_counts"))

    def zamba2_train():
        spec = get_arch(TRAIN_ARCH)
        cfg = spec.config
        opt = make_optimizer(spec, total_steps=1 + TRAIN_STEPS)
        holder = {}

        def run():
            model = spec.family.init(cfg, device="cuda", seed=0)
            state = init_state(model, opt)
            batch = {k: (v if v.is_floating_point() else v.long()).cuda()
                     for k, v in synthetic_batch(
                         spec.input_shapes(Shape("cli", TRAIN_SEQ,
                                                 TRAIN_BATCH, "train")),
                         spec.vocab, seed=0, step=0).items()}
            step_fn = build_train_step(
                lambda m, b: spec.family.loss_fn(m, b, cfg), opt,
                accum_dtype=spec.accum_dtype)
            holder["out"] = step_fn(state, batch)
        return spec, Shape("cli", TRAIN_SEQ, TRAIN_BATCH, "train"), run

    def llama3_prefill():
        spec = get_arch("llama3-8b")
        cfg, fam = spec.config, spec.family
        shape = Shape("cli", SERVE_PROMPT, SERVE_BATCH, "prefill")
        holder = {}

        def run():
            model = fam.init(cfg, device="cuda", seed=0)
            caches = fam.init_caches(cfg, **spec.cache_kwargs(shape),
                                     device="cuda")
            batch = {k: v.long().cuda() for k, v in
                     spec.example_inputs(shape, seed=0).items()}
            holder["out"] = fam.prefill(model, batch, cfg, caches)
        return spec, shape, run

    for name, make in (("zamba2-1.2b/train", zamba2_train),
                       ("llama3-8b/prefill", llama3_prefill)):
        spec, shape, run = make()
        rec, secs = timed(lambda: dryrun.dry_run(spec, shape, "host"))
        predicted = rec["device_bytes"]
        measured = measured_peak(run)
        ratio = measured / predicted
        line("dryrun_peak", card=smi, step=name, batch=shape.global_batch,
             seq=shape.seq_len, predicted_bytes=predicted,
             argument_bytes=rec["memory"]["argument_bytes"],
             temp_bytes=rec["memory"]["temp_bytes"],
             measured_max_memory_allocated=measured, ratio=ratio,
             allowed=DRYRUN_PEAK_RANGE, lower_s=rec["lower_s"],
             dry_run_s=secs)
        if not DRYRUN_PEAK_RANGE[0] <= ratio <= DRYRUN_PEAK_RANGE[1]:
            fail(f"dry-run peak of {name}: predicted {predicted}, measured "
                 f"{measured} (ratio {ratio})")
        torch.cuda.empty_cache()


# --- the partitioned dry-run (ROADMAP A-11d) --------------------------------

# a pod cell that runs B4 (6 shared-attention calls) and B5 (38 Mamba2
# layers), whose partition (~7.7 GB predicted) fits the card with room
# and whose meta recording takes seconds (zamba2's train cell: minutes)
PARTITION_CELL = ("zamba2-1.2b", "prefill_32k", "pod")
PARTITION_LAUNCHES = {"flash_attention": 6, "ssd_scan": 38}


def on_device(cell, vocab: int, seed: int):
    """``cell``'s DTensor arguments with their local shards made on the
    card from ``seed``: floating tensors N(0, 0.02^2) (a norm's scale
    1), token ids below ``vocab``, caches zero.  The model is changed in
    place; returns the new arguments.  On the fake process group a
    collective moves nothing, so a vocab-parallel lookup sums rank 0's
    rows only: ``vocab`` at most the rows of rank 0's table shard keeps
    every embedding a real one."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.tree import tree_map

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def make(t, fill):
        loc = t.to_local()
        if fill == "zero":
            new = torch.zeros(loc.shape, dtype=loc.dtype, device="cuda")
        elif fill == "one":
            new = torch.ones(loc.shape, dtype=loc.dtype, device="cuda")
        elif loc.is_floating_point():
            new = (0.02 * torch.randn(loc.shape, generator=gen,
                                      device="cuda")).to(loc.dtype)
        else:
            new = torch.randint(0, vocab, loc.shape, generator=gen,
                                device="cuda").to(loc.dtype)
        return DTensor.from_local(new, t.device_mesh, t.placements,
                                  run_check=False)

    model, batch, caches = cell.abstract_args[:3]
    for module in model.modules():
        for key, p in list(module._parameters.items()):
            new = torch.nn.Parameter(make(
                p, "one" if key == "scale" else "rand"), requires_grad=False)
            new.axes = p.axes
            module._parameters[key] = new
    batch = {k: make(v, "rand") for k, v in batch.items()}
    caches = tree_map(lambda t: make(t, "zero")
                      if isinstance(t, DTensor) else t, caches)
    return (model, batch, caches, *cell.abstract_args[3:])


def row_rel_err(out: torch.Tensor, plain: torch.Tensor) -> dict:
    """Over the rows of B4's output ``[B, H, S, D]``, the largest
    |out - plain| in a row over the row's rms of ``plain``: its largest
    value (``err``), that row (``row``: b, h, s) and its rms, and the
    value the worst 0.1 % of rows exceed (``q999``)."""
    o, p = out.float(), plain.float()
    rms = p.pow(2).mean(-1).sqrt()
    rel = (o - p).abs().amax(-1) / rms.clamp_min(
        torch.finfo(torch.float32).tiny)
    worst = int(rel.argmax())
    row = [int(i) for i in np.unravel_index(worst, tuple(rel.shape))]
    return {"err": float(rel.max()), "row": row,
            "row_rms": float(rms.flatten()[worst]),
            "q999": float(torch.quantile(rel.flatten()[::17], 0.999))}


def phase_dryrun_partition(smi: str) -> dict:
    """``[dryrun_partition]``: the pod cell's partitioned dry-run on the
    meta device, then rank 0's partition of its step on the card: the
    predicted peak against ``max_memory_allocated``, B4's and B5's
    launches on the local shards, and their outputs against their plain
    versions on those shards.  Returns the card run's launches (B4's
    by form too)."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_device_mesh, make_production_mesh
    from repro_torch.launch.steps import build_cell, distribute_cell, run_step

    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    arch, shape_name, mesh_name = PARTITION_CELL
    spec, shape = get_arch(arch), SHAPES[shape_name]
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    sc = importlib.import_module("repro_torch.kernels.ssd_scan.ssd_scan")
    rec, secs = timed(lambda: dryrun.dry_run(spec, shape, mesh_name))
    mem = rec["memory"]
    line("dryrun_partition", card=smi, arch=arch, shape=shape_name,
         mesh=mesh_name, devices=rec["devices"], lower_s=rec["lower_s"],
         seconds=secs, ops=rec["ops"], flops=rec["cost"]["flops"],
         bytes_accessed=rec["cost"]["bytes accessed"],
         ici_bytes=rec["collectives"]["ici_bytes"],
         collectives=rec["collectives"]["counts"],
         argument_bytes=mem["argument_bytes"],
         temp_bytes=mem["temp_bytes"], device_bytes=rec["device_bytes"],
         replicated_ops=rec["replicated_ops"], fits_tpu_16gb=rec["fits"])
    if not rec["partitioned"] or rec["devices"] != 256:
        fail(f"the pod record is not a partition: {rec['devices']}")
    mesh = make_production_mesh()

    def run_partition(check: dict | None):
        """Build and run rank 0's partition on the card; with ``check``,
        keep the first B4 and B5 launch's local inputs and outputs."""
        saved = {}

        def keep(mod, name):
            orig = mod._forward

            def wrapped(*args):
                out = orig(*args)
                if name not in saved:
                    saved[name] = (tuple(a.clone() if isinstance(
                        a, torch.Tensor) else a for a in args), (
                        out.clone() if isinstance(out, torch.Tensor)
                        else tuple(o.clone() for o in out)))
                return out
            return orig, wrapped

        patches = []
        if check is not None:
            for mod, name in ((fa, "flash_attention"), (sc, "ssd_scan")):
                orig, wrapped = keep(mod, name)
                patches.append((mod, orig))
                mod._forward = wrapped
        try:
            with fake_device_mesh(mesh, "cuda") as dm:
                cell = distribute_cell(build_cell(spec, shape, mesh), dm)
                rows = cell.abstract_args[0].embed.table.to_local().shape[0]
                args = on_device(cell, min(spec.vocab, rows), seed=0)
                (logits, _), _ = run_step(cell, args)
                local = logits.to_local()
                finite = bool(torch.isfinite(local).all())
                del args, cell, logits
        finally:
            for mod, orig in patches:
                mod._forward = orig
        if check is not None:
            check.update(saved)
        return finite, tuple(local.shape)

    reset_counts()
    holder = {}
    measured = measured_peak(lambda: holder.update(
        out=run_partition(None)))
    launches = {"flash_attention": fa.LAUNCHES["flash_attention"],
                "ssd_scan": sc.LAUNCHES["ssd_scan"]}
    forms = dict(fa.LAUNCHES_BY_FORM)
    finite, logits_shape = holder["out"]
    predicted = rec["device_bytes"]
    ratio = measured / predicted
    line("dryrun_partition_peak", card=smi, arch=arch, shape=shape_name,
         mesh=mesh_name, predicted_bytes=predicted,
         argument_bytes=mem["argument_bytes"], temp_bytes=mem["temp_bytes"],
         measured_max_memory_allocated=measured, ratio=ratio,
         allowed=DRYRUN_PEAK_RANGE, local_logits_shape=logits_shape,
         logits_finite=finite, launches=launches)
    if not finite:
        fail("the pod partition's logits are not finite")
    if not DRYRUN_PEAK_RANGE[0] <= ratio <= DRYRUN_PEAK_RANGE[1]:
        fail(f"pod partition peak: predicted {predicted}, measured "
             f"{measured} (ratio {ratio})")
    if launches != PARTITION_LAUNCHES:
        fail(f"pod partition launches {launches}, expected "
             f"{PARTITION_LAUNCHES}")
    launches.update(forms)
    torch.cuda.empty_cache()

    saved: dict = {}
    run_partition(saved)
    (q, k, v, causal, scale, q_offset, kv_len, window), out = \
        saved["flash_attention"]
    plain = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, kv_len=kv_len,
                                     window=window)
    flash_err = float((out.float() - plain.float()).abs().max())
    rows = row_rel_err(out, plain)
    flash_row_err = rows.pop("err")
    (x, la, b, c, h0), (y, final) = saved["ssd_scan"]
    py, pfinal = sc.ssd_scan_plain(x, la, b, c, h0)
    ssd_err = max(float((y.float() - py.float()).abs().max()
                        / py.float().abs().max()),
                  float((final - pfinal).abs().max() / pfinal.abs().max()))
    line("dryrun_partition_kernels", card=smi, flash_q=list(q.shape),
         flash_kv=list(k.shape), flash_dtype=str(q.dtype),
         flash_max_abs_err=flash_err, flash_tol=FLASH_TOL[q.dtype],
         flash_row_rel_err=flash_row_err, flash_row=rows,
         flash_row_tol=FLASH_ROW_TOL_BF16 if q.dtype == torch.bfloat16
         else None,
         ssd_x=list(x.shape), ssd_rel_err=ssd_err, ssd_tol=SSD_TOL)
    if not flash_err <= FLASH_TOL[q.dtype]:
        fail(f"B4 on the partition's shards: {flash_err}")
    if q.dtype == torch.bfloat16 and not flash_row_err <= FLASH_ROW_TOL_BF16:
        fail(f"B4 on the partition's shards: row error {flash_row_err} > "
             f"{FLASH_ROW_TOL_BF16}")
    if not ssd_err <= SSD_TOL:
        fail(f"B5 on the partition's shards: {ssd_err}")
    del saved
    torch.cuda.empty_cache()
    return launches


# --- the linter, and the syncs the card reports ------------------------------

LINT_PATHS = ("src", "tools", "tests")
LINT_BASELINE = ".repro-lint-baseline.json"
# [lint_runtime]'s serve paths: a short prefill and three decode steps at
# full width.  llama3-8b and mixtral-8x7b at 2 layers; zamba2-1.2b at 8,
# one group of 6 Mamba2 layers behind the shared attention and 2 trailing
# ones (at 2 layers it has no attention site: attn_every is 6)
SYNC_BATCH, SYNC_PROMPT, SYNC_GEN = 2, 256, 4
SYNC_LAYERS = {"mixtral-8x7b": 2, "llama3-8b": 2, "zamba2-1.2b": 8}
SYNC_KERNELS = ("sdcm_rates_ragged", "reuse_hist_moments", "flash_attention",
                "tensor_core", "split_kv", "tensor_core_f32", "split_kv_f32",
                "simt",
                "ssd_scan", "flash_attention_bwd", "tensor_core_bwd",
                "tensor_core_f32_bwd", "simt_bwd", "ssd_scan_bwd",
                "moe_dispatch", "moe_gemm", "moe_combine")
# the backward kernels' wrappers: no host sync at all on the training path
BWD_WRAPPERS = ("src/repro_torch/kernels/flash_attention/flash_attention.py",
                "src/repro_torch/kernels/ssd_scan/ssd_scan.py")
# repeated sync sites that the TS rules cannot see, each with the reason
# (also in ROADMAP).  Never moe.py:210 (the loop's expert counts) and never
# a site of a predict path.
KNOWN_MISSED: dict[str, str] = {}
NEVER_MISSED = ("src/repro_torch/models/moe.py:210",)
SYNC_WARNING = "called a synchronizing CUDA operation"  # the debugger's


def phase_lint(smi: str) -> None:
    """``python -m repro_torch.lint --check`` with the committed baseline
    over src, tools and tests, as CI runs the reference's linter: exit 0
    or the run fails.  Files, findings and inline suppressions per family
    from the same lint run again in this process (the CLI prints only
    their totals)."""
    import os

    from repro_torch.lint.baseline import apply_baseline, load_baseline
    from repro_torch.lint.engine import lint_paths

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.lint", "--check", "--baseline",
         LINT_BASELINE, *LINT_PATHS],
        cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"repro_torch.lint --check exited {out.returncode}:\n"
             f"{out.stdout[-4000:]}{out.stderr[-2000:]}")
    t0 = time.perf_counter()
    res = lint_paths([ROOT / p for p in LINT_PATHS], root=ROOT)
    lint_s = time.perf_counter() - t0
    new = apply_baseline(res.findings,
                         load_baseline(ROOT / LINT_BASELINE)).new
    by_family: dict = {}
    for rule, n in sorted(res.suppressed_by_rule.items()):
        fam = by_family.setdefault(rule[:2], {})
        fam[rule] = n
    line("lint", card=smi, files=res.files_checked,
         findings=len(res.findings), unbaselined=len(new),
         suppressed=res.suppressed, suppressed_by_family=by_family,
         cli_s=cli_s, lint_s=lint_s, cli_summary=out.stdout.strip()[-200:])


def record_syncs(fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` with
    every warning shown and recorded; returns ``fn``'s result and, for
    each port line that made the CUDA runtime synchronise, how often it
    did and the chain of port frames (outermost first) of its first
    time.  The record is a ``showwarning`` hook, not a list of warnings:
    it reads the Python stack when the warning is raised, so a sync
    raised inside torch's own Python code is charged to the innermost
    port frame that called it."""
    import traceback
    import warnings

    port = ROOT / "src" / "repro_torch"
    sites: dict = {}
    chains: dict = {}

    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if Path(f.filename).is_relative_to(port)]
        site = (f"{Path(frames[-1].filename).relative_to(ROOT).as_posix()}"
                f":{frames[-1].lineno}" if frames else
                f"{filename}:{lineno}")
        sites[site] = sites.get(site, 0) + 1
        chains.setdefault(site, [
            f"{Path(f.filename).relative_to(ROOT).as_posix()}:{f.lineno}"
            for f in frames])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, sites, chains


def ts_sites() -> dict:
    """``{"src/repro_torch/<file>:<line>": "TS1xx flagged|suppressed"}``
    for every line of every TS finding over the port's sources."""
    from repro_torch.lint.analyzers import torch_sync
    from repro_torch.lint.engine import ModuleContext, iter_python_files

    out = {}
    for f in iter_python_files([ROOT / "src" / "repro_torch"]):
        rel = f.relative_to(ROOT).as_posix()
        ctx = ModuleContext(f, rel, f.read_text())
        for ln, fd in torch_sync.sync_lines(ctx).items():
            how = ("suppressed" if ctx.suppressed(fd.rule_id, fd.line)
                   else "flagged")
            out[f"{rel}:{ln}"] = f"{fd.rule_id} {how}"
    return out


def sync_paths(exact) -> list:
    """[lint_runtime]'s paths: (name, is a predict path, kernels it must
    launch, the call to record, its check)."""
    from repro_torch.api import AnalyticalSDCM, Session
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve

    w, req, warm = main_path_session(MAIN_WORKLOAD)
    warm.predict(w, req)

    def predict(**kw):
        sess = warm if not kw else Session(
            cache_model=AnalyticalSDCM(backend="batched"), device="cuda",
            **kw)
        return lambda: sess.predict(w, req)

    def same(res):
        if res.to_json() != exact.to_json():
            fail("lint_runtime: a predict differs from the main path's")

    def served(arch):
        layers = SYNC_LAYERS[arch]
        spec = get_arch(arch)
        cfg = serve.with_config(spec.config, layers=layers)

        def run():
            model = spec.family.init(cfg, device="cuda", seed=0)
            return lambda: serve.serve(
                arch, batch=SYNC_BATCH, prompt_len=SYNC_PROMPT, gen=SYNC_GEN,
                seed=0, device="cuda", layers=layers, model=model)
        return run

    def tokens(res):
        if res["tokens"].shape != (SYNC_BATCH, SYNC_GEN):
            fail(f"lint_runtime: tokens of shape {res['tokens'].shape}")

    def trained():
        """zamba2-1.2b's loss and gradient at full width and 8 layers,
        bf16, batch 2 x 256: B4 and B5 forward and backward."""
        import dataclasses

        from repro_torch.configs.base import Shape
        from repro_torch.train.data import synthetic_batch

        spec = get_arch("zamba2-1.2b")
        cfg = serve.with_config(spec.config,
                                layers=SYNC_LAYERS["zamba2-1.2b"])
        sp = dataclasses.replace(spec, config=cfg)
        batch = {k: v.cuda() for k, v in synthetic_batch(
            sp.input_shapes(Shape("train", SYNC_PROMPT, SYNC_BATCH,
                                  "train")), sp.vocab, seed=1,
            step=0).items()}
        model = sp.family.init(cfg, device="cuda", seed=0)
        model.requires_grad_(True)
        return lambda: loss_and_grads(sp, cfg, model, batch)

    def finite(res):
        loss, grads = res
        if not (bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads)):
            fail("lint_runtime: a non-finite loss or gradient")

    return [
        ("predict_exact_warm", True, ("sdcm_rates_ragged",),
         lambda: predict(), same),
        ("predict_binned", True, ("sdcm_rates_ragged", "reuse_hist_moments"),
         lambda: predict(binned=True),
         lambda res: close_to_exact(res, exact, "lint_runtime binned")),
        ("predict_streaming", True, ("sdcm_rates_ragged",),
         lambda: predict(window_size=STREAM_WINDOW), same),
        ("mixtral-8x7b/decode", False, ("flash_attention", "moe_gemm"),
         served("mixtral-8x7b"), tokens),
        ("llama3-8b/decode", False, ("flash_attention",),
         served("llama3-8b"), tokens),
        ("zamba2-1.2b/decode", False, ("flash_attention", "ssd_scan"),
         served("zamba2-1.2b"), tokens),
        ("zamba2-1.2b/train", False, ("flash_attention", "ssd_scan",
                                      "flash_attention_bwd", "ssd_scan_bwd"),
         trained, finite),
    ]


def phase_lint_runtime(smi: str, exact) -> dict:
    """Each path once under the sync debugger.  A port line that syncs
    more than once in one call is a sync in a loop: TS must report it
    (flagged or suppressed), or it is listed in KNOWN_MISSED with the
    reason TS cannot see it.  Returns each path's kernel launches."""
    t_phase = time.perf_counter()
    bad = [s for s in KNOWN_MISSED if s in NEVER_MISSED]
    if bad:
        fail(f"KNOWN_MISSED lists {bad}, which TS must report")
    ts = ts_sites()
    by_path = {}
    for name, is_predict, needs, make, check in sync_paths(exact):
        call = make()
        reset_counts()
        t0 = time.perf_counter()
        res, sites, chains = record_syncs(call)
        secs = time.perf_counter() - t0
        launches = {k: read_counts()["launches"][k] for k in SYNC_KERNELS}
        check(res)
        for k in needs:
            if launches[k] <= 0:
                fail(f"lint_runtime {name} launched no {k}: {launches}")
        in_wrappers = [s for s in sites if s.startswith(BWD_WRAPPERS)]
        if name.endswith("/train") and in_wrappers:
            fail(f"lint_runtime {name}: a kernel wrapper synced: "
                 f"{in_wrappers}")
        repeated = {s: n for s, n in sites.items() if n > 1}
        known = [s for s in repeated if s in KNOWN_MISSED]
        missed = [s for s in repeated if s not in ts and s not in known]
        line("lint_runtime", card=smi, path=name, seconds=secs,
             sites=sites, repeated=sorted(repeated),
             ts={s: ts[s] for s in sites if s in ts},
             known_missed=known, missed=missed,
             missed_chains={s: chains[s] for s in missed},
             launches=launches)
        if is_predict and known:
            fail(f"lint_runtime {name}: predict-path sites {known} are in "
                 "KNOWN_MISSED")
        if missed:
            fail(f"lint_runtime {name}: repeated sync sites TS does not "
                 f"report: {missed}")
        by_path[name] = launches
        del call, res
        torch.cuda.empty_cache()
    line("lint_runtime", card=smi, paths=list(by_path),
         phase_s=time.perf_counter() - t_phase)
    return by_path


def form_record(parent: dict, form: str, source: str) -> dict:
    """A kernels-line entry for one form of a kernel record (its
    ``forms`` entry, which holds the form's timed case)."""
    rec = parent["forms"][form]
    return {"name": f"{parent['name']}/{form}", "route": "cuda",
            "source": source, "replaces": parent["replaces"],
            "launches": rec["launches"], "max_abs_err": rec["max_abs_err"],
            "case": rec["case"],
            **{k: rec[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "bound_tc_ms", "library_ms", "graph_ms",
                                   "library_graph_ms")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the kernels record here as JSON")
    ap.add_argument("--phase", choices=("dryrun_partition", "flash",
                                        "hit_probs", "kernel_backward",
                                        "moe", "sweep"), default=None,
                    help="build the kernels and run this phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device(("moe",) if args.phase == "moe" else None)
    if args.phase is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        run = {"dryrun_partition": phase_dryrun_partition,
               "flash": lambda smi: phase_flash(),
               "hit_probs": lambda smi: phase_hit_probs(),
               "kernel_backward": phase_kernel_backward,
               "moe": lambda smi: phase_moe(),
               "sweep": lambda smi: phase_sweep()}[args.phase]
        out, secs = timed(lambda: run(smi))
        line("phase_alone", phase=args.phase, seconds=secs, result=out)
        return 0
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
    model = phase_model_traces(smi)
    sdcm_kernel["launches_by_path"] = {
        f"polybench/{MAIN_WORKLOAD}": sdcm_kernel["launches"],
        "model_traces": model["sdcm_rates_ragged"]}
    sdcm_kernel["launches"] = sum(sdcm_kernel["launches_by_path"].values())
    for rec in hist_kernels:  # B2 in the model cell's binned check too
        if rec["name"] == "reuse_hist_moments":
            rec["launches_by_path"] = {
                "binned_main_path": rec["launches"],
                MODEL_VALIDATE: model["reuse_hist_moments"]}
            rec["launches"] = sum(rec["launches_by_path"].values())
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     model["reuse_hist_moments_err"])
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions
    flash_kernel, ssd_kernel = phase_flash(), phase_ssd()
    serve_launches = phase_zamba2_serve()
    ssd_kernel["launches"] = serve_launches["ssd_scan"]
    phase_mamba2_serve()
    by_path = {"zamba2-1.2b": serve_launches}
    by_path["llama3-8b"] = phase_llama3_serve()
    moe_kernel = phase_moe()
    by_path["mixtral-8x7b"] = phase_mixtral_serve()
    by_path["seamless-m4t-medium"] = phase_seamless_serve()
    by_path["phi-3-vision-4.2b"] = phase_phi3v_serve()
    torch.backends.cudnn.allow_tf32 = False  # f32 gradients stay f32
    bwd_kernels = phase_kernel_backward(smi)
    by_path["zamba2-1.2b/train"], train_state = phase_train(smi)
    t_phase = time.perf_counter()
    by_path["zamba2-1.2b/resume"] = phase_checkpoint(smi, train_state)
    del train_state
    torch.cuda.empty_cache()
    checkpoint_s = time.perf_counter() - t_phase
    _, dryrun_s = timed(lambda: phase_dryrun(smi))
    by_path[f"{PARTITION_CELL[2]}/{PARTITION_CELL[0]}/{PARTITION_CELL[1]}"], \
        dryrun_partition_s = timed(lambda: phase_dryrun_partition(smi))
    line("a11c_phases", card=smi, checkpoint_s=checkpoint_s,
         dryrun_s=dryrun_s, dryrun_partition_s=dryrun_partition_s)
    sdcm_kernel["launches_by_path"]["model_traces/train"] = \
        phase_train_cells(smi)
    sdcm_kernel["launches"] = sum(sdcm_kernel["launches_by_path"].values())
    ssd_kernel["launches_by_path"] = {
        "zamba2-1.2b": serve_launches["ssd_scan"],
        "zamba2-1.2b/train": by_path["zamba2-1.2b/train"]["ssd_scan"],
        "zamba2-1.2b/resume": by_path["zamba2-1.2b/resume"]["ssd_scan"],
        "pod/zamba2-1.2b/prefill_32k":
            by_path["pod/zamba2-1.2b/prefill_32k"]["ssd_scan"]}
    ssd_kernel["launches"] = sum(ssd_kernel["launches_by_path"].values())
    # B4 over every serve path, the training path, the resumed steps and
    # the check paths (the f32 checks: the tensor-core f32 forms' path; the
    # reduced configs' steps); the window form is mixtral's launches, bf16
    # and f32
    by_path.update(CHECK_PATHS)
    flash_kernel["launches"] = sum(n["flash_attention"]
                                   for n in by_path.values())
    flash_kernel["launches_by_path"] = {
        arch: n["flash_attention"] for arch, n in by_path.items()}
    for form, rec in flash_kernel["forms"].items():
        rec["launches"] = (
            by_path["mixtral-8x7b"]["flash_attention"]
            + by_path["mixtral-8x7b/f32_consistency"]["flash_attention"]
            if form == "window" else sum(n[form] for n in by_path.values()))
    phase_more_workloads(t_start)
    phase_lint(smi)
    synced = phase_lint_runtime(smi, exact)
    # the grouped GEMM: the mixtral serve path and the sync debugger's
    moe_kernel["launches_by_path"] = {
        "mixtral-8x7b": by_path["mixtral-8x7b"]["moe_gemm"]}
    for rec, name in ((sdcm_kernel, "sdcm_rates_ragged"),
                      *((r, r["name"]) for r in hist_kernels
                        if r["name"] == "reuse_hist_moments"),
                      (flash_kernel, "flash_attention"),
                      (ssd_kernel, "ssd_scan"), (moe_kernel, "moe_gemm")):
        rec["launches_by_path"]["lint_runtime"] = sum(
            n[name] for n in synced.values())
        rec["launches"] = sum(rec["launches_by_path"].values())
    for form, rec in flash_kernel["forms"].items():
        rec["launches"] += (synced["mixtral-8x7b/decode"]["flash_attention"]
                            if form == "window" else
                            sum(n[form] for n in synced.values()))
    # the backward kernels: the training path, the resumed steps, the f32
    # training check, the reduced configs' steps and the sync debugger's
    # training path
    bwd_paths = ("zamba2-1.2b/train", "zamba2-1.2b/resume",
                 "zamba2-1.2b/train_f32", "reduced/train")
    for rec in bwd_kernels:
        rec["launches_by_path"] = {path: by_path[path][rec["name"]]
                                   for path in bwd_paths}
        rec["launches_by_path"]["lint_runtime"] = sum(
            n[rec["name"]] for n in synced.values())
        rec["launches"] = sum(rec["launches_by_path"].values())
        for form, frec in rec.get("forms", {}).items():
            frec["launches"] = sum(by_path[path][form] for path in bwd_paths
                                   ) + sum(n[form] for n in synced.values())
    # the tensor-core f32 forms and the f32 split-KV form also as entries
    # of their own; each must have launched on its path
    flash_bwd = next(r for r in bwd_kernels
                     if r["name"] == "flash_attention_bwd")
    f32_kernels = [
        form_record(flash_kernel, "tensor_core_f32", "src/repro_torch/"
                    "kernels/flash_attention/csrc/flash_tc_f32.cuh"),
        form_record(flash_kernel, "split_kv_f32", "src/repro_torch/"
                    "kernels/flash_attention/csrc/flash_split.cuh"),
        form_record(flash_bwd, "tensor_core_f32_bwd", flash_bwd["source"])]
    for rec in f32_kernels:
        if not rec["launches"]:
            fail(f"{rec['name']} never launched on its path")
    kernels = ([sdcm_kernel, hit_probs_kernel] + hist_kernels
               + [flash_kernel, ssd_kernel] + bwd_kernels + f32_kernels
               + [moe_kernel])
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
