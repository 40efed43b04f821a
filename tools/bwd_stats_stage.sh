#!/bin/sh
# Times the statistics stage of one of B4's backward forms at zamba2-1.2b's
# train shape, on the card: copies CHECKOUT's src/ and this repository's
# chip_smoke.py to a temporary directory, skips the second stage of the
# dQ pass there (the loop over the KV tiles that follows the statistics),
# and prints chip_smoke.py's per-launch split of that copy's backward,
# whose dq_kernel time is then the statistics stage alone.
#   bf16 (default)  the tensor-core form of a checkout whose dQ pass still
#                   has a statistics stage (flash_bwd.cu before that form
#                   read the forward's log-sum-exp): the loop after
#                   "stage 2: dS".
#   --f32           the CUDA-core form in f32 (every checkout up to the
#                   tensor-core f32 form): the loop after its dQ pass's
#                   "zero_tiles(acc);".
#
#   sh tools/bwd_stats_stage.sh CHECKOUT [--f32]
set -e
src=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
cp -r "$here/chip_smoke.py" "$src/src" "$tmp/"
cu="$tmp/src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"
if [ "${2:-}" = "--f32" ]; then
  mark="zero_tiles(acc);" dtype=float32
else
  mark="stage 2: dS" dtype=bfloat16
fi
line=$(grep -n "$mark" "$cu" | head -n 1 | cut -d: -f1)
loop=$(awk -v s="$line" 'NR > s && /for \(int tile = first; tile < end/ \
    { print NR; exit }' "$cu")
sed -i "${loop}s/tile = first/tile = end/" "$cu"
cd "$tmp"
DTYPE=$dtype PYTHONPATH=src python3 - <<'EOF2'
import importlib
import inspect
import os
import sys

import torch

sys.argv = ["chip_smoke.py"]
cs = importlib.import_module("chip_smoke")
fam = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
cs.phase_device()
dt = getattr(torch, os.environ["DTYPE"])
rand = cs.cuda_rand(60)
b, h, s, d = cs.TRAIN_BATCH, 32, cs.TRAIN_SEQ, 64
q, k, v = (rand(b, s, h, d, dtype=dt).transpose(1, 2) for _ in range(3))
go = rand(b, h, s, d, dtype=dt)
cs.line("bwd_stats_stage", card=cs.nvidia_smi(), dtype=str(dt),
        form=fam.backward_form(q, k, v, *(  # older checkouts take it
            [go] if len(inspect.signature(fam.backward_form).parameters) > 3
            else [])), split_ms=cs.launch_split(
            lambda: fam._backward(q, k, v, go, True, None, 0, None, None)))
EOF2
