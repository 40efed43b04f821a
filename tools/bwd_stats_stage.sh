#!/bin/sh
# Times the statistics stage of B4's tensor-core backward in a checkout
# whose dQ pass still has one (flash_bwd.cu before that form read the
# forward's log-sum-exp) at zamba2-1.2b's train shape, on the card: copies
# CHECKOUT's src/ and this repository's chip_smoke.py to a temporary
# directory, skips the tensor-core dQ pass's second stage there (the loop
# after "stage 2"), and prints chip_smoke.py's per-launch split of that
# copy's backward, whose dq_kernel time is then the statistics stage alone.
#
#   sh tools/bwd_stats_stage.sh CHECKOUT
set -e
src=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
tmp=$(mktemp -d)
trap 'rm -rf "$tmp"' EXIT
cp -r "$here/chip_smoke.py" "$src/src" "$tmp/"
cu="$tmp/src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"
line=$(grep -n "stage 2: dS" "$cu" | cut -d: -f1)
loop=$(awk -v s="$line" 'NR > s && /for \(int tile = first; tile < end/ \
    { print NR; exit }' "$cu")
sed -i "${loop}s/tile = first/tile = end/" "$cu"
cd "$tmp"
PYTHONPATH=src python3 - <<'EOF'
import importlib
import sys

import torch

sys.argv = ["chip_smoke.py"]
cs = importlib.import_module("chip_smoke")
fam = importlib.import_module(
    "repro_torch.kernels.flash_attention.flash_attention")
cs.phase_device()
rand = cs.cuda_rand(60)
b, h, s, d = cs.TRAIN_BATCH, 32, cs.TRAIN_SEQ, 64
q, k, v = (rand(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
           for _ in range(3))
go = rand(b, h, s, d, dtype=torch.bfloat16)
cs.line("bwd_stats_stage", card=cs.nvidia_smi(), split_ms=cs.launch_split(
    lambda: fam._backward(q, k, v, go, True, None, 0, None, None)))
EOF
