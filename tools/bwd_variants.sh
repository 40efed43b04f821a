#!/bin/sh
# Tile-shape variants of the backward kernels, each in a copy of CHECKOUT's
# chip_smoke.py and src/ with one constant changed, timed at zamba2-1.2b's
# train shape by tools/bwd_timing.py (one [bwd_timing] line each, labelled
# by the variant; each line times both kernels, so a variant of one gives
# another reading of the other):
#   base       the sources as they are
#   dq-bn128   B4's dQ pass streaming 128-column KV tiles
#   dq-mt2     B4's dQ pass at two m-tiles a warp (128 q rows, 32 columns)
#   dkdv-q128  B4's dK/dV pass streaming 128 q rows a step
#   dkdv-mt2   B4's dK/dV pass at two m-tiles a warp, 32 q rows a step
#   b5-rna     B5's 3xTF32 split by cvt.rna.tf32 (rounded) instead of a mask
#
#   sh tools/bwd_variants.sh CHECKOUT
set -u
src=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
b4=src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu
b5=src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu
bn128='s/static constexpr int kBN = 64 \/ kMTq;/static constexpr int kBN = 128;/'
mtq='s/static constexpr int kMTq = 1;/static constexpr int kMTq = D == 64 ? 2 : 1;/'
q128='s/kQ2 = D > 64 ? 32 : 64;/kQ2 = D > 64 ? 32 : 128;/'
mtk='s/static constexpr int kMTk = 1;/static constexpr int kMTk = D == 64 ? 2 : 1;/'
q32='s/kQ2 = D > 64 ? 32 : 64;/kQ2 = 32;/'
rna_hi='s/hi = __float_as_uint(x) \& 0xffffe000u;/asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));/'
rna_lo='s/lo = __float_as_uint(x - __uint_as_float(hi));/asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));/'
run() {  # name file sed-expression...
  name=$1 file=$2
  shift 2
  tmp=$(mktemp -d)
  cp -r "$src/chip_smoke.py" "$src/src" "$tmp/"
  for expr in "$@"; do sed -i "$expr" "$tmp/$file"; done
  python3 "$here/tools/bwd_timing.py" "$tmp" --label "$name" 2>&1 |
    grep -a "bwd_timing\|Error\|error" | cut -c1-2000
  rm -rf "$tmp"
}
run base "$b4"
run dq-bn128 "$b4" "$bn128"
run dq-mt2 "$b4" "$mtq"
run dkdv-q128 "$b4" "$q128"
run dkdv-mt2 "$b4" "$mtk" "$q32"
run b5-rna "$b5" "$rna_hi" "$rna_lo"
