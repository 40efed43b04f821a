#!/bin/sh
# Mutation checks of the kernels on the card: each mutant is a copy of
# CHECKOUT's chip_smoke.py and src/ in a temporary directory with one fault
# put into one kernel source; a chip_smoke.py phase run alone must fail on
# it (its FAILED line names the case and the reading).
#   b5-no-carry   B5's reverse pass over chunks drops the carried dH:
#                 G_{c-1} = V_c instead of a_c G_c + V_c (only the
#                 slow_decay case's chunks carry enough to show it);
#                 [kernel_backward].
#   b4-lse-row    B4's dK/dV pass reads the log-sum-exp of the neighbouring
#                 q row for every even column; [kernel_backward].
#   b4-1xtf32-fwd B4's f32 tensor-core forward with one TF32 product
#                 where it takes three (hi hi alone: tf32x3.cuh's mma3
#                 without its lo hi and hi lo rounds), which TF32's 10
#                 mantissa bits cannot carry to the f32 gates; [flash] (its
#                 first f32 case).  tf32x3.cuh is shared, so this also
#                 breaks B4's and B5's f32 backward: [flash] runs first.
#   b4-1xtf32-bwd the same fault in B4's f32 tensor-core backward alone:
#                 flash_bwd.cu includes its own copy of flash_tf32.cuh
#                 whose mma3 takes hi hi alone, while the forward (and its
#                 log-sum-exp) keeps three products; [kernel_backward]
#                 (train_f32's gradient).
# Prints one "[mutant] NAME rc=RC" line each, then the phase's FAILED
# line; exits 1 if a mutant passed its phase.
#
#   sh tools/bwd_mutants.sh CHECKOUT [NAME ...]   (NAMEs: only those)
set -u
src=$(cd "$1" && pwd)
shift
only=" $* "
status=0
run() {  # name phase file sed-expression [setup]
  name=$1 phase=$2 file=$3 expr=$4 setup=${5:-true}
  if [ "$only" != "  " ] && [ "${only#* $name }" = "$only" ]; then
    return
  fi
  tmp=$(mktemp -d)
  cp -r "$src/chip_smoke.py" "$src/src" "$tmp/"
  "$setup" "$tmp" || status=1
  before=$(md5sum "$tmp/$file" | cut -d' ' -f1)
  sed -i "$expr" "$tmp/$file"
  if [ "$(md5sum "$tmp/$file" | cut -d' ' -f1)" = "$before" ]; then
    echo "[mutant] $name: the fault did not apply"
    status=1
  else
    (cd "$tmp" && python3 chip_smoke.py --phase "$phase" \
      > "$tmp/out.txt" 2>&1)
    rc=$?
    echo "[mutant] $name rc=$rc"
    grep -a "FAILED" "$tmp/out.txt" | cut -c1-400
    [ "$rc" -ne 0 ] || status=1
  fi
  rm -rf "$tmp"
}
run b5-no-carry kernel_backward \
  src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu \
  's/const float a = expf(sl\[c\]);/const float a = fwd ? expf(sl[c]) : 0.0f;/'
run b4-lse-row kernel_backward \
  src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu \
  's/nl\[i\]\[0\] = ls\[8 \* i + 2 \* tq\] \* kLog2e;/nl[i][0] = ls[8 * i + 2 * tq + 1] * kLog2e;/'
one='s/mma_tf32(acc\[j\], al, bh\[j\]\[0\], bh\[j\]\[1\]);/;/; s/mma_tf32(acc\[j\], ah, bl\[j\]\[0\], bl\[j\]\[1\]);/;/'
run b4-1xtf32-fwd flash src/repro_torch/kernels/csrc/tf32x3.cuh "$one"
tiles_1x() {  # $1: the copy; flash_tf32_1x.cuh, whose mma3 is hi hi alone
  d=$1/src/repro_torch/kernels/flash_attention/csrc
  sed 's/^using tf32x3::mma3;$/template <int NT> __device__ __forceinline__ void mma3(float (\&acc)[NT][4], const uint32_t (\&ah)[4], const uint32_t (\&)[4], const uint32_t (\&bh)[NT][2], const uint32_t (\&)[NT][2]) { for (int j = 0; j < NT; ++j) tf32x3::mma_tf32(acc[j], ah, bh[j][0], bh[j][1]); }/' \
    "$d/flash_tf32.cuh" > "$d/flash_tf32_1x.cuh"
  grep -q "tf32x3::mma_tf32(acc\[j\], ah, bh" "$d/flash_tf32_1x.cuh"
}
run b4-1xtf32-bwd kernel_backward \
  src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu \
  's/#include "flash_tf32.cuh"/#include "flash_tf32_1x.cuh"/' tiles_1x
exit $status
