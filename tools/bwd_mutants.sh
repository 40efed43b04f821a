#!/bin/sh
# Mutation checks of the backward kernels on the card: each mutant is a copy
# of CHECKOUT's chip_smoke.py and src/ in a temporary directory with one
# fault put into one kernel source; chip_smoke.py's [kernel_backward] phase
# must fail on it (its FAILED line names the gradient and both readings).
#   b5-no-carry   B5's reverse pass over chunks drops the carried dH:
#                 G_{c-1} = V_c instead of a_c G_c + V_c (only the
#                 slow_decay case's chunks carry enough to show it).
#   b4-lse-row    B4's dK/dV pass reads the log-sum-exp of the neighbouring
#                 q row for every even column.
# Prints one "[mutant] NAME rc=RC" line each, then the phase's last lines;
# exits 1 if a mutant passed the phase.
#
#   sh tools/bwd_mutants.sh CHECKOUT
set -u
src=$(cd "$1" && pwd)
status=0
run() {
  name=$1 file=$2 expr=$3
  tmp=$(mktemp -d)
  cp -r "$src/chip_smoke.py" "$src/src" "$tmp/"
  before=$(md5sum "$tmp/$file" | cut -d' ' -f1)
  sed -i "$expr" "$tmp/$file"
  if [ "$(md5sum "$tmp/$file" | cut -d' ' -f1)" = "$before" ]; then
    echo "[mutant] $name: the fault did not apply"
    status=1
  else
    (cd "$tmp" && python3 chip_smoke.py --phase kernel_backward \
      > "$tmp/out.txt" 2>&1)
    rc=$?
    echo "[mutant] $name rc=$rc"
    grep -a "FAILED" "$tmp/out.txt" | cut -c1-400
    [ "$rc" -ne 0 ] || status=1
  fi
  rm -rf "$tmp"
}
run b5-no-carry src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu \
  's/const float a = expf(sl\[c\]);/const float a = fwd ? expf(sl[c]) : 0.0f;/'
run b4-lse-row src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu \
  's/nl\[i\]\[0\] = ls\[8 \* i + 2 \* tq\] \* kLog2e;/nl[i][0] = ls[8 * i + 2 * tq + 1] * kLog2e;/'
exit $status
