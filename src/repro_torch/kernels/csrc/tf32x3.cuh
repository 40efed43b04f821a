// 3xTF32 products on the tensor cores at f32 accuracy, shared by B5's
// backward (ssd_scan/csrc/ssd_scan_bwd.cu) and B4's f32 tensor-core forms
// (flash_attention/csrc/flash_tc_f32.cuh, the forward, and flash_bwd.cu's
// third form).  An f32 operand x is split into a TF32 high part and the rest,
// and a product a b is taken as lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b) with
// f32 accumulation; the dropped lo(a) lo(b) and the tensor core's truncation
// of each low part to TF32 leave ~2^-20 of |a| |b| a term.  TF32 alone (10
// mantissa bits) would miss the f32 gates.  kernels/build.py puts this
// directory on every source's include path and hashes it with each library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x = hi + lo: hi is x cut to TF32 (its low 13 mantissa bits cleared: one
// integer AND, where cvt.rna.tf32 is a slow conversion), lo = x - hi exact
// in f32, which the tensor core reads as TF32 (its low bits dropped): hi +
// lo carries x to ~21 bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c[16x8] += a[16x8] b[8x8], TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four f32 values as an A fragment's high and low parts.
__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) split_tf32(x[u], hi[u], lo[u]);
}

// acc[j] += A B_j over one k-step of 8, as 3xTF32, for NT n-tiles: A's
// parts ah / al, B_j's bh[j] / bl[j] ({b0, b1} each).  Three rounds over the
// n-tiles (lo hi, hi lo, then hi hi), so that the mma into one accumulator
// are NT apart.
template <int NT>
__device__ __forceinline__ void mma3(float (&acc)[NT][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
}

}  // namespace tf32x3
