// f32 register tiles over shared memory for B4's CUDA-core backward form
// (flash_attention/csrc/flash_bwd.cu): each thread owns a 4 x 4 tile of a
// small matrix product and reads its operands as float4; and the bf16 / f32
// converters, which B5's backward (ssd_scan/csrc/ssd_scan_bwd.cu) shares.
// kernels/build.py puts this directory on every source's include path and
// hashes it with each library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace f32_tile {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void load_f4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

// acc[u][v] += sum_{k0 <= k < k1} A(r0 + u, k) B(k, c0 + v) (times ks[k]
// when KS), A(r, k) = TA ? a[k lda + r] : a[r lda + k], B(k, c) = TB ?
// b[c ldb + k] : b[k ldb + c].  k0, k1, r0, c0, lda and ldb are multiples
// of 4 and a, b 16-byte aligned: every read is a float4.
template <bool TA, bool TB, bool KS = false>
__device__ __forceinline__ void mm4(float (&acc)[4][4], const float* a,
                                    int lda, const float* b, int ldb, int r0,
                                    int c0, int k0, int k1,
                                    const float* ks = nullptr) {
  for (int k = k0; k < k1; k += 4) {
    float av[4][4], bv[4][4];  // [kk][u], [kk][v]
    if (TA) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_f4(a + (k + kk) * lda + r0, av[kk]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float t[4];
        load_f4(a + (r0 + u) * lda + k, t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) av[kk][u] = t[kk];
      }
    }
    if (TB) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float t[4];
        load_f4(b + (c0 + v) * ldb + k, t);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) bv[kk][v] = t[kk];
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_f4(b + (k + kk) * ldb + c0, bv[kk]);
    }
    if (KS) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float s = ks[k + kk];
#pragma unroll
        for (int u = 0; u < 4; ++u) av[kk][u] *= s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] = fmaf(av[kk][u], bv[kk][v], acc[u][v]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;
  }
}

}  // namespace f32_tile
