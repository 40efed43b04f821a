// 3xTF32 tiles of B4's f32 tensor-core forms, shared by the forward
// (flash_tc_f32.cuh, in flash_attention.cu) and the backward's third form
// (flash_bwd.cu): f32 rows padded to D + 4 floats in shared memory (then
// ldmatrix's eight 16-byte rows and the scalar reads of a B operand taken in
// the permuted k order below fall in distinct banks), an A B^T product whose
// two operands come by ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 f32 one),
// and a P B product whose A operand is an accumulator: m16n8k8's C fragment
// holds columns 2t, 2t + 1 of a row where its A fragment wants columns t,
// t + 4, so a k-step takes P's columns in the order 0, 2, 4, 6, 1, 3, 5, 7
// (no shuffle and no pass through shared memory) and B's rows to match.
// Every product is three TF32 mma (kernels/csrc/tf32x3.cuh).
#pragma once

#include "flash_common.cuh"
#include "tf32x3.cuh"

namespace flash_tf32 {

using namespace flash;
using tf32x3::mma3;
using tf32x3::mma_tf32;
using tf32x3::split_tf32;

constexpr int kThreads = 128;  // four warps, 16 rows each
template <int D>
constexpr int kRowFloats = D + 4;  // floats a padded shared row

// Rows [row0, row0 + n) of a [rows, D] f32 matrix into a padded shared tile
// by cp.async; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t stride, int row0, int rows,
                                          int n) {
  constexpr int kChunks = D / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < rows;
    const float* s = ok ? src + (row0 + r) * stride + c * 4 : src;
    cp_async16(smem_u32(dst + r * kRowFloats<D> + c * 4), s, ok);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&a)[D / 32][4][4]) {
#pragma unroll
  for (int x = 0; x < D / 32; ++x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[x][i][0] = a[x][i][1] = a[x][i][2] = a[x][i][3] = 0.0f;
    }
  }
}

// s[NT] = A B^T over the D columns, as 3xTF32: A the warp's 16 rows of the
// padded tile `at` from `row`, B the first 8 NT rows of `bt`; both by
// ldmatrix (an 8 x 8 b16 matrix is an 8 x 4 f32 one) and split in registers.
template <int D, int NT>
__device__ __forceinline__ void abt(float (&s)[NT][4], const float* at,
                                    int row, const float* bt, int lane) {
  constexpr int kStride = kRowFloats<D>;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    // A's rows 0-7 / 8-15 (matrix bit 0), columns 0-3 / 4-7 (bit 1)
    uint32_t a[4], ah[4], al[4];
    ldmatrix_x4(a, smem_u32(at + (row + mr + (mi & 1) * 8) * kStride +
                            kk * 8 + (mi >> 1) * 4));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      split_tf32(__uint_as_float(a[u]), ah[u], al[u]);
    }
    // B's rows n2 16 + 0-7 / 8-15 (bit 1), columns 0-3 / 4-7 (bit 0)
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, smem_u32(bt + (n2 * 16 + (mi >> 1) * 8 + mr) * kStride +
                                kk * 8 + (mi & 1) * 4));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        split_tf32(__uint_as_float(bfr[u]), bh[2 * n2 + (u >> 1)][u & 1],
                   bl[2 * n2 + (u >> 1)][u & 1]);
      }
    }
    mma3<NT>(s, ah, al, bh, bl);
  }
}

// acc[16 x D] += P B as 3xTF32: P [16 x 8 NT] the warp's rows in the
// accumulator layout, B the first 8 NT rows of a padded tile.  A k-step takes
// P's columns in the order 0, 2, 4, 6, 1, 3, 5, 7, so that P's C fragment is
// the A fragment, and B's rows in the same order (scalar reads of rows 2 tq
// and 2 tq + 1).  Each group of four n-tiles sums the tile in fresh
// registers and then adds them to acc: the tensor core rounds its f32 sums
// toward zero, which over a long chain of mma into one accumulator (768 at
// 2,048 rows of B) drifts by ~2^-24 of the sum an mma.  kOne: also one +=
// hi(P1) hi(B), one TF32 product on the same B fragments (a correction
// term, whose drift does not count).
template <int D, int NT, bool kOne>
__device__ __forceinline__ void pb(float (&acc)[D / 32][4][4],
                                   const float (&p)[NT][4],
                                   float (&one)[D / 32][4][4],
                                   const float (&p1)[NT][4], const float* bt,
                                   int lane) {
  constexpr int kStride = kRowFloats<D>;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int x = 0; x < D / 32; ++x) {
    float t[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float pa[4] = {p[kk][0], p[kk][2], p[kk][1], p[kk][3]};
      uint32_t ah[4], al[4];
      tf32x3::split4(pa, ah, al);
      const float* br = bt + (kk * 8 + 2 * tq) * kStride + g;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = (4 * x + i) * 8;
        split_tf32(br[n], bh[i][0], bl[i][0]);
        split_tf32(br[kStride + n], bh[i][1], bl[i][1]);
      }
      mma3<4>(t, ah, al, bh, bl);
      if (kOne) {
        const uint32_t oh[4] = {__float_as_uint(p1[kk][0]) & 0xffffe000u,
                                __float_as_uint(p1[kk][2]) & 0xffffe000u,
                                __float_as_uint(p1[kk][1]) & 0xffffe000u,
                                __float_as_uint(p1[kk][3]) & 0xffffe000u};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_tf32(one[x][i], oh, bh[i][0], bh[i][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[x][i][e] += t[i][e];
    }
  }
}

}  // namespace flash_tf32
