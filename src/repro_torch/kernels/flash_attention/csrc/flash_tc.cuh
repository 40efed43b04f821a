// Tensor-core prefill form: bf16, D = 64, 96 or 128 (FlashAttention-2 shape).
// D = 96 is six 16-wide k-steps of Q K^T and twelve 8-wide n-tiles of P V
// (every ldmatrix.x4 covers 16 of D, so no loop steps past it); its padded
// rows of 104 bf16 (208 bytes) keep ldmatrix's eight row addresses in eight
// distinct 16-byte bank groups, and a block takes 66,560 bytes of shared
// memory (the opt-in below), two blocks an SM.
//
// One block of four warps per (head, batch, 64-row q tile); the q tile is
// the slowest grid dimension and counts down, so the causal tiles with the
// most columns start first.  Each warp owns 16 q rows.  K/V arrive in
// 64-row tiles by cp.async into padded shared memory (rows of D + 8 bf16:
// ldmatrix reads stay free of bank conflicts), double-buffered so the next
// tile's copy overlaps this tile's products (K(t + 1) lands during the
// softmax and P V of tile t, V(t + 1) during its P V and the next Q K^T).
//   S = Q K^T  mma.sync m16n8k16 (bf16 in, f32 out): Q fragments loaded
//              once by ldmatrix and kept in registers, K by ldmatrix;
//   softmax    S, the running max and the partial row sums stay in
//              registers; each row lives on one quad of lanes, reduced by
//              two shuffles; exp2 of scores prescaled by scale * log2(e);
//   O += P V   P converted to bf16 in registers as the A operand (as SDPA
//              does), V by ldmatrix.trans; O in f32 registers.
// The forward of a training step (kTrain: its backward, flash_bwd.cu, reads
// what it keeps) also writes each row's log-sum-exp ln sum_j e^{scale s_ij}
// to f32 [B, H, Sq], and carries O to ~16 bits: P enters P V as a bf16 high
// part and a bf16 low part (two products), and O's bf16 rounding residual
// goes to o_lo beside O, so that the backward's Delta = dO . (O + O_lo)
// equals rowsum(dP P) to f32 accuracy (with a bf16 O a row that sees few
// columns loses it).  The serving path (kTrain false) does neither.
// Masks are applied only where a tile crosses kv_len or, for the warp's
// rows, the causal diagonal or the window's lower edge.  With a window the
// tile loop starts at the tile holding the block's first row's edge, so a
// windowed prefill visits O(S (W + kBlockK)) columns, like the reference's
// banded form (_sdpa_blocked); a warp whose rows lie further down may find
// the first tiles wholly masked, which the -inf scores make add nothing.
#pragma once

#include "flash_common.cuh"

namespace flash_tc {

using namespace flash;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockQ = 16 * kWarps;
constexpr int kBlockK = 64;

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;  // bf16 per padded shared row
  static constexpr int kTile = kBlockK * kStride;
  static constexpr size_t kBytes =
      (size_t)(kBlockQ * kStride + 4 * kTile) * sizeof(bf16);
};

// Copy rows [row0, row0 + 64) of a [rows, D] bf16 matrix (row stride
// `stride`) into a padded shared tile; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int64_t stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < kBlockK * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < rows;
    const bf16* s = ok ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * Layout<D>::kStride + c * 8), s, ok);
  }
}

template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, bf16* __restrict__ o_lo,
                Strides sq_, Strides sk_,
                Strides sv_, Strides so_, int sq,
                int group, int kv_len, int q_offset, int causal, int window,
                float scale_log2) {
  constexpr int kStride = Layout<D>::kStride;
  constexpr int kTile = Layout<D>::kTile;
  constexpr int kD16 = D / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBlockQ * kStride;  // [2][kTile]
  bf16* vs = ks + 2 * kTile;          // [2][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const int hk = h / group;
  const bf16* qp = q + b * sq_.b + h * sq_.h;
  const bf16* kp = k + b * sk_.b + hk * sk_.h;
  const bf16* vp = v + b * sv_.b + hk * sv_.h;

  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int visible = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (visible + kBlockK - 1) / kBlockK;
  const int first_tile =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBlockK : 0;

  // Q with K(first) is the first cp.async group, V(first) the second
  {
    constexpr int kChunks = D / 8;
    for (int e = threadIdx.x; e < kBlockQ * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = q0 + r < sq;
      const bf16* s = ok ? qp + (q0 + r) * sq_.s + c * 8 : qp;
      cp_async16(smem_u32(qs + r * kStride + c * 8), s, ok);
    }
  }
  load_tile<D>(ks, kp, sk_.s, first_tile * kBlockK, kv_len);
  cp_async_commit();
  load_tile<D>(vs, vp, sv_.s, first_tile * kBlockK, kv_len);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;     // mma fragment row / quad lane
  const int mi = lane >> 3, mr = lane & 7;    // ldmatrix matrix / row
  const int row_lo = q0 + warp * 16;          // the warp's first row
  uint32_t qf[kD16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int t = first_tile; t < n_tiles; ++t) {
    // groups in flight: ... K(t), V(t); K(t + 1) and V(t + 1) are issued
    // once every warp is done with the buffers they overwrite
    const int buf = (t - first_tile) & 1;
    cp_async_wait<1>();  // K(t)
    __syncthreads();
    if (t == first_tile) {
#pragma unroll
      for (int kk = 0; kk < kD16; ++kk) {
        const int r = warp * 16 + mr + (mi & 1) * 8;
        ldmatrix_x4(qf[kk], smem_u32(qs + r * kStride + kk * 16 +
                                     (mi >> 1) * 8));
      }
    }
    const bf16* kt = ks + buf * kTile;
    const bf16* vt = vs + buf * kTile;

    // S = Q K^T: 16 rows x 64 columns per warp, 8 column blocks of 8
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t bfr[4];
        const int r = n2 * 16 + mr + (mi >> 1) * 8;
        ldmatrix_x4(bfr, smem_u32(kt + r * kStride + kk * 16 + (mi & 1) * 8));
        mma_bf16(s[2 * n2], qf[kk], bfr[0], bfr[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], bfr[2], bfr[3]);
      }
    }
    if (t + 1 < n_tiles) {
      load_tile<D>(ks + (buf ^ 1) * kTile, kp, sk_.s, (t + 1) * kBlockK,
                   kv_len);
    }
    cp_async_commit();

    const int j0 = t * kBlockK;
    // some (row, column) of the warp's 16 x 64 is masked
    const bool mask = j0 + kBlockK > kv_len ||
                      (causal && j0 + kBlockK - 1 > q_offset + row_lo) ||
                      (window > 0 && j0 <= q_offset + row_lo + 15 - window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale_log2;
        if (mask) {
          const int col = j0 + i * 8 + 2 * tq + (e & 1);
          const int pos = q_offset + row_lo + g + (e >> 1) * 8;
          if (col >= kv_len || (causal && col > pos) ||
              (window > 0 && col <= pos - window)) {
            x = -INFINITY;  // exp2(-inf - m) = 0, m >= -1e30
          }
        }
        s[i][e] = x;
      }
    }

    // online softmax; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = fast_exp2(m_run[j] - mx[j]);
      m_run[j] = mx[j];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = fast_exp2(s[i][e] - mx[e >> 1]);
        rs[e >> 1] += s[i][e];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l_run[j] = l_run[j] * alpha[j] + rs[j];
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }

    cp_async_wait<1>();  // V(t)
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_tile<D>(vs + (buf ^ 1) * kTile, vp, sv_.s, (t + 1) * kBlockK,
                   kv_len);
    }
    cp_async_commit();

    // O += P V: P's accumulator layout is the A fragment's
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4], a_lo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* pu = s[2 * kk + (u >> 1)] + 2 * (u & 1);
        if (kTrain) {
          split_bf16(pu[0], pu[1], a[u], a_lo[u]);
        } else {
          a[u] = pack_bf16(pu[0], pu[1]);
        }
      }
#pragma unroll
      for (int d2 = 0; d2 < kD16; ++d2) {
        uint32_t bfr[4];
        const int r = kk * 16 + mr + (mi & 1) * 8;
        ldmatrix_x4_trans(bfr, smem_u32(vt + r * kStride + d2 * 16 +
                                        (mi >> 1) * 8));
        if (kTrain) {
          mma_bf16(acc[2 * d2], a_lo, bfr[0], bfr[1]);
          mma_bf16(acc[2 * d2 + 1], a_lo, bfr[2], bfr[3]);
        }
        mma_bf16(acc[2 * d2], a, bfr[0], bfr[1]);
        mma_bf16(acc[2 * d2 + 1], a, bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 1);
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 2);
    l_run[j] = fmaxf(l_run[j], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row_lo + g + 8 * j;
    if (row >= sq) continue;
    if (kTrain && tq == 0) {
      lse[((int64_t)b * gridDim.x + h) * sq + row] =
          (m_run[j] + log2f(l_run[j])) * kLn2;
    }
    const int64_t at = b * so_.b + h * so_.h + row * so_.s + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      uint32_t hi, lo;
      split_bf16(acc[i][2 * j] / l_run[j], acc[i][2 * j + 1] / l_run[j], hi,
                 lo);
      *reinterpret_cast<uint32_t*>(o + at + i * 8) = hi;
      if (kTrain) *reinterpret_cast<uint32_t*>(o_lo + at + i * 8) = lo;
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           bf16* o_lo, const Strides (&st)[4], int batch, int heads, int sq,
           int group, int kv_len, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t kSmem = Layout<D>::kBytes;
  // once per template instance, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  static const cudaError_t attr_t = cudaFuncSetAttribute(
      flash_tc_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr_t != cudaSuccess) return (int)attr_t;
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(heads, batch, n_qt);
  if (lse) {
    flash_tc_kernel<D, true><<<grid, kThreads, kSmem, stream>>>(
        q, k, v, o, lse, o_lo, st[0], st[1], st[2], st[3], sq, group, kv_len,
        q_offset, causal, window, scale * kLog2e);
  } else {
    flash_tc_kernel<D, false><<<grid, kThreads, kSmem, stream>>>(
        q, k, v, o, lse, o_lo, st[0], st[1], st[2], st[3], sq, group, kv_len,
        q_offset, causal, window, scale * kLog2e);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash_tc
