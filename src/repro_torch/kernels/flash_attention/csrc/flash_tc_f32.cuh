// Tensor-core f32 form: f32, D = 64, 96 or 128, more than kMaxRows q rows
// per kv head, 16-byte-aligned rows (FlashAttention-2's shape, as
// flash_tc.cuh, with 3xTF32 products: kernels/csrc/tf32x3.cuh).
//
// One block of four warps per (head, batch, 64-row q tile); the q tile is
// the slowest grid dimension and counts down, so the causal tiles with the
// most columns start first.  Each warp owns 16 q rows.  Q sits in shared
// memory and K / V tiles of kBlockK rows arrive by cp.async through a ring of
// two stages (K(t + 1) lands during the softmax and P V of tile t, V(t + 1)
// during its P V and the next Q K^T), rows padded to D + 4 floats.  The
// tiles and products are flash_tf32.cuh's, which the backward shares:
//   S = Q K^T  mma.sync m16n8k8 TF32, three products a k-step (lo hi, hi
//              lo, hi hi) into f32: Q's A fragments and K's B fragments by
//              ldmatrix, each split into TF32 high and low parts in
//              registers (flash_tf32::abt);
//   softmax    S, the running max and the partial row sums stay in f32
//              registers, in natural units (scores times scale): each row
//              lives on one quad of lanes, reduced by two shuffles;
//   O += P V   P split in registers as the A operand, its C fragment taken
//              as the A fragment of a permuted k-step, V's rows to match
//              (flash_tf32::pb; no shuffle, no pass through shared memory).
// Under autograd (kTrain) it also writes each row's log-sum-exp m + ln l
// (natural, f32 [B, H, Sq]); the backward's third form recomputes P as
// e^(scale s - lse) from the same products, so that a row that sees one
// column gets P = 1 exactly.  f32 needs no rounding residual.
// Tiles: kBlockK = 64 at D 64 (87,040 bytes of shared memory), 32 at D 96
// and 128 (76,800 / 101,376): two blocks an SM at every D.
#pragma once

#include "flash_common.cuh"
#include "flash_tf32.cuh"

namespace flash_tc_f32 {

using namespace flash;
using flash_tf32::abt;
using flash_tf32::kThreads;
using flash_tf32::load_rows;
using flash_tf32::pb;
using flash_tf32::zero;

constexpr int kBlockQ = kThreads / 2;  // 16 rows a warp

template <int D>
struct Cfg {
  static constexpr int kBlockK = D == 64 ? 64 : 32;
  static constexpr int kStride = flash_tf32::kRowFloats<D>;
  static constexpr int kTile = kBlockK * kStride;
  static constexpr size_t kBytes =
      (size_t)(kBlockQ * kStride + 4 * kTile) * sizeof(float);
};

template <int D, bool kTrain>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, Strides sq_, Strides sk_,
                    Strides sv_, Strides so_, int sq, int group, int kv_len,
                    int q_offset, int causal, int window, float scale) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBlockK, kStride = C::kStride, kTile = C::kTile;
  constexpr int NT = kBK / 8;   // n-tiles of S, k-steps of P V
  constexpr int kG = D / 32;    // P V's groups of four n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kBlockQ][kStride]
  float* ks = qs + kBlockQ * kStride;               // [2][kTile]
  float* vs = ks + 2 * kTile;                       // [2][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockQ;
  const int hk = h / group;
  const float* kp = k + b * sk_.b + hk * sk_.h;
  const float* vp = v + b * sv_.b + hk * sv_.h;

  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int visible = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (visible + kBK - 1) / kBK;
  const int first_tile =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBK : 0;

  // Q with K(first) is the first cp.async group, V(first) the second
  load_rows<D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, sq, kBlockQ);
  load_rows<D>(ks, kp, sk_.s, first_tile * kBK, kv_len, kBK);
  cp_async_commit();
  load_rows<D>(vs, vp, sv_.s, first_tile * kBK, kv_len, kBK);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;   // mma fragment row / quad lane
  const int row_lo = q0 + warp * 16;        // the warp's first row
  float acc[kG][4][4];
  zero<D>(acc);
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};

  for (int t = first_tile; t < n_tiles; ++t) {
    // groups in flight: ... K(t), V(t); K(t + 1) and V(t + 1) are issued
    // once every warp is done with the buffers they overwrite
    const int buf = (t - first_tile) & 1;
    cp_async_wait<1>();  // K(t)
    __syncthreads();
    const float* kt = ks + buf * kTile;
    const float* vt = vs + buf * kTile;

    // S = Q K^T: 16 rows x kBK columns per warp, NT column blocks of 8
    float s[NT][4];
    abt<D, NT>(s, qs, warp * 16, kt, lane);
    if (t + 1 < n_tiles) {
      load_rows<D>(ks + (buf ^ 1) * kTile, kp, sk_.s, (t + 1) * kBK, kv_len,
                   kBK);
    }
    cp_async_commit();

    const int j0 = t * kBK;
    // some (row, column) of the warp's 16 x kBK is masked
    const bool mask = j0 + kBK > kv_len ||
                      (causal && j0 + kBK - 1 > q_offset + row_lo) ||
                      (window > 0 && j0 <= q_offset + row_lo + 15 - window);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][e] * scale;
        if (mask) {
          const int col = j0 + i * 8 + 2 * tq + (e & 1);
          const int pos = q_offset + row_lo + g + (e >> 1) * 8;
          if (col >= kv_len || (causal && col > pos) ||
              (window > 0 && col <= pos - window)) {
            x = -INFINITY;  // e^(-inf - m) = 0, m >= -1e30
          }
        }
        s[i][e] = x;
      }
    }

    // online softmax; rows g (e = 0, 1) and g + 8 (e = 2, 3)
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[i][0], s[i][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[i][2], s[i][3]));
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      alpha[j] = fast_exp2((m_run[j] - mx[j]) * kLog2e);
      m_run[j] = mx[j];
    }
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][e] = fast_exp2((s[i][e] - mx[e >> 1]) * kLog2e);
        rs[e >> 1] += s[i][e];
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l_run[j] = l_run[j] * alpha[j] + rs[j];
#pragma unroll
    for (int x = 0; x < kG; ++x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[x][i][0] *= alpha[0];
        acc[x][i][1] *= alpha[0];
        acc[x][i][2] *= alpha[1];
        acc[x][i][3] *= alpha[1];
      }
    }

    cp_async_wait<1>();  // V(t)
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_rows<D>(vs + (buf ^ 1) * kTile, vp, sv_.s, (t + 1) * kBK, kv_len,
                   kBK);
    }
    cp_async_commit();

    // O += P V (each tile's products summed in fresh registers, then added
    // to O: see flash_tf32::pb)
    pb<D, NT, false>(acc, s, acc, s, vt, lane);
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
      lse[((int64_t)b * gridDim.x + h) * sq + row] = m_run[j] + logf(l_run[j]);
    }
    float* out = o + b * so_.b + h * so_.h + row * so_.s + 2 * tq;
#pragma unroll
    for (int x = 0; x < kG; ++x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float2*>(out + (4 * x + i) * 8) =
            make_float2(acc[x][i][2 * j] / l_run[j],
                        acc[x][i][2 * j + 1] / l_run[j]);
      }
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, const Strides (&st)[4], int batch, int heads, int sq,
           int group, int kv_len, int q_offset, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t kSmem = Cfg<D>::kBytes;
  // once per template instance, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_f32_kernel<D, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  static const cudaError_t attr_t = cudaFuncSetAttribute(
      flash_tc_f32_kernel<D, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr_t != cudaSuccess) return (int)attr_t;
  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(heads, batch, n_qt);
  if (lse) {
    flash_tc_f32_kernel<D, true><<<grid, kThreads, kSmem, stream>>>(
        q, k, v, o, lse, st[0], st[1], st[2], st[3], sq, group, kv_len,
        q_offset, causal, window, scale);
  } else {
    flash_tc_f32_kernel<D, false><<<grid, kThreads, kSmem, stream>>>(
        q, k, v, o, lse, st[0], st[1], st[2], st[3], sq, group, kv_len,
        q_offset, causal, window, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace flash_tc_f32
