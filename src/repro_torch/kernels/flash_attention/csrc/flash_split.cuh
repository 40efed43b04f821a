// Split-KV decode form: bf16, D = 64, 96 or 128, at most kMaxRows q rows per
// kv head (rows = group * Sq).  At D = 96 a block takes 65,536 bytes of
// shared memory (past the 48 KB default: the opt-in in launch) and the
// merge's lanes own D / 32 = 3 columns each.  Cross-attention decode (not
// causal) visits every split up to kv_len.
//
// At decode the work is the bytes of the KV cache, and a grid over q tiles
// has one block per head walking the whole cache in sequence.  Here the
// grid is (KV split of kSplit columns, kv head, batch): one block handles
// all group x Sq rows of its kv head, so each K/V row is read once per
// group, and the cache is cut across many blocks.  With a window the grid
// covers only the splits from the one holding the first row's window edge
// (first_split) to the last visible column: block x handles split
// first_split + x, and the scratch and the merge index splits from 0 there.
//   split_kernel  the split's K and V rows arrive in shared memory by
//                 coalesced cp.async; each of the 128 threads owns one
//                 column and scores its K row against every q row (f32, q
//                 prescaled by scale * log2(e) in shared memory).
//                 One warp per row then takes the split's max m and sum l
//                 of exp2(s - m); the block writes (m, l, acc = sum_j p_j
//                 v_j) in f32 to scratch.
//                 A row that sees no column of the split writes m = -1e30,
//                 l = 0, acc = 0: weight 0 in the merge, never NaN.
//   merge_kernel  one warp per (row, kv head, batch) combines the splits
//                 in a fixed order (deterministic): M = max m_s,
//                 out = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M),
//                 1e-30); for a training step's backward also the row's
//                 ln 2 (M + log2 max(L, 1e-30)) to f32 [B, H, Sq] and the
//                 bf16 rounding residual of out to o_lo (flash_tc.cuh).
#pragma once

#include "flash_common.cuh"

namespace flash_split {

using namespace flash;

constexpr int kThreads = 128;
constexpr int kSplit = kThreads;  // columns per split, one per thread
constexpr int kMaxRows = 16;

template <int D>
struct Layout {
  static constexpr int kKStride = D + 8;  // padded K rows: conflict-free
  static constexpr size_t kBytes =
      (size_t)kMaxRows * D * sizeof(float)            // q rows, scaled
      + (size_t)kMaxRows * kSplit * sizeof(float)     // scores, then p
      + (size_t)kSplit * kKStride * sizeof(bf16)      // K rows
      + (size_t)kSplit * D * sizeof(bf16);            // V rows
};

template <int D>
__global__ void __launch_bounds__(kThreads)
split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, Strides sq_, Strides sk_,
             Strides sv_, int sq, int group, int kv_len, int q_offset,
             int causal, int window, int first_split, float scale_log2,
             float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int kKStride = Layout<D>::kKStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [rows][D]
  float* ps = qs + kMaxRows * D;                      // [rows][kSplit]
  bf16* ks = reinterpret_cast<bf16*>(ps + kMaxRows * kSplit);  // [kSplit][..]
  bf16* vs = ks + kSplit * kKStride;                  // [kSplit][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int rows = group * sq;
  const int j0 = (first_split + split) * kSplit;
  const bf16* kp = k + b * sk_.b + hk * sk_.h;
  const bf16* vp = v + b * sv_.b + hk * sv_.h;

  // the split's K and V rows by cp.async, neighbouring threads on
  // neighbouring 16-byte pieces of a row; rows past kv_len are zeros
  constexpr int kChunks = D / 8;
  for (int e = tid; e < kSplit * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = j0 + r < kv_len;
    cp_async16(smem_u32(ks + r * kKStride + c * 8),
               ok ? kp + (j0 + r) * sk_.s + c * 8 : kp, ok);
    cp_async16(smem_u32(vs + r * D + c * 8),
               ok ? vp + (j0 + r) * sv_.s + c * 8 : vp, ok);
  }
  cp_async_commit();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int gi = r / sq, i = r % sq;
    qs[e] = __bfloat162float(q[b * sq_.b + (hk * group + gi) * sq_.h +
                               i * sq_.s + d]) * scale_log2;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this thread's column, scored against every row
  const int j = j0 + tid;
  const bool in_range = j < kv_len;
  float sc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) sc[r] = 0.0f;
  if (in_range) {
    const uint4* krow = reinterpret_cast<const uint4*>(ks + tid * kKStride);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint4 kraw = krow[c];
      const __nv_bfloat162* kv2 =
          reinterpret_cast<const __nv_bfloat162*>(&kraw);
      float kf[8];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(kv2[u]);
        kf[2 * u] = f.x;
        kf[2 * u + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float* qr = qs + r * D + c * 8;
#pragma unroll
          for (int u = 0; u < 8; ++u) sc[r] = fmaf(qr[u], kf[u], sc[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    if (r < rows) {
      const int pos = q_offset + r % sq;
      const bool ok = in_range && (!causal || j <= pos) &&
                      (window <= 0 || j > pos - window);
      ps[r * kSplit + tid] = ok ? sc[r] : -INFINITY;
    }
  }
  __syncthreads();

  // per row: the split's max and sum; p replaces the score
  float* ml = part_ml + ((size_t)(b * gridDim.y + hk) * n_splits + split) *
                           rows * 2;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* pr = ps + r * kSplit;
    float x[kSplit / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kSplit / 32; ++u) {
      x[u] = pr[lane + 32 * u];
      mx = fmaxf(mx, x[u]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const bool empty = mx == -INFINITY;
    float sum = 0.0f;
#pragma unroll
    for (int u = 0; u < kSplit / 32; ++u) {
      const float p = empty ? 0.0f : exp2f(x[u] - mx);
      pr[lane + 32 * u] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      ml[2 * r] = empty ? kNegInf : mx;
      ml[2 * r + 1] = sum;
    }
  }
  __syncthreads();

  // acc = P V over the split's columns
  float* out = part_acc + ((size_t)(b * gridDim.y + hk) * n_splits + split) *
                              rows * D;
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const float* pr = ps + r * kSplit;
    float a = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kSplit; ++c) {
      a = fmaf(pr[c], __bfloat162float(vs[c * D + d]), a);
    }
    out[e] = a;
  }
}

template <int D>
__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ part_ml,
             const float* __restrict__ part_acc, bf16* __restrict__ o,
             float* __restrict__ lse, bf16* __restrict__ o_lo, Strides so_,
             int sq, int group, int n_splits) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x, rows = gridDim.x;
  const size_t base = (size_t)(b * gridDim.y + hk) * n_splits;
  // M and L: lanes over the splits, then a fixed shuffle tree
  float m = kNegInf;
  for (int s = lane; s < n_splits; s += 32) {
    m = fmaxf(m, part_ml[((base + s) * rows + r) * 2]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  float l = 0.0f;
  for (int s = lane; s < n_splits; s += 32) {
    const float* ml = part_ml + ((base + s) * rows + r) * 2;
    l = fmaf(ml[1], exp2f(ml[0] - m), l);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, off);
  }
  // the output row: lanes over d, splits in order
  float a[D / 32];
#pragma unroll
  for (int u = 0; u < D / 32; ++u) a[u] = 0.0f;
#pragma unroll 4
  for (int s = 0; s < n_splits; ++s) {
    const float w = exp2f(part_ml[((base + s) * rows + r) * 2] - m);
    const float* acc = part_acc + ((base + s) * rows + r) * D;
#pragma unroll
    for (int u = 0; u < D / 32; ++u) a[u] = fmaf(acc[lane + 32 * u], w, a[u]);
  }
  const int gi = r / sq, i = r % sq;
  const int64_t at = b * so_.b + (hk * group + gi) * so_.h + i * so_.s;
  const float inv = 1.0f / fmaxf(l, 1e-30f);
  if (lse && lane == 0) {
    lse[((int64_t)b * gridDim.y * group + hk * group + gi) * sq + i] =
        (m + log2f(fmaxf(l, 1e-30f))) * kLn2;
  }
#pragma unroll
  for (int u = 0; u < D / 32; ++u) {
    const float x = a[u] * inv;
    const bf16 hi = __float2bfloat16(x);
    o[at + lane + 32 * u] = hi;
    if (o_lo) {
      o_lo[at + lane + 32 * u] = __float2bfloat16(x - __bfloat162float(hi));
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse,
           bf16* o_lo, const Strides (&st)[4], int batch, int kv_heads,
           int sq,
           int group, int kv_len, int q_offset, int causal, int window,
           float scale, int n_splits, float* part_ml, float* part_acc,
           cudaStream_t stream) {
  constexpr size_t kSmem = Layout<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  // the splits holding a visible column; the wrapper sized the scratch
  const int first_split =
      window > 0 ? max(0, q_offset - window + 1) / kSplit : 0;
  const int end = causal ? min(kv_len, q_offset + sq) : kv_len;
  if (group * sq > kMaxRows ||
      n_splits != (end + kSplit - 1) / kSplit - first_split) {
    return (int)cudaErrorInvalidValue;
  }
  split_kernel<D><<<dim3(n_splits, kv_heads, batch), kThreads, kSmem,
                    stream>>>(q, k, v, st[0], st[1], st[2], sq, group,
                              kv_len, q_offset, causal, window, first_split,
                              scale * kLog2e, part_ml, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<D><<<dim3(group * sq, kv_heads, batch), 32, 0, stream>>>(
      part_ml, part_acc, o, lse, o_lo, st[3], sq, group, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace flash_split
