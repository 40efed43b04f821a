// Split-KV decode form: at most kMaxRows q rows per kv head (rows = group *
// Sq), D = 64, 96 or 128, in two element types from one template:
//   bf16 ("split_kv")       splits of 128 columns; 47, 65.5 or 84 KB of
//       shared memory a block at D 64, 96 or 128;
//   f32 ("split_kv_f32")    splits of 64 columns, so that K and V in
//       f32 fit beside q and the scores: 42, 60.4 or 78.8 KB a block, two
//       blocks an SM at D 128 (128-column f32 splits would take ~148 KB and
//       leave one).  At most 16 rows do at most ~8 flops a byte, below the
//       f32 ridge: f32 FMAs on the CUDA cores, as in bf16.
// Past 48 KB the opt-in in launch.  The merge's lanes own D / 32 columns
// each (3 at D = 96).  Cross-attention decode (not causal) visits every split
// up to kv_len.
//
// At decode the work is the bytes of the KV cache, and a grid over q tiles
// has one block per head walking the whole cache in sequence, 63 of a 64-row
// tile's rows padding.  Here the grid is (KV split, kv head, batch): one
// block handles all group x Sq rows of its kv head, so each K/V row is read
// once per group, and the cache is cut across many blocks.  With a window
// the grid covers only the splits from the one holding the first row's
// window edge (first_split) to the last visible column: block x handles
// split first_split + x, and the scratch and the merge index splits from 0
// there.
//   split_kernel  the split's K and V rows arrive in shared memory by
//                 coalesced 16-byte cp.async (8 bf16 or 4 f32 elements); the
//                 128 threads take the split's columns, kThreads / kSplit of
//                 them a column (1 in bf16; 2 in f32, each scoring every
//                 second row), and score the column's K row against the rows
//                 (f32, q prescaled by scale * log2(e) in shared memory).
//                 One warp per row then takes the split's max m and sum l
//                 of exp2(s - m); the block writes (m, l, acc = sum_j p_j
//                 v_j) in f32 to scratch.
//                 A row that sees no column of the split writes m = -1e30,
//                 l = 0, acc = 0: weight 0 in the merge, never NaN.
//   merge_kernel  one warp per (row, kv head, batch) combines the splits
//                 in a fixed order (deterministic): M = max m_s,
//                 out = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M),
//                 1e-30); in bf16, for a training step's backward, also the
//                 row's ln 2 (M + log2 max(L, 1e-30)) to f32 [B, H, Sq] and
//                 the bf16 rounding residual of out to o_lo (flash_tc.cuh).
//                 The f32 form writes the output alone: its backward is the
//                 CUDA-core form, which reads no log-sum-exp.
#pragma once

#include "flash_common.cuh"

namespace flash_split {

using namespace flash;

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;

// Columns a split: one a thread in bf16, half as many in f32.
template <typename T>
struct Split;
template <>
struct Split<bf16> {
  static constexpr int kColumns = 128;
};
template <>
struct Split<float> {
  static constexpr int kColumns = 64;
};

template <typename T, int D>
struct Layout {
  static constexpr int kSplit = Split<T>::kColumns;
  static constexpr int kPiece = 16 / (int)sizeof(T);  // elements a 16-byte copy
  static constexpr int kKStride = D + kPiece;  // padded K rows: conflict-free
  static constexpr size_t kBytes =
      (size_t)kMaxRows * D * sizeof(float)            // q rows, scaled
      + (size_t)kMaxRows * kSplit * sizeof(float)     // scores, then p
      + (size_t)kSplit * kKStride * sizeof(T)         // K rows
      + (size_t)kSplit * D * sizeof(T);               // V rows
};

// One 16-byte piece of a K row in shared memory as f32.
__device__ __forceinline__ void piece_f32(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 x = __bfloat1622float2(v2[u]);
    f[2 * u] = x.x;
    f[2 * u + 1] = x.y;
  }
}
__device__ __forceinline__ void piece_f32(const float* p, float (&f)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  f[0] = raw.x;
  f[1] = raw.y;
  f[2] = raw.z;
  f[3] = raw.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, Strides sq_, Strides sk_,
             Strides sv_, int sq, int group, int kv_len, int q_offset,
             int causal, int window, int first_split, float scale_log2,
             float* __restrict__ part_ml, float* __restrict__ part_acc) {
  using L = Layout<T, D>;
  constexpr int kSplit = L::kSplit, kPiece = L::kPiece;
  constexpr int kKStride = L::kKStride;
  constexpr int kRowStep = kThreads / kSplit;   // threads a column
  constexpr int kRowsT = kMaxRows / kRowStep;   // rows a thread scores
  static_assert(kThreads % kSplit == 0 && kSplit % 32 == 0, "tiling");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);    // [rows][D]
  float* ps = qs + kMaxRows * D;                      // [rows][kSplit]
  T* ks = reinterpret_cast<T*>(ps + kMaxRows * kSplit);  // [kSplit][..]
  T* vs = ks + kSplit * kKStride;                     // [kSplit][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int rows = group * sq;
  const int j0 = (first_split + split) * kSplit;
  const T* kp = k + b * sk_.b + hk * sk_.h;
  const T* vp = v + b * sv_.b + hk * sv_.h;

  // the split's K and V rows by cp.async, neighbouring threads on
  // neighbouring 16-byte pieces of a row; rows past kv_len are zeros
  constexpr int kChunks = D / kPiece;
  for (int e = tid; e < kSplit * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = j0 + r < kv_len;
    cp_async16(smem_u32(ks + r * kKStride + c * kPiece),
               ok ? kp + (j0 + r) * sk_.s + c * kPiece : kp, ok);
    cp_async16(smem_u32(vs + r * D + c * kPiece),
               ok ? vp + (j0 + r) * sv_.s + c * kPiece : vp, ok);
  }
  cp_async_commit();
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int gi = r / sq, i = r % sq;
    qs[e] = to_f32(q[b * sq_.b + (hk * group + gi) * sq_.h + i * sq_.s + d]) *
            scale_log2;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this thread's column, scored against rows r0, r0 + kRowStep, ...
  const int col = tid % kSplit, r0 = tid / kSplit;
  const int j = j0 + col;
  const bool in_range = j < kv_len;
  float sc[kRowsT];
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) sc[i] = 0.0f;
  if (in_range) {
    const T* krow = ks + col * kKStride;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      float kf[kPiece];
      piece_f32(krow + c * kPiece, kf);
#pragma unroll
      for (int i = 0; i < kRowsT; ++i) {
        const int r = r0 + kRowStep * i;
        if (r < rows) {
          const float* qr = qs + r * D + c * kPiece;
#pragma unroll
          for (int u = 0; u < kPiece; ++u) sc[i] = fmaf(qr[u], kf[u], sc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsT; ++i) {
    const int r = r0 + kRowStep * i;
    if (r < rows) {
      const int pos = q_offset + r % sq;
      const bool ok = in_range && (!causal || j <= pos) &&
                      (window <= 0 || j > pos - window);
      ps[r * kSplit + col] = ok ? sc[i] : -INFINITY;
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
      a = fmaf(pr[c], to_f32(vs[c * D + d]), a);
    }
    out[e] = a;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(32)
merge_kernel(const float* __restrict__ part_ml,
             const float* __restrict__ part_acc, T* __restrict__ o,
             float* __restrict__ lse, T* __restrict__ o_lo, Strides so_,
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
    const T hi = from_f32<T>(x);
    o[at + lane + 32 * u] = hi;
    if (o_lo) o_lo[at + lane + 32 * u] = from_f32<T>(x - to_f32(hi));
  }
}

// lse and o_lo: both null, or (bf16 under autograd) both set; the caller
// checks.
template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, T* o_lo,
           const Strides (&st)[4], int batch, int kv_heads, int sq,
           int group, int kv_len, int q_offset, int causal, int window,
           float scale, int n_splits, float* part_ml, float* part_acc,
           cudaStream_t stream) {
  constexpr size_t kSmem = Layout<T, D>::kBytes;
  constexpr int kSplit = Layout<T, D>::kSplit;
  static const cudaError_t attr = cudaFuncSetAttribute(
      split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  split_kernel<T, D><<<dim3(n_splits, kv_heads, batch), kThreads, kSmem,
                       stream>>>(q, k, v, st[0], st[1], st[2], sq, group,
                                 kv_len, q_offset, causal, window,
                                 first_split, scale * kLog2e, part_ml,
                                 part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<T, D><<<dim3(group * sq, kv_heads, batch), 32, 0, stream>>>(
      part_ml, part_acc, o, lse, o_lo, st[3], sq, group, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace flash_split
