// Flash-attention backward for NVIDIA Hopper (sm_90a).  Built with nvcc
// into a shared library of its own with a plain C interface and loaded with
// ctypes (kernels/build.py, kernels/flash_attention/flash_attention.py);
// the forward (flash_attention.cu, flash_tc.cuh, flash_split.cuh) is
// unchanged, and this file shares only flash_common.cuh with it.
//
// Replaces no Pallas kernel: the TPU's _flash_kernel has no VJP, and the
// JAX package trains through XLA's autodiff of its jnp attention
// (src/repro/models/attention.py::_sdpa_dense / _sdpa_blocked).  On the
// port's side it replaces flash_attention.py::flash_attention_bwd on the
// card, the closed form in f32 torch matmuls over every column, masked ones
// included (which stays as the plain version).
//
// The function: for q [B, H, Sq, D], k, v [B, Hkv, Sk, D] and the output's
// gradient dO [B, H, Sq, D], with P the row softmax of S = scale q k^T over
// the visible columns (the forward's rule: j < kv_len, when causal
// j <= q_offset + i, with a window W > 0 j > q_offset + i - W),
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - rowsum(dP P)),
//   dQ = scale dS K,  dK = scale dS^T Q,
// a kv head's dK and dV summed over the q heads that share it (GQA).
//
// Two deterministic passes, no float atomics; both recompute P from q and
// k (the forward keeps no log-sum-exp):
//   dQ pass     one block per (q tile of 64 rows, head, batch).  A first
//               stage streams the visible KV tiles for each row's max, sum
//               and rowsum(dP P) (online, like the forward's softmax) and
//               writes them to f32 scratch [2, B, H, Sq]; the second
//               streams them again for dS and dQ.
//   dK/dV pass  one block per (kv head, KV tile of 64 columns, batch).  It
//               loops over the q heads that share the kv head and, for
//               each, over the q tiles that see the tile, in a fixed order.
// Both passes skip tiles wholly masked (the causal stream stops at the
// diagonal; a window starts at its band's edge).
//
// Two forms; the wrapper picks one (flash_attention.py::backward_form):
//   tensor-core  bf16, D in {64, 96, 128}, 16-byte-aligned rows: mma.sync
//                m16n8k16 with f32 accumulation, ldmatrix and cp.async as in
//                the forward (flash_common.cuh).  P and dS are rounded to
//                bf16 as the A operands of P^T dO, dS K and dS^T Q, as in
//                FlashAttention-2; S, dP, the statistics and every sum stay
//                f32.  Each warp owns 16 rows (dQ pass: q rows; dK/dV pass:
//                kv rows, computing S^T = K Q^T and dP^T = V dO^T so that
//                P^T and dS^T are already the A operands).  Single-buffered.
//   CUDA-core    everything else (f32, bf16 at D 8-32 or unaligned): f32 FMAs
//                on register tiles of 4 x 4 over f32 shared memory
//                (kernels/csrc/f32_tile.cuh, shared with B5's backward).  f32
//                stays off the tensor cores: TF32 would miss the f32 gates.
//
// What bounds it on the card: P recomputed and dV, dP, dQ, dK, 10 D
// operations per visible pair (2.5x the forward's), at the bf16 tensor-core
// rate for the train shape (zamba2-1.2b: Sq = Sk = 2048, D 64): operations.
// This design does 18 D a pair (the statistics stage and the two passes'
// recomputations), single-buffered: simple and right first.

#include "f32_tile.cuh"
#include "flash_common.cuh"

namespace flash_bwd {

using namespace flash;

constexpr int kBlock = 64;  // q rows and kv columns a tile

struct Dims {
  int sq, sk, group, kv_len, q_offset, causal, window;
};

__device__ __forceinline__ bool visible(const Dims& d, int row, int col) {
  const int pos = d.q_offset + row;
  return row < d.sq && col < d.kv_len && (!d.causal || col <= pos) &&
         (d.window <= 0 || col > pos - d.window);
}

// The KV tiles [first, end) that rows [r0, r1] of a q tile see.
__device__ __forceinline__ void kv_tiles(const Dims& d, int r0, int r1,
                                         int& first, int& end) {
  const int vis = d.causal ? min(d.kv_len, d.q_offset + r1 + 1) : d.kv_len;
  end = (vis + kBlock - 1) / kBlock;
  first = d.window > 0 ? max(0, d.q_offset + r0 - d.window + 1) / kBlock : 0;
}

// The q rows [lo, hi) that see some column of the KV tile at j0.
__device__ __forceinline__ void q_rows(const Dims& d, int j0, int& lo,
                                       int& hi) {
  const int jmax = min(j0 + kBlock, d.kv_len) - 1;
  if (j0 >= d.kv_len) {
    lo = hi = 0;
    return;
  }
  lo = d.causal ? max(0, j0 - d.q_offset) : 0;
  hi = d.window > 0 ? min(d.sq, jmax - d.q_offset + d.window) : d.sq;
}

}  // namespace flash_bwd

// --- CUDA-core form ----------------------------------------------------------

namespace flash_bwd_simt {

using namespace flash;
using f32_tile::mm4;
using flash_bwd::Dims;
using flash_bwd::kBlock;

constexpr int kThreads = 256;
constexpr int kLS = kBlock + 4;  // floats per row of a 64 x 64 tile

template <int D>
struct Smem {
  static constexpr int DS = D + 4;  // floats per row of a 64 x D tile
  // four 64 x D tiles, two 64 x 64 tiles, two row vectors
  static constexpr size_t floats =
      4 * (size_t)kBlock * DS + 2 * (size_t)kBlock * kLS + 2 * kBlock;
  // per-thread 4 x 4 tiles of a 64 x D output
  static constexpr int kTiles = (16 * (D / 4) + kThreads - 1) / kThreads;
};

template <int NT>
__device__ __forceinline__ void zero_tiles(float (&acc)[NT][4][4]) {
#pragma unroll
  for (int q = 0; q < NT; ++q) f32_tile::zero4(acc[q]);
}

// Rows [row0, row0 + 64) of a [rows, D] matrix (row stride `stride`) as f32
// into shared rows of DS floats; rows at or past `rows` are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int rows) {
  for (int e = threadIdx.x; e < kBlock * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * Smem<D>::DS + d] =
        row0 + r < rows ? to_f32(src[(row0 + r) * stride + d]) : 0.0f;
  }
}

// The thread's 4 x 4 tile (r0, c0) of S = Q K^T and of dP = dO V^T.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], float (&dp)[4][4],
                                       const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       int r0, int c0) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int v = 0; v < 4; ++v) s[u][v] = dp[u][v] = 0.0f;
  }
  mm4<false, true>(s, qs, Smem<D>::DS, ks, Smem<D>::DS, r0, c0, 0, D);
  mm4<false, true>(dp, dos, Smem<D>::DS, vs, Smem<D>::DS, r0, c0, 0, D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          T* __restrict__ dq, float* __restrict__ lse,
          float* __restrict__ dsum, Strides sq_, Strides sk_, Strides sv_,
          Strides so_, Strides sdq_, Dims dm, float scale) {
  constexpr int DS = Smem<D>::DS, kT = Smem<D>::kTiles;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * DS;
  float* ks = dos + kBlock * DS;
  float* vs = ks + kBlock * DS;
  float* ps = vs + kBlock * DS;   // [64][kLS] scores, then dS
  float* dps = ps + kBlock * kLS;  // [64][kLS] dP
  float* lse_s = dps + kBlock * kLS;
  float* dsum_s = lse_s + kBlock;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / dm.group;
  const T* qp = q + b * sq_.b + h * sq_.h;
  const T* op = dout + b * so_.b + h * so_.h;
  const T* kp = k + b * sk_.b + hk * sk_.h;
  const T* vp = v + b * sv_.b + hk * sv_.h;
  const int64_t row_stats = ((int64_t)b * gridDim.y + h) * dm.sq;

  load_tile<T, D>(qs, qp, sq_.s, q0, dm.sq);
  load_tile<T, D>(dos, op, so_.s, q0, dm.sq);
  int first, end;
  flash_bwd::kv_tiles(dm, q0, min(q0 + kBlock, dm.sq) - 1, first, end);

  const int r0 = 4 * (t / 16), c0 = 4 * (t % 16);  // the thread's S tile
  const int row = t / 4, part = t % 4;             // its statistics row
  float m_run = kNegInf, l_run = 0.0f, a_run = 0.0f;
  for (int tile = first; tile < end; ++tile) {
    const int j0 = tile * kBlock;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(ks, kp, sk_.s, j0, dm.kv_len);
    load_tile<T, D>(vs, vp, sv_.s, j0, dm.kv_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, dp, qs, dos, ks, vs, r0, c0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool ok = flash_bwd::visible(dm, q0 + r0 + u, j0 + c0 + w);
        ps[(r0 + u) * kLS + c0 + w] = ok ? s[u][w] * scale : -INFINITY;
        dps[(r0 + u) * kLS + c0 + w] = dp[u][w];
      }
    }
    __syncthreads();
    // online statistics: four threads per row, 16 columns each
    const float* prow = ps + row * kLS + 16 * part;
    const float* drow = dps + row * kLS + 16 * part;
    float mx = kNegInf;
    for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float sp = 0.0f, sd = 0.0f;
    for (int c = 0; c < 16; ++c) {
      const float e = expf(prow[c] - m_new);
      sp += e;
      sd = fmaf(e, drow[c], sd);
    }
    const float alpha = expf(m_run - m_new);
    l_run = fmaf(l_run, alpha, sp);
    a_run = fmaf(a_run, alpha, sd);
    m_run = m_new;
  }
  // the four threads of a row add their parts in one order
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  a_run += __shfl_xor_sync(0xffffffffu, a_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  a_run += __shfl_xor_sync(0xffffffffu, a_run, 2);
  if (part == 0) {
    const float l = fmaxf(l_run, 1e-30f);
    lse_s[row] = m_run + logf(l);
    dsum_s[row] = a_run / l;
    if (q0 + row < dm.sq) {
      lse[row_stats + q0 + row] = lse_s[row];
      dsum[row_stats + q0 + row] = dsum_s[row];
    }
  }

  float acc[kT][4][4];
  zero_tiles(acc);
  for (int tile = first; tile < end; ++tile) {
    const int j0 = tile * kBlock;
    __syncthreads();  // the statistics and the last tile's readers are done
    load_tile<T, D>(ks, kp, sk_.s, j0, dm.kv_len);
    load_tile<T, D>(vs, vp, sv_.s, j0, dm.kv_len);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, dp, qs, dos, ks, vs, r0, c0);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = r0 + u;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool ok = flash_bwd::visible(dm, q0 + i, j0 + c0 + w);
        const float p = ok ? expf(s[u][w] * scale - lse_s[i]) : 0.0f;
        ps[i * kLS + c0 + w] = ok ? p * (dp[u][w] - dsum_s[i]) : 0.0f;
      }
    }
    __syncthreads();
    // dQ += dS K
#pragma unroll
    for (int x = 0; x < kT; ++x) {
      const int tl = t + x * kThreads;
      if (tl < 16 * (D / 4)) {
        mm4<false, false>(acc[x], ps, kLS, ks, DS, 4 * (tl / (D / 4)),
                          4 * (tl % (D / 4)), 0, kBlock);
      }
    }
  }
  T* dqp = dq + b * sdq_.b + h * sdq_.h;
#pragma unroll
  for (int x = 0; x < kT; ++x) {
    const int tl = t + x * kThreads;
    if (tl >= 16 * (D / 4)) continue;
    const int rr = 4 * (tl / (D / 4)), cc = 4 * (tl % (D / 4));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q0 + rr + u >= dm.sq) continue;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dqp[(q0 + rr + u) * sdq_.s + cc + w] =
            from_f32<T>(acc[x][u][w] * scale);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            T* __restrict__ dk, T* __restrict__ dv, Strides sq_,
            Strides sk_, Strides sv_, Strides so_, Strides sdk_,
            Strides sdv_, Dims dm, int heads, float scale) {
  constexpr int DS = Smem<D>::DS, kT = Smem<D>::kTiles;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kBlock * DS;
  float* ks = dos + kBlock * DS;
  float* vs = ks + kBlock * DS;
  float* ps = vs + kBlock * DS;    // [64][kLS] P
  float* dss = ps + kBlock * kLS;  // [64][kLS] dS
  float* lse_s = dss + kBlock * kLS;
  float* dsum_s = lse_s + kBlock;

  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kBlock, hk = blockIdx.y, b = blockIdx.z;
  load_tile<T, D>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, j0, dm.sk);
  load_tile<T, D>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, j0, dm.sk);
  int lo, hi;
  flash_bwd::q_rows(dm, j0, lo, hi);

  const int r0 = 4 * (t / 16), c0 = 4 * (t % 16);  // the thread's S tile
  float dka[kT][4][4], dva[kT][4][4];
  zero_tiles(dka);
  zero_tiles(dva);
  for (int g = 0; g < dm.group; ++g) {
    const int h = hk * dm.group + g;
    const T* qp = q + b * sq_.b + h * sq_.h;
    const T* op = dout + b * so_.b + h * so_.h;
    const int64_t row_stats = ((int64_t)b * heads + h) * dm.sq;
    for (int i0 = lo / kBlock * kBlock; i0 < hi; i0 += kBlock) {
      __syncthreads();  // the last tile's readers are done
      load_tile<T, D>(qs, qp, sq_.s, i0, dm.sq);
      load_tile<T, D>(dos, op, so_.s, i0, dm.sq);
      if (t < kBlock) {
        const bool ok = i0 + t < dm.sq;
        lse_s[t] = ok ? lse[row_stats + i0 + t] : INFINITY;
        dsum_s[t] = ok ? dsum[row_stats + i0 + t] : 0.0f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      scores<D>(s, dp, qs, dos, ks, vs, r0, c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = r0 + u;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool ok = flash_bwd::visible(dm, i0 + i, j0 + c0 + w);
          const float p = ok ? expf(s[u][w] * scale - lse_s[i]) : 0.0f;
          ps[i * kLS + c0 + w] = p;
          dss[i * kLS + c0 + w] = ok ? p * (dp[u][w] - dsum_s[i]) : 0.0f;
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q
#pragma unroll
      for (int x = 0; x < kT; ++x) {
        const int tl = t + x * kThreads;
        if (tl < 16 * (D / 4)) {
          const int rr = 4 * (tl / (D / 4)), cc = 4 * (tl % (D / 4));
          mm4<true, false>(dva[x], ps, kLS, dos, DS, rr, cc, 0, kBlock);
          mm4<true, false>(dka[x], dss, kLS, qs, DS, rr, cc, 0, kBlock);
        }
      }
    }
  }
  T* dkp = dk + b * sdk_.b + hk * sdk_.h;
  T* dvp = dv + b * sdv_.b + hk * sdv_.h;
#pragma unroll
  for (int x = 0; x < kT; ++x) {
    const int tl = t + x * kThreads;
    if (tl >= 16 * (D / 4)) continue;
    const int rr = 4 * (tl / (D / 4)), cc = 4 * (tl % (D / 4));
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + rr + u;
      if (j >= dm.sk) continue;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dkp[j * sdk_.s + cc + w] = from_f32<T>(dka[x][u][w] * scale);
        dvp[j * sdv_.s + cc + w] = from_f32<T>(dva[x][u][w]);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats,
           const Strides (&st)[7], int batch, int heads, int kv_heads,
           const Dims& dm, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::floats * sizeof(float);
  // once per template instance, not per launch
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (a1 != cudaSuccess) return (int)a1;
  static const cudaError_t a2 = cudaFuncSetAttribute(
      dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (a2 != cudaSuccess) return (int)a2;
  float* lse = stats;
  float* dsum = stats + (int64_t)batch * heads * dm.sq;
  dq_kernel<T, D><<<dim3((dm.sq + kBlock - 1) / kBlock, heads, batch),
                    kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, lse,
      dsum, st[0], st[1], st[2], st[3], st[4], dm, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T, D><<<dim3((dm.sk + kBlock - 1) / kBlock, kv_heads, batch),
                      kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dsum,
      (T*)dk, (T*)dv, st[0], st[1], st[2], st[3], st[5], st[6], dm, heads,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_simt

// --- tensor-core form ----------------------------------------------------------

namespace flash_bwd_tc {

using namespace flash;
using flash_bwd::Dims;
using flash_bwd::kBlock;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Layout {
  static constexpr int kStride = D + 8;  // bf16 per padded shared row
  static constexpr int kTile = kBlock * kStride;
  // q rows a step of the dK/dV pass: 32 at D > 64 keeps S^T and dP^T at 16
  // registers each beside the two D-wide accumulators
  static constexpr int kQ2 = D > 64 ? 32 : 64;
  static constexpr size_t kDqBytes = 4 * (size_t)kTile * sizeof(bf16);
  static constexpr size_t kDkvBytes =
      (2 * (size_t)kTile + 2 * (size_t)kQ2 * kStride) * sizeof(bf16) +
      2 * kQ2 * sizeof(float);
};

// Rows [row0, row0 + n) of a [rows, D] bf16 matrix into a padded shared
// tile by cp.async; rows at or past `rows` are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int64_t stride, int row0, int rows,
                                          int n) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < rows;
    const bf16* s = ok ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(smem_u32(dst + r * Layout<D>::kStride + c * 8), s, ok);
  }
}

// A fragments of the warp's 16 rows (from `row`) of a padded tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&af)[D / 16][4],
                                       const bf16* tile, int row, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int r = row + mr + (mi & 1) * 8;
    ldmatrix_x4(af[kk], smem_u32(tile + r * Layout<D>::kStride + kk * 16 +
                                 (mi >> 1) * 8));
  }
}

// s[16 x 8 NT] = A B^T: A the warp's fragments, B the first 8 NT rows of a
// padded tile (the forward's Q K^T).
template <int D, int NT>
__device__ __forceinline__ void abt(float (&s)[NT][4],
                                    const uint32_t (&af)[D / 16][4],
                                    const bf16* bt, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bfr[4];
      const int r = n2 * 16 + mr + (mi >> 1) * 8;
      ldmatrix_x4(bfr, smem_u32(bt + r * Layout<D>::kStride + kk * 16 +
                                (mi & 1) * 8));
      mma_bf16(s[2 * n2], af[kk], bfr[0], bfr[1]);
      mma_bf16(s[2 * n2 + 1], af[kk], bfr[2], bfr[3]);
    }
  }
}

// acc[16 x D] += P B: P [16 x 8 NT] in the accumulator layout, rounded to
// bf16 as the A operand; B the first 8 NT rows of a padded tile (the
// forward's P V).
template <int D, int NT>
__device__ __forceinline__ void pb(float (&acc)[D / 8][4],
                                   const float (&p)[NT][4], const bf16* bt,
                                   int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]),
        pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t bfr[4];
      const int r = kk * 16 + mr + (mi & 1) * 8;
      ldmatrix_x4_trans(bfr, smem_u32(bt + r * Layout<D>::kStride + d2 * 16 +
                                      (mi >> 1) * 8));
      mma_bf16(acc[2 * d2], a, bfr[0], bfr[1]);
      mma_bf16(acc[2 * d2 + 1], a, bfr[2], bfr[3]);
    }
  }
}

// The warp's 16 rows of a 16 x D accumulator, times `mul`, as bf16.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t stride,
                                           int row, int rows,
                                           const float (&acc)[D / 8][4],
                                           float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + g + 8 * j;
    if (r >= rows) continue;
    bf16* o = out + r * stride + 2 * tq;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(o + i * 8) = __floats2bfloat162_rn(
          acc[i][2 * j] * mul, acc[i][2 * j + 1] * mul);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          bf16* __restrict__ dq, float* __restrict__ lse2,
          float* __restrict__ dsum, Strides sq_, Strides sk_, Strides sv_,
          Strides so_, Strides sdq_, Dims dm, float scale_log2,
          float scale) {
  constexpr int kStride = Layout<D>::kStride, kTile = Layout<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + kTile;
  bf16* ks = dos + kTile;
  bf16* vs = ks + kTile;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlock;  // long rows first
  const int hk = h / dm.group;
  const bf16* kp = k + b * sk_.b + hk * sk_.h;
  const bf16* vp = v + b * sv_.b + hk * sv_.h;
  load_rows<D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, dm.sq, kBlock);
  load_rows<D>(dos, dout + b * so_.b + h * so_.h, so_.s, q0, dm.sq, kBlock);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int g = lane >> 2, tq = lane & 3;
  const int row_lo = q0 + warp * 16;  // the warp's first row
  uint32_t qf[D / 16][4], df[D / 16][4];
  load_a<D>(qf, qs, warp * 16, lane);
  load_a<D>(df, dos, warp * 16, lane);
  int first, end;
  flash_bwd::kv_tiles(dm, q0, min(q0 + kBlock, dm.sq) - 1, first, end);

  // stage 1: each row's max and sum of 2^x (x = scale log2(e) s) and of
  // 2^x dP, online; rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.0f, 0.0f};
  float a_run[2] = {0.0f, 0.0f};
  for (int tile = first; tile < end; ++tile) {
    const int j0 = tile * kBlock;
    __syncthreads();  // the last tile's readers are done
    load_rows<D>(ks, kp, sk_.s, j0, dm.kv_len, kBlock);
    load_rows<D>(vs, vp, sv_.s, j0, dm.kv_len, kBlock);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
    abt<D, 8>(s, qf, ks, lane);
    abt<D, 8>(dp, df, vs, lane);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = flash_bwd::visible(dm, row_lo + g + (e >> 1) * 8,
                                           j0 + i * 8 + 2 * tq + (e & 1));
        s[i][e] = ok ? s[i][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f}, ra[2] = {0.0f, 0.0f};
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
        const float p = fast_exp2(s[i][e] - mx[e >> 1]);
        rs[e >> 1] += p;
        ra[e >> 1] = fmaf(p, dp[i][e], ra[e >> 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l_run[j] = fmaf(l_run[j], alpha[j], rs[j]);
      a_run[j] = fmaf(a_run[j], alpha[j], ra[j]);
    }
  }
  float lse_r[2], dsum_r[2];
  const int64_t row_stats = ((int64_t)b * gridDim.x + h) * dm.sq;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 1);
    a_run[j] += __shfl_xor_sync(0xffffffffu, a_run[j], 1);
    l_run[j] += __shfl_xor_sync(0xffffffffu, l_run[j], 2);
    a_run[j] += __shfl_xor_sync(0xffffffffu, a_run[j], 2);
    const float l = fmaxf(l_run[j], 1e-30f);
    lse_r[j] = m_run[j] + log2f(l);
    dsum_r[j] = a_run[j] / l;
    const int r = row_lo + g + 8 * j;
    if (tq == 0 && r < dm.sq) {
      lse2[row_stats + r] = lse_r[j];
      dsum[row_stats + r] = dsum_r[j];
    }
  }

  // stage 2: dS = P (dP - rowsum(dP P)), dQ += dS K
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }
  for (int tile = first; tile < end; ++tile) {
    const int j0 = tile * kBlock;
    __syncthreads();
    load_rows<D>(ks, kp, sk_.s, j0, dm.kv_len, kBlock);
    load_rows<D>(vs, vp, sv_.s, j0, dm.kv_len, kBlock);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[8][4], dp[8][4];
    abt<D, 8>(s, qf, ks, lane);
    abt<D, 8>(dp, df, vs, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = flash_bwd::visible(dm, row_lo + g + (e >> 1) * 8,
                                           j0 + i * 8 + 2 * tq + (e & 1));
        const float p =
            ok ? fast_exp2(s[i][e] * scale_log2 - lse_r[e >> 1]) : 0.0f;
        s[i][e] = ok ? p * (dp[i][e] - dsum_r[e >> 1]) : 0.0f;
      }
    }
    pb<D, 8>(acc, s, ks, lane);
  }
  store_rows<D>(dq + b * sdq_.b + h * sdq_.h, sdq_.s, row_lo, dm.sq, acc,
                scale, lane);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse2, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq_,
            Strides sk_, Strides sv_, Strides so_, Strides sdk_,
            Strides sdv_, Dims dm, int heads, float scale_log2,
            float scale) {
  constexpr int kTile = Layout<D>::kTile, kQ2 = Layout<D>::kQ2;
  constexpr int NT = kQ2 / 8;  // n-tiles of S^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;                        // [kQ2][kStride]
  bf16* dos = qs + kQ2 * Layout<D>::kStride;    // [kQ2][kStride]
  float* lse_s = reinterpret_cast<float*>(dos + kQ2 * Layout<D>::kStride);
  float* dsum_s = lse_s + kQ2;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kBlock;
  load_rows<D>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, j0, dm.sk, kBlock);
  load_rows<D>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, j0, dm.sk, kBlock);
  cp_async_commit();
  int lo, hi;
  flash_bwd::q_rows(dm, j0, lo, hi);
  const int g = lane >> 2, tq = lane & 3;
  const int col_lo = j0 + warp * 16;  // the warp's first kv row

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.0f;
  }
  for (int gq = 0; gq < dm.group; ++gq) {
    const int h = hk * dm.group + gq;
    const bf16* qp = q + b * sq_.b + h * sq_.h;
    const bf16* op = dout + b * so_.b + h * so_.h;
    const int64_t row_stats = ((int64_t)b * heads + h) * dm.sq;
    for (int i0 = lo / kQ2 * kQ2; i0 < hi; i0 += kQ2) {
      __syncthreads();  // the last step's readers are done
      load_rows<D>(qs, qp, sq_.s, i0, dm.sq, kQ2);
      load_rows<D>(dos, op, so_.s, i0, dm.sq, kQ2);
      cp_async_commit();
      for (int r = threadIdx.x; r < kQ2; r += kThreads) {
        const bool ok = i0 + r < dm.sq;
        lse_s[r] = ok ? lse2[row_stats + i0 + r] : INFINITY;
        dsum_s[r] = ok ? dsum[row_stats + i0 + r] : 0.0f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: kv rows g, g + 8 of the warp's 16,
      // q columns 8 i + 2 tq + (e & 1)
      float st[NT][4], dpt[NT][4];
      {
        uint32_t af[D / 16][4];
        load_a<D>(af, ks, warp * 16, lane);
        abt<D, NT>(st, af, qs, lane);
        load_a<D>(af, vs, warp * 16, lane);
        abt<D, NT>(dpt, af, dos, lane);
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = i * 8 + 2 * tq + (e & 1);
          const bool ok =
              flash_bwd::visible(dm, i0 + c, col_lo + g + (e >> 1) * 8);
          const float p =
              ok ? fast_exp2(st[i][e] * scale_log2 - lse_s[c]) : 0.0f;
          st[i][e] = p;
          dpt[i][e] = ok ? p * (dpt[i][e] - dsum_s[c]) : 0.0f;
        }
      }
      pb<D, NT>(dva, st, dos, lane);
      pb<D, NT>(dka, dpt, qs, lane);
    }
  }
  cp_async_wait<0>();  // K and V, when no q row sees the tile
  store_rows<D>(dk + b * sdk_.b + hk * sdk_.h, sdk_.s, col_lo, dm.sk, dka,
                scale, lane);
  store_rows<D>(dv + b * sdv_.b + hk * sdv_.h, sdv_.s, col_lo, dm.sk, dva,
                1.0f, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           void* dq, void* dk, void* dv, float* stats,
           const Strides (&st)[7], int batch, int heads, int kv_heads,
           const Dims& dm, float scale, cudaStream_t stream) {
  // once per template instance, not per launch
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<D>::kDqBytes);
  if (a1 != cudaSuccess) return (int)a1;
  static const cudaError_t a2 = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Layout<D>::kDkvBytes);
  if (a2 != cudaSuccess) return (int)a2;
  const int n_qt = (dm.sq + kBlock - 1) / kBlock;
  const int n_kt = (dm.sk + kBlock - 1) / kBlock;
  if (n_qt > 65535 || n_kt > 65535) return (int)cudaErrorInvalidValue;
  float* lse2 = stats;
  float* dsum = stats + (int64_t)batch * heads * dm.sq;
  const float scale_log2 = scale * kLog2e;
  dq_kernel<D><<<dim3(heads, batch, n_qt), kThreads, Layout<D>::kDqBytes,
                 stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (bf16*)dq, lse2, dsum, st[0], st[1], st[2], st[3], st[4], dm,
      scale_log2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<dim3(kv_heads, batch, n_kt), kThreads,
                   Layout<D>::kDkvBytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      lse2, dsum, (bf16*)dk, (bf16*)dv, st[0], st[1], st[2], st[3], st[5],
      st[6], dm, heads, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_tc

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients alike).
// form: 0 = CUDA-core, 1 = tensor-core (bf16, head_dim 64, 96 or 128, every
// row 16-byte aligned).  strides: 21 int64 values, (b, h, s) in elements for
// q, k, v, dout, dq, dk, dv (the last dimension contiguous).  stats: f32
// scratch of 2 * batch * heads * sq values (the rows' log-sum-exp and
// rowsum(dP P)).  window: 0 = none.  The same visibility as
// flash_attention_fwd, which the wrapper has checked (every row sees a
// column).  Launches the dQ pass, then the dK/dV pass.  Returns a
// cudaError_t code: 0 on successful launches.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv,
                        void* stats, const int64_t* strides, int batch,
                        int heads, int sq, int kv_heads, int sk, int kv_len,
                        int q_offset, int causal, int window, float scale,
                        int head_dim, int dtype, int form, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || kv_len <= 0 || kv_len > sk || q_offset < 0 ||
      window < 0 || batch > 65535 || heads > 65535 ||
      (sq + 63) / 64 > 65535 || (sk + 63) / 64 > 65535 || form < 0 ||
      form > 1) {
    return (int)cudaErrorInvalidValue;
  }
  using flash::Strides;
  const Strides st[7] = {
      {strides[0], strides[1], strides[2]},
      {strides[3], strides[4], strides[5]},
      {strides[6], strides[7], strides[8]},
      {strides[9], strides[10], strides[11]},
      {strides[12], strides[13], strides[14]},
      {strides[15], strides[16], strides[17]},
      {strides[18], strides[19], strides[20]}};
  const flash_bwd::Dims dm{sq, sk, heads / kv_heads, kv_len, q_offset,
                           causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  float* f = (float*)stats;
  if (form == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
#define BWD_TC(D)                                                          \
  return flash_bwd_tc::launch<D>(q, k, v, dout, dq, dk, dv, f, st, batch,  \
                                 heads, kv_heads, dm, scale, s)
    if (head_dim == 64) BWD_TC(64);
    if (head_dim == 96) BWD_TC(96);
    if (head_dim == 128) BWD_TC(128);
#undef BWD_TC
    return (int)cudaErrorInvalidValue;
  }
#define BWD_SIMT(T, D)                                                     \
  return flash_bwd_simt::launch<T, D>(q, k, v, dout, dq, dk, dv, f, st,    \
                                      batch, heads, kv_heads, dm, scale, s)
#define BWD_DIMS(T)                              \
  switch (head_dim) {                            \
    case 8: BWD_SIMT(T, 8);                      \
    case 16: BWD_SIMT(T, 16);                    \
    case 32: BWD_SIMT(T, 32);                    \
    case 64: BWD_SIMT(T, 64);                    \
    case 96: BWD_SIMT(T, 96);                    \
    case 128: BWD_SIMT(T, 128);                  \
    default: return (int)cudaErrorInvalidValue;  \
  }
  if (dtype == 0) BWD_DIMS(float);
  if (dtype == 1) BWD_DIMS(flash::bf16);
#undef BWD_DIMS
#undef BWD_SIMT
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
