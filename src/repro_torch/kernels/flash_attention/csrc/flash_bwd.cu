// Flash-attention backward for NVIDIA Hopper (sm_90a).  Built with nvcc
// into a shared library of its own with a plain C interface and loaded with
// ctypes (kernels/build.py, kernels/flash_attention/flash_attention.py);
// it shares flash_common.cuh and the f32 forms' 3xTF32 tiles
// (flash_tf32.cuh) with the forward (flash_attention.cu, flash_tc.cuh,
// flash_split.cuh, flash_tc_f32.cuh), whose tensor-core forms write the
// log-sum-exp that the tensor-core forms here read.
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
// Two deterministic passes, no float atomics (two launches give the same
// bits); a kv head's dK and dV sum its q heads in a fixed order:
//   dQ pass     one block per (q tile, head, batch), dQ of its rows.
//   dK/dV pass  one block per (kv head, KV tile, batch).  It loops over the
//               q heads that share the kv head and, for each, over the q
//               rows that see the tile, in a fixed order.
// Both passes skip tiles wholly masked (the causal stream stops at the
// diagonal; a window starts at its band's edge).
//
// Three forms; the wrapper picks one (flash_attention.py::backward_form):
//   tensor-core  bf16, D in {64, 96, 128}, 16-byte-aligned rows.  P comes
//                from the forward's log-sum-exp (flash_tc.cuh and the
//                split-KV merge write it under autograd), rowsum(dP P) as
//                Delta_i = dO_i . (O_i + O_lo_i), the forward's output and
//                its bf16 rounding residual (O to ~16 bits: from a bf16 O
//                alone a row that sees few columns, whose dq cancels, loses
//                its gradient), which the dQ pass computes in its prologue
//                (f32 scratch [B, H, Sq] for the dK/dV pass).  Streamed
//                tiles (K, V in the dQ pass; Q, dO, the log-sum-exp and
//                Delta in the dK/dV pass) go through a ring of two
//                shared-memory stages by cp.async, the next tile's copy
//                overlapping this tile's products.  mma.sync m16n8k16 with
//                f32 accumulation, ldmatrix; each warp owns 16 rows (Cfg).
//                P and dS are rounded to bf16 as the A operands of P^T dO,
//                dS K and dS^T Q, as in FlashAttention-2; S, dP, Delta and
//                every sum stay f32.  dK/dV-pass warps own kv rows and
//                compute S^T = K Q^T and dP^T = V dO^T, so that P^T and
//                dS^T are already the A operands.  6 D operations a visible
//                pair in the dQ pass, 8 D in the dK/dV pass.
//   tensor-core f32  f32, D in {64, 96, 128}, 16-byte-aligned rows, more
//                than 16 q rows per kv head (the forward's tensor-core f32
//                form, flash_tc_f32.cuh, wrote the log-sum-exp m + ln l in
//                natural units).  The same two passes and ring with 3xTF32
//                products (kernels/csrc/tf32x3.cuh: each f32 operand in a
//                TF32 high and low part, three mma a product, f32 sums), at
//                the f32 gates; P, dS, S and dP stay f32, and P and dS are
//                split in registers as A operands (the k-step's columns
//                taken in the order 0, 2, 4, 6, 1, 3, 5, 7, so that the C
//                fragment is the A fragment).  No rounding residual: Delta0
//                = dO . O in f32 in the dQ pass's prologue, corrected to the
//                products' own rowsum(dP P) and to the softmax normalised by
//                its own row sum (both summed in f64) by one TF32 product P
//                K (see dq_kernel).  6 D operations a pair (3xTF32) and 2 D
//                (one TF32 product) in the dQ pass, 8 D in the dK/dV pass.
//                The tiles and products are flash_tf32.cuh's, shared with the
//                forward; each tile's products are summed in fresh registers
//                and then added in f32, since the tensor core rounds its own
//                sums toward zero (a 768-mma chain into dK or dQ drifted
//                2.7e-5 of the gradient's largest value at the train shape).
//   CUDA-core    everything else (f32 at D 8-32, unaligned or at most 16 q
//                rows per kv head; bf16 at D 8-32 or unaligned): f32 FMAs
//                on register tiles of 4 x 4 over f32 shared memory
//                (kernels/csrc/f32_tile.cuh, shared with B5's backward).  No
//                log-sum-exp from the forward: a first stage of the dQ pass
//                streams the visible KV tiles for each row's max, sum and
//                rowsum(dP P) (online) into f32 scratch [2, B, H, Sq], the
//                second streams them again for dQ (18 D a pair).
//
// What bounds it on the card: P recomputed and dV, dP, dQ, dK, 10 D
// operations per visible pair (2.5x the forward's), at the bf16 tensor-core
// rate for the train shape (zamba2-1.2b: Sq = Sk = 2048, D 64): operations.
// In f32 the bound is the CUDA cores' f32 rate, or 3x the operations at
// the TF32 rate for 3xTF32 products.
// The tensor-core form does 14 D a pair (P and dP in both passes), down from
// 18 D with a statistics stage, at about the forward's tensor-core rate (its
// mma.sync tiles of 16 rows a warp re-read each B operand from shared memory
// for every warp; wgmma's 64-row warpgroup tiles, read once a warpgroup, are
// the next step for the forward and this form alike).

#include "f32_tile.cuh"
#include "flash_common.cuh"
#include "flash_tf32.cuh"

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

// The KV tiles of `width` columns [first, end) that rows [r0, r1] of a q
// tile see.
__device__ __forceinline__ void kv_tiles(const Dims& d, int r0, int r1,
                                         int width, int& first, int& end) {
  const int vis = d.causal ? min(d.kv_len, d.q_offset + r1 + 1) : d.kv_len;
  end = (vis + width - 1) / width;
  first = d.window > 0 ? max(0, d.q_offset + r0 - d.window + 1) / width : 0;
}

// The q rows [lo, hi) that see some column of the `width` kv rows at j0.
__device__ __forceinline__ void q_rows(const Dims& d, int j0, int width,
                                       int& lo, int& hi) {
  const int jmax = min(j0 + width, d.kv_len) - 1;
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
  flash_bwd::kv_tiles(dm, q0, min(q0 + kBlock, dm.sq) - 1, kBlock, first,
                      end);

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
  flash_bwd::q_rows(dm, j0, kBlock, lo, hi);

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

// --- tensor-core form -------------------------------------------------------

namespace flash_bwd_tc {

using namespace flash;
using flash_bwd::Dims;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Tiles a block works on (tools/bwd_variants.sh times the alternatives).
// A warp may own MT m-tiles of 16 rows, each B fragment read from shared
// memory then feeding MT mma; at D 64 two m-tiles a warp measured slower
// than one (their 233-255 registers leave 8 warps an SM), so both passes
// take one.  At D 96 and 128 the dK/dV pass streams 32 q rows a step, so
// that S^T and dP^T fit beside the two D-wide accumulators.
template <int D>
struct Cfg {
  static constexpr int kStride = D + 8;             // bf16 a padded row
  // dQ pass: m-tiles a warp, q rows a block, kv rows a streamed tile
  static constexpr int kMTq = 1;
  static constexpr int kRowsQ = 16 * kMTq * kWarps;
  static constexpr int kBN = 64 / kMTq;
  // dK/dV pass: m-tiles a warp, kv rows a block, q rows a streamed step
  static constexpr int kMTk = 1;
  static constexpr int kRowsK = 16 * kMTk * kWarps;
  static constexpr int kQ2 = D > 64 ? 32 : 64;
  static constexpr size_t kDqBytes =
      (2 * (size_t)kRowsQ + 4 * (size_t)kBN) * kStride * sizeof(bf16) +
      kRowsQ * sizeof(float);
  static constexpr size_t kDkvBytes =
      (2 * (size_t)kRowsK + 4 * (size_t)kQ2) * kStride * sizeof(bf16) +
      4 * kQ2 * sizeof(float);
};

// 4-byte global -> shared copy (zeros with ok = false), for the per-row
// log-sum-exp and Delta, whose rows start at any float.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

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
    cp_async16(smem_u32(dst + r * Cfg<D>::kStride + c * 8), s, ok);
  }
}

// A fragments of the warp's MT m-tiles (from `row`) of a padded tile.
template <int D, int MT>
__device__ __forceinline__ void load_a(uint32_t (&af)[MT][D / 16][4],
                                       const bf16* tile, int row, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int r = row + 16 * m + mr + (mi & 1) * 8;
      ldmatrix_x4(af[m][kk], smem_u32(tile + r * Cfg<D>::kStride + kk * 16 +
                                      (mi >> 1) * 8));
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&s)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      s[m][i][0] = s[m][i][1] = s[m][i][2] = s[m][i][3] = 0.0f;
    }
  }
}

// s[MT][NT] = A B^T: A the warp's fragments, B the first 8 NT rows of a
// padded tile; each B fragment feeds every m-tile.
template <int D, int MT, int NT>
__device__ __forceinline__ void abt(float (&s)[MT][NT][4],
                                    const uint32_t (&af)[MT][D / 16][4],
                                    const bf16* bt, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  zero(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bfr[4];
      const int r = n2 * 16 + mr + (mi >> 1) * 8;
      ldmatrix_x4(bfr, smem_u32(bt + r * Cfg<D>::kStride + kk * 16 +
                                (mi & 1) * 8));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * n2], af[m][kk], bfr[0], bfr[1]);
        mma_bf16(s[m][2 * n2 + 1], af[m][kk], bfr[2], bfr[3]);
      }
    }
  }
}

// The same with A's fragments read from its shared tile (rows from `row`)
// a k-step at a time: the dK/dV pass keeps its registers for dK and dV.
template <int D, int MT, int NT>
__device__ __forceinline__ void abt_smem(float (&s)[MT][NT][4],
                                         const bf16* at, int row,
                                         const bf16* bt, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
  zero(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = row + 16 * m + mr + (mi & 1) * 8;
      ldmatrix_x4(af[m], smem_u32(at + r * Cfg<D>::kStride + kk * 16 +
                                  (mi >> 1) * 8));
    }
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bfr[4];
      const int r = n2 * 16 + mr + (mi >> 1) * 8;
      ldmatrix_x4(bfr, smem_u32(bt + r * Cfg<D>::kStride + kk * 16 +
                                (mi & 1) * 8));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(s[m][2 * n2], af[m], bfr[0], bfr[1]);
        mma_bf16(s[m][2 * n2 + 1], af[m], bfr[2], bfr[3]);
      }
    }
  }
}

// acc[MT][16 x D] += P B: P [16 x 8 NT] a m-tile in the accumulator layout,
// rounded to bf16 as the A operand; B the first 8 NT rows of a padded tile
// (ldmatrix.trans), each fragment feeding every m-tile.
template <int D, int MT, int NT>
__device__ __forceinline__ void pb(float (&acc)[MT][D / 8][4],
                                   const float (&p)[MT][NT][4],
                                   const bf16* bt, int lane) {
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][0] = pack_bf16(p[m][2 * kk][0], p[m][2 * kk][1]);
      a[m][1] = pack_bf16(p[m][2 * kk][2], p[m][2 * kk][3]);
      a[m][2] = pack_bf16(p[m][2 * kk + 1][0], p[m][2 * kk + 1][1]);
      a[m][3] = pack_bf16(p[m][2 * kk + 1][2], p[m][2 * kk + 1][3]);
    }
#pragma unroll
    for (int d2 = 0; d2 < D / 16; ++d2) {
      uint32_t bfr[4];
      const int r = kk * 16 + mr + (mi & 1) * 8;
      ldmatrix_x4_trans(bfr, smem_u32(bt + r * Cfg<D>::kStride + d2 * 16 +
                                      (mi >> 1) * 8));
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_bf16(acc[m][2 * d2], a[m], bfr[0], bfr[1]);
        mma_bf16(acc[m][2 * d2 + 1], a[m], bfr[2], bfr[3]);
      }
    }
  }
}

// The warp's 16 rows (from `row`) of a 16 x D accumulator, times `mul`, as
// bf16.
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

// dQ pass: one block per (head, batch, tile of kRows q rows), long rows
// first.  Prologue: Delta_i = dO_i . (O_i + O_lo_i) (f32, from the dO tile
// and the forward's O and its rounding residual) to shared memory and to
// the [B, H, Sq] scratch the dK/dV pass reads; the forward's log-sum-exp
// per row into registers (log2 units).  Then the
// visible KV tiles stream through a ring of two stages (cp.async; tile t + 1
// lands while tile t's products run): S = Q K^T, dP = dO V^T, dS = P (dP -
// Delta) with P = 2^(scale log2(e) s - lse2), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const bf16* __restrict__ o, const bf16* __restrict__ o_lo,
          const float* __restrict__ lse, bf16* __restrict__ dq,
          float* __restrict__ dsum, Strides sq_,
          Strides sk_, Strides sv_, Strides so_, Strides sO_, Strides sdq_,
          Dims dm, float scale_log2, float scale) {
  using C = Cfg<D>;
  constexpr int MT = C::kMTq, kRows = C::kRowsQ, kBN = C::kBN, NT = kBN / 8;
  constexpr int kStride = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kStride]
  bf16* dos = qs + kRows * kStride;               // [kRows][kStride]
  bf16* ks = dos + kRows * kStride;               // [2][kBN][kStride]
  bf16* vs = ks + 2 * kBN * kStride;              // [2][kBN][kStride]
  float* dsum_s = reinterpret_cast<float*>(vs + 2 * kBN * kStride);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // long rows first
  const int hk = h / dm.group;
  const bf16* kp = k + b * sk_.b + hk * sk_.h;
  const bf16* vp = v + b * sv_.b + hk * sv_.h;
  const int64_t row_stats = ((int64_t)b * gridDim.x + h) * dm.sq;
  load_rows<D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, dm.sq, kRows);
  load_rows<D>(dos, dout + b * so_.b + h * so_.h, so_.s, q0, dm.sq, kRows);
  cp_async_commit();
  int first, end;
  flash_bwd::kv_tiles(dm, q0, min(q0 + kRows, dm.sq) - 1, kBN, first, end);
  if (first < end) {
    load_rows<D>(ks, kp, sk_.s, first * kBN, dm.kv_len, kBN);
    load_rows<D>(vs, vp, sv_.s, first * kBN, dm.kv_len, kBN);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  {
    constexpr int kTPR = kThreads / kRows;  // threads a row: 1 or 2
    constexpr int kPer = D / kTPR;
    const int r = threadIdx.x / kTPR, part = threadIdx.x % kTPR;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < dm.sq) {
      const int64_t at = b * sO_.b + h * sO_.h + row * sO_.s + part * kPer;
      const bf16* drow = dos + r * kStride + part * kPer;
#pragma unroll
      for (int c = 0; c < kPer; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 lv = *reinterpret_cast<const uint4*>(o_lo + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lv);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 of = __bfloat1622float2(o2[u]);
          const float2 lf = __bfloat1622float2(l2[u]);
          const float2 df = __bfloat1622float2(d2[u]);
          acc = fmaf(of.x + lf.x, df.x, acc);
          acc = fmaf(of.y + lf.y, df.y, acc);
        }
      }
    }
    if (kTPR == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      dsum_s[r] = acc;
      if (row < dm.sq) dsum[row_stats + row] = acc;
    }
  }
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16 * MT;  // the warp's first row in the tile
  const int row_lo = q0 + wrow;
  float lse_r[MT][2], dsum_r[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int rr = wrow + 16 * m + g + 8 * j;
      // a row past Sq: zero Q and dO rows and Delta 0 make dS 0
      lse_r[m][j] = q0 + rr < dm.sq ? lse[row_stats + q0 + rr] * kLog2e : 0.0f;
      dsum_r[m][j] = dsum_s[rr];
    }
  }
  uint32_t qf[MT][D / 16][4], df[MT][D / 16][4];
  load_a<D, MT>(qf, qs, wrow, lane);
  load_a<D, MT>(df, dos, wrow, lane);
  float acc[MT][D / 8][4];
  zero(acc);
  for (int tile = first; tile < end; ++tile) {
    const int st = (tile - first) & 1;
    if (tile + 1 < end) {
      load_rows<D>(ks + (st ^ 1) * kBN * kStride, kp, sk_.s, (tile + 1) * kBN,
                   dm.kv_len, kBN);
      load_rows<D>(vs + (st ^ 1) * kBN * kStride, vp, sv_.s, (tile + 1) * kBN,
                   dm.kv_len, kBN);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile
    __syncthreads();
    const bf16* kt = ks + st * kBN * kStride;
    const bf16* vt = vs + st * kBN * kStride;
    float s[MT][NT][4], dp[MT][NT][4];
    abt<D, MT, NT>(s, qf, kt, lane);
    abt<D, MT, NT>(dp, df, vt, lane);
    const int j0 = tile * kBN;
    // some (row, column) of the warp's rows x this tile is masked
    const bool mask =
        j0 + kBN > dm.kv_len ||
        (dm.causal && j0 + kBN - 1 > dm.q_offset + row_lo) ||
        (dm.window > 0 && j0 <= dm.q_offset + row_lo + 16 * MT - 1 - dm.window);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = !mask || flash_bwd::visible(
                                       dm, row_lo + 16 * m + g + (e >> 1) * 8,
                                       j0 + i * 8 + 2 * tq + (e & 1));
          const float p =
              ok ? fast_exp2(s[m][i][e] * scale_log2 - lse_r[m][e >> 1]) : 0.0f;
          s[m][i][e] = p * (dp[m][i][e] - dsum_r[m][e >> 1]);
        }
      }
    }
    pb<D, MT, NT>(acc, s, kt, lane);
    __syncthreads();  // every warp is done with this stage: it is refilled next
  }
  cp_async_wait<0>();
  bf16* dqp = dq + b * sdq_.b + h * sdq_.h;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    store_rows<D>(dqp, sdq_.s, row_lo + 16 * m, dm.sq, acc[m], scale, lane);
  }
}

// dK/dV pass: one block per (kv head, batch, tile of kRows kv rows).  K and
// V stay in shared memory; the q rows that see the tile, of every q head of
// the kv head in order, stream in steps of kQ2 through a ring of two stages
// (Q, dO, the log-sum-exp and Delta by cp.async; step s + 1 lands while
// step s's products run).  Each warp computes S^T = K Q^T and dP^T = V dO^T
// for its kv rows, so that P^T and dS^T are already the A operands of dV +=
// P^T dO and dK += dS^T Q; dK and dV stay in registers across the steps.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq_,
            Strides sk_, Strides sv_, Strides so_, Strides sdk_,
            Strides sdv_, Dims dm, int heads, float scale_log2,
            float scale) {
  using C = Cfg<D>;
  constexpr int MT = C::kMTk, kRows = C::kRowsK, kQ2 = C::kQ2, NT = kQ2 / 8;
  constexpr int kStride = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kStride]
  bf16* vs = ks + kRows * kStride;                // [kRows][kStride]
  bf16* qs = vs + kRows * kStride;                // [2][kQ2][kStride]
  bf16* dos = qs + 2 * kQ2 * kStride;             // [2][kQ2][kStride]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kQ2 * kStride);  // [2][kQ2]
  float* dsum_s = lse_s + 2 * kQ2;                                   // [2][kQ2]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kRows;
  load_rows<D>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, j0, dm.sk, kRows);
  load_rows<D>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, j0, dm.sk, kRows);
  cp_async_commit();
  int lo, hi;
  flash_bwd::q_rows(dm, j0, kRows, lo, hi);
  const int lo0 = lo / kQ2 * kQ2;
  const int per_head = hi > lo ? (hi - lo0 + kQ2 - 1) / kQ2 : 0;
  const int steps = per_head * dm.group;

  // step s: q head hk * group + s / per_head, rows from lo0 + (s % per_head)
  // kQ2, into stage s % 2
  auto issue = [&](int s) {
    const int h = hk * dm.group + s / per_head;
    const int i0 = lo0 + (s % per_head) * kQ2, st = s & 1;
    load_rows<D>(qs + st * kQ2 * kStride, q + b * sq_.b + h * sq_.h, sq_.s,
                 i0, dm.sq, kQ2);
    load_rows<D>(dos + st * kQ2 * kStride, dout + b * so_.b + h * so_.h,
                 so_.s, i0, dm.sq, kQ2);
    if (threadIdx.x < 2 * kQ2) {
      // rows past Sq: log-sum-exp and Delta 0 with zero Q and dO rows add 0
      const int r = threadIdx.x % kQ2, which = threadIdx.x / kQ2;
      const bool ok = i0 + r < dm.sq;
      const float* src = (which ? dsum : lse) +
                         (ok ? ((int64_t)b * heads + h) * dm.sq + i0 + r : 0);
      cp_async4(smem_u32((which ? dsum_s : lse_s) + st * kQ2 + r), src, ok);
    }
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16 * MT;  // the warp's first kv row in the tile
  const int col_lo = j0 + wrow;
  float dka[MT][D / 8][4], dva[MT][D / 8][4];
  zero(dka);
  zero(dva);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step (and K, V)
    __syncthreads();
    const int st = s & 1, i0 = lo0 + (s % per_head) * kQ2;
    const bf16* qt = qs + st * kQ2 * kStride;
    const bf16* dt = dos + st * kQ2 * kStride;
    const float* ls = lse_s + st * kQ2;
    const float* dsv = dsum_s + st * kQ2;
    // S^T: kv rows g, g + 8 of each m-tile, q columns 8 i + 2 tq + (e & 1)
    float sT[MT][NT][4], dpT[MT][NT][4];
    abt_smem<D, MT, NT>(sT, ks, wrow, qt, lane);
    const bool mask =
        col_lo + 16 * MT > dm.kv_len ||
        (dm.causal && col_lo + 16 * MT - 1 > dm.q_offset + i0) ||
        (dm.window > 0 && col_lo <= dm.q_offset + i0 + kQ2 - 1 - dm.window);
    float nl[NT][2];
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      nl[i][0] = ls[8 * i + 2 * tq] * kLog2e;
      nl[i][1] = ls[8 * i + 2 * tq + 1] * kLog2e;
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok =
              !mask || flash_bwd::visible(dm, i0 + i * 8 + 2 * tq + (e & 1),
                                          col_lo + 16 * m + g + (e >> 1) * 8);
          sT[m][i][e] =
              ok ? fast_exp2(sT[m][i][e] * scale_log2 - nl[i][e & 1]) : 0.0f;
        }
      }
    }
    abt_smem<D, MT, NT>(dpT, vs, wrow, dt, lane);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dpT[m][i][e] =
              sT[m][i][e] * (dpT[m][i][e] - dsv[8 * i + 2 * tq + (e & 1)]);
        }
      }
    }
    pb<D, MT, NT>(dva, sT, dt, lane);
    pb<D, MT, NT>(dka, dpT, qt, lane);
    __syncthreads();  // every warp is done with this stage: it is refilled next
  }
  cp_async_wait<0>();  // K and V, when no q row sees the tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    store_rows<D>(dk + b * sdk_.b + hk * sdk_.h, sdk_.s, col_lo + 16 * m,
                  dm.sk, dka[m], scale, lane);
    store_rows<D>(dv + b * sdv_.b + hk * sdv_.h, sdv_.s, col_lo + 16 * m,
                  dm.sk, dva[m], 1.0f, lane);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* o, const void* o_lo, const float* lse, void* dq,
           void* dk, void* dv,
           float* dsum, const Strides (&st)[8], int batch, int heads,
           int kv_heads, const Dims& dm, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  // once per template instance, not per launch
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kDqBytes);
  if (a1 != cudaSuccess) return (int)a1;
  static const cudaError_t a2 = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kDkvBytes);
  if (a2 != cudaSuccess) return (int)a2;
  const int n_qt = (dm.sq + C::kRowsQ - 1) / C::kRowsQ;
  const int n_kt = (dm.sk + C::kRowsK - 1) / C::kRowsK;
  const float scale_log2 = scale * kLog2e;
  dq_kernel<D><<<dim3(heads, batch, n_qt), kThreads, C::kDqBytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const bf16*)o, (const bf16*)o_lo, lse, (bf16*)dq, dsum, st[0], st[1],
      st[2], st[3],
      st[4], st[5], dm, scale_log2, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<dim3(kv_heads, batch, n_kt), kThreads, C::kDkvBytes,
                   stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      dsum, (bf16*)dk, (bf16*)dv, st[0], st[1], st[2], st[3], st[6], st[7],
      dm, heads, scale_log2, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_tc

// --- tensor-core f32 form (3xTF32) -----------------------------------------

namespace flash_bwd_tf32 {

using namespace flash;
using flash_bwd::Dims;
using flash_bwd_tc::cp_async4;
using flash_tf32::abt;
using flash_tf32::kThreads;
using flash_tf32::load_rows;
using flash_tf32::pb;
using flash_tf32::zero;

// q rows (dQ pass) or kv rows (dK/dV pass) a block: 16 a warp
constexpr int kRows = kThreads / 2;

// kBN is a streamed tile's rows (kv rows in the dQ pass, q rows in the
// dK/dV pass), cut at D 96 and 128 so that two blocks fit an SM and the two
// D-wide f32 accumulators stay in registers beside S and dP.  The dQ pass
// keeps each row's Delta0 and log-sum-exp, and each thread's f64 sums, in
// shared memory: held in registers across the KV stream they spill at D 64
// (ptxas -v, sm_90a).  Its D 128 instance spills 12 bytes (255 registers)
// either way: kBN 16 is the least tile that abt takes.
template <int D>
struct Cfg {
  static constexpr int kStride = flash_tf32::kRowFloats<D>;
  static constexpr int kBN = D == 64 ? 64 : D == 96 ? 32 : 16;
  static constexpr size_t kDqBytes =
      ((2 * kRows + 4 * kBN) * (size_t)kStride + 2 * kRows) * sizeof(float) +
      4 * kThreads * sizeof(double);
  static constexpr size_t kDkvBytes =
      ((2 * kRows + 4 * kBN) * (size_t)kStride + 4 * kBN) * sizeof(float);
};

// The warp's 16 rows (from `row`) of a 16 x D accumulator, times `mul`.
template <int D>
__device__ __forceinline__ void store_rows(float* out, int64_t stride,
                                           int row, int rows,
                                           const float (&acc)[D / 32][4][4],
                                           float mul, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int r = row + g + 8 * j;
    if (r >= rows) continue;
    float* o = out + r * stride + 2 * tq;
#pragma unroll
    for (int x = 0; x < D / 32; ++x) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float2*>(o + (4 * x + i) * 8) = make_float2(
            acc[x][i][2 * j] * mul, acc[x][i][2 * j + 1] * mul);
      }
    }
  }
}

// dQ pass: one block per (head, batch, tile of kRows q rows), long rows
// first.  Prologue: Delta0_i = dO_i . O_i (f32, the dO tile and the
// forward's O).  Then the visible KV tiles stream through a ring of two
// stages (cp.async; tile t + 1 lands while tile t's products run): S = Q K^T
// and dP = dO V^T, P = e^(scale s - lse) from the forward's log-sum-exp, dS0
// = P (dP - Delta0), dQ0 += dS0 K; beside them, in f64, L_i = sum_j P_ij
// and Delta1_i = sum_j P_ij dP_ij (the products' own sums), and B += hi(P)
// hi(K), one TF32 product.  The result is
//   dQ = scale (dQ0 + (Delta0 - Delta1 / L) B) / L,
// which is scale dS K with the softmax normalised by its own row sum: dS =
// (P / L) (dP - Delta1 / L).  Both sums matter where a row's softmax is
// sharp (|S| ~ 20), since dQ is then a difference of nearly equal terms:
// the log-sum-exp, an f32 of ~20, is good to ~1e-6, so L is 1 + ~1e-6, and
// P taken as normalised leaves dq ~1e-6 |Delta| |K| away (4.8e-3 of the row
// floor of the f32 row gate, BWD_ROW_TOL 5e-4, on the card); Delta1 or L
// rounded to f32 leaves a few 1e-8 of |Delta| |K|, the plain f32 version's
// own error there (1.2e-3 against its f64 evaluation).  Delta0 differs
// from Delta1 / L by ~1e-6 of |dO| |O|; B's TF32 error enters only times
// that difference.  Delta1 goes to the [B, H, Sq] scratch for the dK/dV
// pass (unnormalised, as the P that pass recomputes).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ o, const float* __restrict__ lse,
          float* __restrict__ dq, float* __restrict__ dsum, Strides sq_,
          Strides sk_, Strides sv_, Strides so_, Strides sO_, Strides sdq_,
          Dims dm, float scale) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, NT = kBN / 8, kStride = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRows][kStride]
  float* dos = qs + kRows * kStride;                // [kRows][kStride]
  float* ks = dos + kRows * kStride;                // [2][kBN][kStride]
  float* vs = ks + 2 * kBN * kStride;               // [2][kBN][kStride]
  float* d0_s = vs + 2 * kBN * kStride;             // [kRows]
  float* lse_s = d0_s + kRows;                      // [kRows]
  // [kThreads][4]: the thread's Delta1 and L of its rows g and g + 8
  double* sums = reinterpret_cast<double*>(lse_s + kRows) + 4 * threadIdx.x;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // long rows first
  // the K and V heads and the rows' statistics, taken again where they are
  // used from kernel arguments and block indices, so that no register holds
  // them across the KV stream
  const int hk = h / dm.group;
  const auto kp = [&] { return k + b * sk_.b + hk * sk_.h; };
  const auto vp = [&] { return v + b * sv_.b + hk * sv_.h; };
  const auto row_stats = [&] { return ((int64_t)b * gridDim.x + h) * dm.sq; };
  load_rows<D>(qs, q + b * sq_.b + h * sq_.h, sq_.s, q0, dm.sq, kRows);
  load_rows<D>(dos, dout + b * so_.b + h * so_.h, so_.s, q0, dm.sq, kRows);
  cp_async_commit();
  int first, end;
  flash_bwd::kv_tiles(dm, q0, min(q0 + kRows, dm.sq) - 1, kBN, first, end);
  if (first < end) {
    load_rows<D>(ks, kp(), sk_.s, first * kBN, dm.kv_len, kBN);
    load_rows<D>(vs, vp(), sv_.s, first * kBN, dm.kv_len, kBN);
  }
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO
  __syncthreads();
  {
    // two threads a row, D / 2 columns each
    const int r = threadIdx.x >> 1, part = threadIdx.x & 1;
    const int row = q0 + r;
    float acc = 0.0f;
    if (row < dm.sq) {
      const float* orow =
          o + b * sO_.b + h * sO_.h + row * sO_.s + part * (D / 2);
      const float* drow = dos + r * kStride + part * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += 4) {
        const float4 ov = *reinterpret_cast<const float4*>(orow + c);
        const float4 dv = *reinterpret_cast<const float4*>(drow + c);
        acc = fmaf(ov.x, dv.x, acc);
        acc = fmaf(ov.y, dv.y, acc);
        acc = fmaf(ov.z, dv.z, acc);
        acc = fmaf(ov.w, dv.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    // a row past Sq: zero Q and dO rows and Delta0 0 make dS0 0
    if (part == 0) d0_s[r] = acc;
    else lse_s[r] = row < dm.sq ? lse[row_stats() + row] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) sums[u] = 0.0;
  __syncthreads();

  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile
  const int row_lo = q0 + wrow;
  float acc[D / 32][4][4], bcc[D / 32][4][4];
  zero<D>(acc);
  zero<D>(bcc);
  for (int tile = first; tile < end; ++tile) {
    const int st = (tile - first) & 1;
    if (tile + 1 < end) {
      load_rows<D>(ks + (st ^ 1) * kBN * kStride, kp(), sk_.s, (tile + 1) * kBN,
                   dm.kv_len, kBN);
      load_rows<D>(vs + (st ^ 1) * kBN * kStride, vp(), sv_.s, (tile + 1) * kBN,
                   dm.kv_len, kBN);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile
    __syncthreads();
    const float* kt = ks + st * kBN * kStride;
    const float* vt = vs + st * kBN * kStride;
    float s[NT][4], dp[NT][4];
    abt<D, NT>(s, qs, wrow, kt, lane);
    abt<D, NT>(dp, dos, wrow, vt, lane);
    const int j0 = tile * kBN;
    // some (row, column) of the warp's rows x this tile is masked
    const bool mask =
        j0 + kBN > dm.kv_len ||
        (dm.causal && j0 + kBN - 1 > dm.q_offset + row_lo) ||
        (dm.window > 0 && j0 <= dm.q_offset + row_lo + 15 - dm.window);
    const float lse_r[2] = {lse_s[wrow + g], lse_s[wrow + g + 8]};
    const float d0_r[2] = {d0_s[wrow + g], d0_s[wrow + g + 8]};
    double d1_t[2] = {0.0, 0.0}, l_t[2] = {0.0, 0.0};  // this tile's
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = !mask || flash_bwd::visible(
                                     dm, row_lo + g + (e >> 1) * 8,
                                     j0 + i * 8 + 2 * tq + (e & 1));
        const float p =
            ok ? fast_exp2((s[i][e] * scale - lse_r[e >> 1]) * kLog2e) : 0.0f;
        d1_t[e >> 1] = fma((double)p, (double)dp[i][e], d1_t[e >> 1]);
        l_t[e >> 1] += (double)p;
        s[i][e] = p;
        dp[i][e] = p * (dp[i][e] - d0_r[e >> 1]);
      }
    }
    sums[0] += d1_t[0];
    sums[1] += d1_t[1];
    sums[2] += l_t[0];
    sums[3] += l_t[1];
    pb<D, NT, true>(acc, dp, bcc, s, kt, lane);
    __syncthreads();  // every warp is done with this stage: it is refilled next
  }
  cp_async_wait<0>();
  double d1_r[2] = {sums[0], sums[1]}, l_r[2] = {sums[2], sums[3]};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    d1_r[j] += __shfl_xor_sync(0xffffffffu, d1_r[j], 1);
    d1_r[j] += __shfl_xor_sync(0xffffffffu, d1_r[j], 2);
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 1);
    l_r[j] += __shfl_xor_sync(0xffffffffu, l_r[j], 2);
  }
  // 1 / L and Delta0 - Delta1 / L = (Delta0 L - Delta1) / L, the difference
  // in f64 and the rest in f32 (each good to a few 1e-8 of itself; an f64
  // division is a call, which spills).  A row past Sq may see no column: it
  // is not stored.
  float c_r[2], r_r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    r_r[j] = __fdividef(1.0f, (float)l_r[j]);
    c_r[j] = (float)fma((double)d0_s[wrow + g + 8 * j], l_r[j], -d1_r[j]) *
             r_r[j];
  }
#pragma unroll
  for (int x = 0; x < D / 32; ++x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[x][i][e] = fmaf(c_r[e >> 1], bcc[x][i][e], acc[x][i][e]) *
                       r_r[e >> 1];
      }
    }
  }
  store_rows<D>(dq + b * sdq_.b + h * sdq_.h, sdq_.s, row_lo, dm.sq, acc,
                scale, lane);
  if (tq == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row_lo + g + 8 * j;
      if (row < dm.sq) dsum[row_stats() + row] = (float)d1_r[j];
    }
  }
}

// dK/dV pass: one block per (kv head, batch, tile of kRows kv rows).  K and
// V stay in shared memory; the q rows that see the tile, of every q head of
// the kv head in order, stream in steps of kBN through a ring of two stages
// (Q, dO, the log-sum-exp and Delta1 by cp.async; step s + 1 lands while
// step s's products run).  Each warp computes S^T = K Q^T and dP^T = V dO^T
// for its kv rows, so that P^T and dS^T are already the A operands of dV +=
// P^T dO and dK += dS^T Q; dK and dV stay in registers across the steps.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            float* __restrict__ dk, float* __restrict__ dv, Strides sq_,
            Strides sk_, Strides sv_, Strides so_, Strides sdk_,
            Strides sdv_, Dims dm, int heads, float scale) {
  using C = Cfg<D>;
  constexpr int kQ2 = C::kBN, NT = kQ2 / 8, kStride = C::kStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kRows][kStride]
  float* vs = ks + kRows * kStride;                 // [kRows][kStride]
  float* qs = vs + kRows * kStride;                 // [2][kQ2][kStride]
  float* dos = qs + 2 * kQ2 * kStride;              // [2][kQ2][kStride]
  float* lse_s = dos + 2 * kQ2 * kStride;           // [2][kQ2]
  float* dsum_s = lse_s + 2 * kQ2;                  // [2][kQ2]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hk = blockIdx.x, b = blockIdx.y, j0 = blockIdx.z * kRows;
  load_rows<D>(ks, k + b * sk_.b + hk * sk_.h, sk_.s, j0, dm.sk, kRows);
  load_rows<D>(vs, v + b * sv_.b + hk * sv_.h, sv_.s, j0, dm.sk, kRows);
  cp_async_commit();
  int lo, hi;
  flash_bwd::q_rows(dm, j0, kRows, lo, hi);
  const int lo0 = lo / kQ2 * kQ2;
  const int per_head = hi > lo ? (hi - lo0 + kQ2 - 1) / kQ2 : 0;
  const int steps = per_head * dm.group;

  // step s: q head hk * group + s / per_head, rows from lo0 + (s % per_head)
  // kQ2, into stage s % 2
  auto issue = [&](int s) {
    const int h = hk * dm.group + s / per_head;
    const int i0 = lo0 + (s % per_head) * kQ2, st = s & 1;
    load_rows<D>(qs + st * kQ2 * kStride, q + b * sq_.b + h * sq_.h, sq_.s,
                 i0, dm.sq, kQ2);
    load_rows<D>(dos + st * kQ2 * kStride, dout + b * so_.b + h * so_.h,
                 so_.s, i0, dm.sq, kQ2);
    if (threadIdx.x < 2 * kQ2) {
      // rows past Sq: log-sum-exp and Delta 0 with zero Q and dO rows add 0
      const int r = threadIdx.x % kQ2, which = threadIdx.x / kQ2;
      const bool ok = i0 + r < dm.sq;
      const float* src = (which ? dsum : lse) +
                         (ok ? ((int64_t)b * heads + h) * dm.sq + i0 + r : 0);
      cp_async4(smem_u32((which ? dsum_s : lse_s) + st * kQ2 + r), src, ok);
    }
  };
  if (steps > 0) issue(0);
  cp_async_commit();

  const int g = lane >> 2, tq = lane & 3;
  const int wrow = warp * 16;  // the warp's first kv row in the tile
  const int col_lo = j0 + wrow;
  float dka[D / 32][4][4], dva[D / 32][4][4];
  zero<D>(dka);
  zero<D>(dva);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step (and K, V)
    __syncthreads();
    const int st = s & 1, i0 = lo0 + (s % per_head) * kQ2;
    const float* qt = qs + st * kQ2 * kStride;
    const float* dt = dos + st * kQ2 * kStride;
    const float* ls = lse_s + st * kQ2;
    const float* dsv = dsum_s + st * kQ2;
    // S^T: kv rows g, g + 8, q columns 8 i + 2 tq + (e & 1)
    float sT[NT][4], dpT[NT][4];
    abt<D, NT>(sT, ks, wrow, qt, lane);
    const bool mask =
        col_lo + 16 > dm.kv_len ||
        (dm.causal && col_lo + 15 > dm.q_offset + i0) ||
        (dm.window > 0 && col_lo <= dm.q_offset + i0 + kQ2 - 1 - dm.window);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * i + 2 * tq + (e & 1);
        const bool ok =
            !mask || flash_bwd::visible(dm, i0 + c, col_lo + g + (e >> 1) * 8);
        sT[i][e] =
            ok ? fast_exp2((sT[i][e] * scale - ls[c]) * kLog2e) : 0.0f;
      }
    }
    abt<D, NT>(dpT, vs, wrow, dt, lane);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dpT[i][e] = sT[i][e] * (dpT[i][e] - dsv[8 * i + 2 * tq + (e & 1)]);
      }
    }
    pb<D, NT, false>(dva, sT, dva, sT, dt, lane);
    pb<D, NT, false>(dka, dpT, dka, dpT, qt, lane);
    __syncthreads();  // every warp is done with this stage: it is refilled next
  }
  cp_async_wait<0>();  // K and V, when no q row sees the tile
  store_rows<D>(dk + b * sdk_.b + hk * sdk_.h, sdk_.s, col_lo, dm.sk, dka,
                scale, lane);
  store_rows<D>(dv + b * sdv_.b + hk * sdv_.h, sdv_.s, col_lo, dm.sk, dva,
                1.0f, lane);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* o, const float* lse, void* dq, void* dk, void* dv,
           float* dsum, const Strides (&st)[8], int batch, int heads,
           int kv_heads, const Dims& dm, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  // once per template instance, not per launch
  static const cudaError_t a1 = cudaFuncSetAttribute(
      dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kDqBytes);
  if (a1 != cudaSuccess) return (int)a1;
  static const cudaError_t a2 = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kDkvBytes);
  if (a2 != cudaSuccess) return (int)a2;
  const int n_qt = (dm.sq + kRows - 1) / kRows;
  const int n_kt = (dm.sk + kRows - 1) / kRows;
  dq_kernel<D><<<dim3(heads, batch, n_qt), kThreads, C::kDqBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)o, lse, (float*)dq, dsum, st[0], st[1], st[2], st[3],
      st[4], st[5], dm, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<D><<<dim3(kv_heads, batch, n_kt), kThreads, C::kDkvBytes,
                   stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, dsum, (float*)dk, (float*)dv, st[0], st[1], st[2], st[3], st[6],
      st[7], dm, heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_tf32

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the gradients alike).
// form: 0 = CUDA-core, 1 = tensor-core (bf16, head_dim 64, 96 or 128, every
// row 16-byte aligned, o's too), 2 = tensor-core f32 (f32, the same head
// dims and alignment; o and lse given, o_lo null, stats batch * heads * sq
// values: each row's Delta = rowsum(dP P)).  strides: 24 int64 values,
// (b, h, s) in elements for q, k, v, dout, o, dq, dk, dv (the last
// dimension contiguous).  Tensor-core form: o and o_lo (the forward's
// output and its bf16 rounding residual, o's strides) and lse (its f32
// [batch, heads, sq] log-sum-exp) given; stats f32 scratch of batch *
// heads * sq values (each row's Delta = dO . (O + O_lo)).  CUDA-core form:
// o, o_lo and lse unused; stats 2 * batch * heads * sq values (each row's
// log-sum-exp and rowsum(dP P), from its statistics stage).  window: 0 =
// none.  The same visibility as flash_attention_fwd, which the wrapper has
// checked (every row sees a column).  Launches the dQ pass, then the dK/dV
// pass.  Returns a cudaError_t code: 0 on successful launches.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* o, const void* o_lo,
                        const void* lse, void* dq, void* dk, void* dv,
                        void* stats,
                        const int64_t* strides, int batch, int heads, int sq,
                        int kv_heads, int sk, int kv_len, int q_offset,
                        int causal, int window, float scale, int head_dim,
                        int dtype, int form, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || kv_len <= 0 || kv_len > sk || q_offset < 0 ||
      window < 0 || batch > 65535 || heads > 65535 ||
      (sq + 63) / 64 > 65535 || (sk + 63) / 64 > 65535 || form < 0 ||
      form > 2) {
    return (int)cudaErrorInvalidValue;
  }
  using flash::Strides;
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = {strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const flash_bwd::Dims dm{sq, sk, heads / kv_heads, kv_len, q_offset,
                           causal, window};
  cudaStream_t s = (cudaStream_t)stream;
  float* f = (float*)stats;
  if (form == 2) {
    if (dtype != 0 || !o || o_lo || !lse) return (int)cudaErrorInvalidValue;
#define BWD_F32(D)                                                          \
  return flash_bwd_tf32::launch<D>(q, k, v, dout, o, (const float*)lse, dq,  \
                                   dk, dv, f, st, batch, heads, kv_heads,   \
                                   dm, scale, s)
    if (head_dim == 64) BWD_F32(64);
    if (head_dim == 96) BWD_F32(96);
    if (head_dim == 128) BWD_F32(128);
#undef BWD_F32
    return (int)cudaErrorInvalidValue;
  }
  if (form == 1) {
    if (dtype != 1 || !o || !o_lo || !lse) return (int)cudaErrorInvalidValue;
#define BWD_TC(D)                                                          \
  return flash_bwd_tc::launch<D>(q, k, v, dout, o, o_lo, (const float*)lse, \
                                 dq, dk, dv, f, st, batch, heads, kv_heads, \
                                 dm, scale, s)
    if (head_dim == 64) BWD_TC(64);
    if (head_dim == 96) BWD_TC(96);
    if (head_dim == 128) BWD_TC(128);
#undef BWD_TC
    return (int)cudaErrorInvalidValue;
  }
  const Strides ss[7] = {st[0], st[1], st[2], st[3], st[5], st[6], st[7]};
#define BWD_SIMT(T, D)                                                     \
  return flash_bwd_simt::launch<T, D>(q, k, v, dout, dq, dk, dv, f, ss,    \
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
