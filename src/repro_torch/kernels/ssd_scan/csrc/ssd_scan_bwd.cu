// Backward of the Mamba2 SSD chunked scan (kernel B5) for NVIDIA Hopper
// (sm_90a).  Built with nvcc into a shared library of its own with a plain
// C interface and loaded with ctypes (kernels/build.py,
// kernels/ssd_scan/ssd_scan.py); ssd_scan.cu, the forward, is unchanged.
//
// Replaces no Pallas kernel: the TPU's _ssd_kernel has no VJP, and the JAX
// package trains through XLA's autodiff of the jnp scan
// (src/repro/models/ssm.py::ssd_chunked).  On the port's side it replaces
// the gradient in torch ops (the plain scan recomputed and differentiated,
// ~28,000 small kernels a call that the host launches).
//
// The math, per (batch, head) and chunk c of L = 64 steps, with s_i the
// inclusive in-chunk cumsum of la, a_c = e^{s_{L-1}}, w_i = e^{s_{L-1}-s_i},
// H_c the state entering chunk c [N, P] and G_c the gradient of the state
// leaving it:
//   U_c = sum_j w_j b_j x_j^T,  V_c = sum_i e^{s_i} c_i dy_i^T    (chunk-local)
//   H_0 = h0,      H_{c+1} = a_c H_c + U_c                   (forward pass)
//   G_{C-1} = grad_final,  G_{c-1} = a_c G_c + V_c,  dh0 = G_{-1} (reverse)
//   dx_j = sum_{i>=j} (c_i.b_j) e^{s_i-s_j} dy_i + w_j G^T b_j
//   db_j = sum_h [sum_{i>=j} e^{s_i-s_j} (dy_i.x_j) c_i + w_j G x_j]
//   dc_i = sum_h [sum_{j<=i} e^{s_i-s_j} (dy_i.x_j) b_j + e^{s_i} H dy_i]
//   ds_i = sum_{j<=i} A_ij - sum_{k>=i} A_ki + e^{s_i} c_i.(H dy_i)
//          - w_i b_i.(G x_i),  A_ij = (c_i.b_j)(dy_i.x_j) e^{s_i-s_j},
//          plus at i = L-1: a_c <G, H> + sum_j w_j b_j.(G x_j)
//   dla_t = sum_{i>=t} ds_i inside the chunk.
// e^{s_i-s_j} is only evaluated for j <= i, as in the forward.  A ragged last
// chunk is zero-padded (la = 0, x = b = c = dy = 0), which leaves every
// gradient exact: the padded rows' terms vanish and the i = L-1 term lands
// on s_{L-1}, which equals s at the last real step.
//
// Design: chunk-parallel, as the SSD algorithm is.  The state columns are
// cut in blocks of PT = 64 (dH, dx and dy's column p depend only on column
// p; db, dc and ds sum over them).
//   1. incr_kernel, one block per (chunk, batch*head, column block): U_c and
//      V_c, two [N, 64] x [64, PT] products over the chunk, to f32 scratch
//      [B*H, chunks, N, P4] (P4 = P rounded up to 4), and the chunk's
//      s_{L-1} to [B*H, chunks].  8,192 blocks at zamba2-1.2b's train shape.
//   2. pass_kernel, one thread per 4 state elements of a (batch*head):
//      the forward pass rewrites U_c as H_c in place, the reverse pass V_c as
//      G_c (and writes dh0): scale-and-add over [N, P4], bound by memory.
//   3. grad_kernel, one block per (chunk, batch*head, column block): dx and
//      the db, dc and ds partials of the chunk from its H_c and G_c (by
//      cp.async, landing while the chunk's first products run).  No carried
//      state: C B^T e^{s_i-s_j} and (dy x^T) e^{s_i-s_j} go to shared memory,
//      then each output tile is one accumulator: dx = (C B^T e)^T dy +
//      w (B G); dc = M B + e^s (H dy), ds's c.(H dy) read off its first
//      half; db = M^T C + w (G x), ds's b.(G x) likewise.
//   4. reduce_bc_kernel sums the db and dc partials over heads and column
//      blocks, dla_kernel the ds partials over column blocks, then the
//      in-chunk suffix sum; both in a fixed order, so two runs give the same
//      bits (no float atomics anywhere).
// Products run on the tensor cores, warp by warp (mma.sync, 16 rows a warp
// tile), at f32 accuracy: C B^T with bf16 b and c as bf16 m16n8k16 with f32
// sums (exact products); every product with an f32 operand as 3xTF32 (m16n8k8:
// each operand split into a TF32 high part and the rest, hi*hi + hi*lo +
// lo*hi; kernels/csrc/tf32x3.cuh, shared with B4's f32 forms), an operand
// that holds bf16 values taken whole (its low part is zero).  Single TF32
// (10 mantissa bits) would miss the f32 gates.
//
// What bounds it on the card: the backward's multiply-adds, about twice the
// forward's on the same inputs; at f32 on the CUDA cores (67 TFLOP/s) that
// is 0.32 ms at the train shape, as 3xTF32 on the tensor cores (3 x the
// operations at 495 TFLOP/s) 0.13 ms.  The chunk scratch (U/H and V/G, 134
// MB each at the train shape, written, read and rewritten, then read) and
// the db/dc partials make the bytes about 2.3 GB, ~0.7 ms at 3.35 TB/s:
// this design is bound by its scratch's bytes.
//
// Layouts: x, dy [B, S, H, P] (f32 or bf16, both x's type, P contiguous), la
// [B, S, H] f32, b and c [B, S, N] (f32 or bf16, N contiguous), read through
// strides; h0 and grad_final [B, H, N, P] f32 contiguous or null.  Writes dx
// [B, S, H, P] in x's type, dla [B, S, H] f32, db and dc [B, S, N] in b's
// type, dh0 [B, H, N, P] f32 (when h0 is given), all contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "tf32x3.cuh"

namespace ssd_bwd {

using f32_tile::from_f32;
using f32_tile::to_f32;
using tf32x3::mma_tf32;
using tf32x3::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;
constexpr int kMaxN = 128;
constexpr int kPT = 64;               // state columns a block
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Strides {
  int64_t xb, xs, xh;  // x
  int64_t gb, gs, gh;  // dy
  int64_t lb, ls, lh;  // la
  int64_t bb, bs;      // b
  int64_t cb, cs;      // c
};

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// --- tensor-core tiles ----------------------------------------------------

// c[16x8] += a[16x16] b[16x8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats that hold bf16 values as one bf16x2 register (exact), lo in the
// low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element (r, k) of A and (k, n) of B in f32 shared memory: TA = A stored
// as [k][r], TB = B stored as [n][k].
template <bool TA>
__device__ __forceinline__ float ld_a(const float* a, int lda, int r, int k) {
  return TA ? a[k * lda + r] : a[r * lda + k];
}
template <bool TB>
__device__ __forceinline__ float ld_b(const float* b, int ldb, int k, int n) {
  return TB ? b[n * ldb + k] : b[k * ldb + n];
}

// The warp's 16 x 8 NT tile (rows m0.., columns n0..) of acc += A B over
// k0 <= k < k1 (multiples of 8), as 3xTF32; AX / BX: A / B holds bf16
// values, exact in TF32, so its low part is zero and its product skipped.
// Accumulator element e of n-tile j: row m0 + g + 8 (e >> 1), column
// n0 + 8 j + 2 t + (e & 1), with g = lane / 4, t = lane % 4.
// The three products of a k-step go in rounds over the n-tiles, so that
// the mma into one accumulator are NT apart.
template <int NT, bool TA, bool TB, bool AX, bool BX>
__device__ __forceinline__ void warp_mm(float (&acc)[NT][4], const float* a,
                                        int lda, const float* b, int ldb,
                                        int m0, int n0, int k0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = k0; k < k1; k += 8) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    const float av[4] = {
        ld_a<TA>(a, lda, m0 + g, k + t), ld_a<TA>(a, lda, m0 + g + 8, k + t),
        ld_a<TA>(a, lda, m0 + g, k + t + 4),
        ld_a<TA>(a, lda, m0 + g + 8, k + t + 4)};
    float bv[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bv[j][0] = ld_b<TB>(b, ldb, k + t, n0 + 8 * j + g);
      bv[j][1] = ld_b<TB>(b, ldb, k + t + 4, n0 + 8 * j + g);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (AX) {
        ah[i] = __float_as_uint(av[i]);
      } else {
        split_tf32(av[i], ah[i], al[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (BX) {
          bh[j][u] = __float_as_uint(bv[j][u]);
        } else {
          split_tf32(bv[j][u], bh[j][u], bl[j][u]);
        }
      }
    }
    if (!AX) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
    }
    if (!BX) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

// The warp's 16 x 8 NT tile of acc += A B^T over 0 <= k < k1 (a multiple of
// 16), A(r, k) = a[r lda + k], B^T(k, n) = b[n ldb + k], both holding bf16
// values: bf16 m16n8k16, exact products, f32 sums.
template <int NT>
__device__ __forceinline__ void warp_abt_bf16(float (&acc)[NT][4],
                                              const float* a, int lda,
                                              const float* b, int ldb,
                                              int m0, int n0, int k1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < k1; k += 16) {
    const float* r0 = a + (m0 + g) * lda + k + 2 * t;
    const float* r1 = r0 + 8 * lda;
    const uint32_t af[4] = {pack_bf16(r0[0], r0[1]), pack_bf16(r1[0], r1[1]),
                            pack_bf16(r0[8], r0[9]), pack_bf16(r1[8], r1[9])};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* bn = b + (n0 + 8 * j + g) * ldb + k + 2 * t;
      mma_bf16(acc[j], af, pack_bf16(bn[0], bn[1]), pack_bf16(bn[8], bn[9]));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  }
}

// How the 8 warps cut an M x NC output: M / 16 row tiles, each split in
// column ranges of NT n-tiles.
template <int M, int NC>
struct WarpTile {
  static constexpr int kRows = M / 16;
  static constexpr int kSplit = kWarps / kRows;
  static constexpr int NT = NC / 8 / kSplit;
  static_assert(kWarps % kRows == 0 && (NC / 8) % kSplit == 0, "tiling");
  __device__ static int m0(int w) { return 16 * (w % kRows); }
  __device__ static int part(int w) { return w / kRows; }
  __device__ static int n0(int w) { return 8 * NT * (w / kRows); }
};

// --- loads ------------------------------------------------------------------

// One chunk of a [S, width] stream (row stride `stride`, the first `width`
// values of a row real), fetched into registers as 16-byte vectors: a
// block issues all its operands' loads before it stores any, so that the
// SM has its chunk's bytes in flight at once.  Rows of a chunk that are
// not 16-byte aligned, or a width that is not whole vectors, go element
// by element instead.  `cols` (the filled columns) is a multiple of 64.
template <typename T, int COLS>
struct Fetch {
  static constexpr int V = 16 / sizeof(T);                      // a vector
  static constexpr int kPer = kChunk * COLS / V / kThreads;     // a thread
  static_assert(kChunk * COLS % (V * kThreads) == 0, "whole vectors");
  uint4 buf[kPer];
  bool vec;

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       int64_t stride, int c0, int seq,
                                       int width) {
    vec = width % V == 0 && stride % V == 0 &&
          reinterpret_cast<uintptr_t>(src) % 16 == 0;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = e / (COLS / V), k = (e % (COLS / V)) * V;
      const bool row = c0 + i < seq;
      if (vec) {
        const T* at = src + (c0 + i) * stride + k;
        buf[u] = row && k < width ? *reinterpret_cast<const uint4*>(at)
                                  : make_uint4(0, 0, 0, 0);
      } else {
        T* t = reinterpret_cast<T*>(&buf[u]);
#pragma unroll
        for (int w = 0; w < V; ++w) {
          t[w] = row && k + w < width ? src[(c0 + i) * stride + k + w]
                                      : from_f32<T>(0.0f);
        }
      }
    }
  }

  // Into shared rows of `row` floats as f32 (times scale[i] when given).
  __device__ __forceinline__ void store(float* dst, int row,
                                        const float* scale = nullptr) const {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int i = e / (COLS / V), k = (e % (COLS / V)) * V;
      const T* t = reinterpret_cast<const T*>(&buf[u]);
      const float m = scale ? scale[i] : 1.0f;
#pragma unroll
      for (int w = 0; w < V; ++w) dst[i * row + k + w] = to_f32(t[w]) * m;
    }
  }
};

// Warp 0: the inclusive cumsum s of la over the chunk (two 32-step warp
// scans, the forward's order), e^s and e^{s_{L-1} - s}.
__device__ __forceinline__ void chunk_decay(const float* lp, int64_t ls,
                                            int c0, int seq, float* ss,
                                            float* es, float* ws) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  float lo = c0 + lane < seq ? lp[(c0 + lane) * ls] : 0.0f;
  float hi = c0 + 32 + lane < seq ? lp[(c0 + 32 + lane) * ls] : 0.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float a = __shfl_up_sync(0xffffffffu, lo, off);
    const float c = __shfl_up_sync(0xffffffffu, hi, off);
    if (lane >= off) {
      lo += a;
      hi += c;
    }
  }
  hi += __shfl_sync(0xffffffffu, lo, 31);
  const float s_last = __shfl_sync(0xffffffffu, hi, 31);
  ss[lane] = lo;
  ss[32 + lane] = hi;
  es[lane] = expf(lo);
  es[32 + lane] = expf(hi);
  ws[lane] = expf(s_last - lo);
  ws[32 + lane] = expf(s_last - hi);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// --- 1. chunk increments -----------------------------------------------------

// Column ranges of a 64-row output a warp's tile covers (WarpTile).
constexpr int kParts = kWarps / 4;

// Floats of shared memory.  Phase 1 reads its operands down the columns
// (rows padded to 8 mod 32 floats: conflict-free), phase 3 mostly along
// the rows (4 mod 32), its L x L tiles down the columns (8 mod 32).
template <int NM>
struct Smem {
  static constexpr int NS1 = NM + 8, PS1 = kPT + 8;
  static constexpr size_t incr = 2 * (size_t)kChunk * (NS1 + PS1) + 3 * kChunk;
  static constexpr int NS = NM + 4, PS = kPT + 4, LS = kChunk + 8;
  static constexpr size_t grad =
      2 * (size_t)NM * PS            // H, G
      + 2 * (size_t)kChunk * PS      // x, dy
      + 2 * (size_t)kChunk * NS      // b, c
      + 2 * (size_t)kChunk * LS      // C B^T e, M
      + 3 * kChunk                   // s, e^s, e^{s_L-s}
      + kParts * kChunk + 4 * kChunk  // A's row and column partials
      + 2 * kParts * kChunk           // c.(H dy), b.(G x) partials
      + kChunk + kWarps;              // w b.(G x); <G, H> partials
};

template <typename TX, typename TBC, int NM>
__global__ void __launch_bounds__(kThreads)
incr_kernel(const TX* __restrict__ x, const float* __restrict__ la,
            const TBC* __restrict__ bm, const TBC* __restrict__ cm,
            const TX* __restrict__ dy, float* __restrict__ ust,
            float* __restrict__ vst, float* __restrict__ slast, Strides st,
            int seq, int heads, int n, int p) {
  using S = Smem<NM>;
  constexpr int L = kChunk, NS = S::NS1, PS = S::PS1;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;              // [L][PS]  x chunk, the block's columns
  float* ys = xs + L * PS;       // [L][PS]  dy chunk
  float* bw = ys + L * PS;       // [L][NS]  w_j b_j
  float* ce = bw + L * NS;       // [L][NS]  e^{s_i} c_i
  float* ss = ce + L * NS;       // [L]
  float* es = ss + L;            // [L]
  float* ws = es + L;            // [L]
  const int c = blockIdx.x, bh = blockIdx.y, pb = blockIdx.z;
  const int n_chunks = gridDim.x, c0 = c * L;
  const int b = bh / heads, h = bh % heads;
  const int p0 = pb * kPT, pw = min(kPT, p - p0), p4 = pad4(p);
  Fetch<TX, kPT> fx, fy;
  Fetch<TBC, NM> fb, fc;
  fx.load(x + b * st.xb + h * st.xh + p0, st.xs, c0, seq, pw);
  fy.load(dy + b * st.gb + h * st.gh + p0, st.gs, c0, seq, pw);
  fb.load(bm + b * st.bb, st.bs, c0, seq, n);
  fc.load(cm + b * st.cb, st.cs, c0, seq, n);
  chunk_decay(la + b * st.lb + h * st.lh, st.ls, c0, seq, ss, es, ws);
  fx.store(xs, PS);
  fy.store(ys, PS);
  __syncthreads();  // s, e^s, w
  if (pb == 0 && threadIdx.x == 0) {
    slast[(int64_t)bh * n_chunks + c] = ss[L - 1];
  }
  fb.store(bw, NS, ws);
  fc.store(ce, NS, es);
  __syncthreads();

  using W = WarpTile<NM, kPT>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = W::m0(warp), n0 = W::n0(warp);
  const int qmax = min(kPT, p4 - p0);
  const int64_t base = ((int64_t)bh * n_chunks + c) * n * p4 + p0;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    // U = (w B)^T X, V = (e^s C)^T dY: A(r, k) = [k][r], B(k, q) = [k][q]
    float acc[W::NT][4];
    zero_acc(acc);
    warp_mm<W::NT, true, false, false, false>(
        acc, which ? ce : bw, NS, which ? ys : xs, PS, m0, n0, 0, L);
    float* out = (which ? vst : ust) + base;
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
      const int q = n0 + 8 * j + 2 * t;
      if (q >= qmax) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        if (r < n) {
          *reinterpret_cast<float2*>(out + (int64_t)r * p4 + q) =
              make_float2(acc[j][2 * half], acc[j][2 * half + 1]);
        }
      }
    }
  }
}

// --- 2. the passes over chunks ---------------------------------------------

// blockIdx.z 0: H_c over U_c, forward; 1: G_c over V_c, reverse, then dh0.
// Thread: four state elements (n, q..q+3) of one batch*head (blockIdx.y).
__global__ void __launch_bounds__(kThreads)
pass_kernel(float* __restrict__ ust, float* __restrict__ vst,
            const float* __restrict__ slast, const float* __restrict__ h0,
            const float* __restrict__ gfinal, float* __restrict__ dh0,
            int n_chunks, int n, int p) {
  constexpr int kBatch = 8;  // chunk loads in flight a thread
  const int p4 = pad4(p);
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= n * p4) return;
  const int bh = blockIdx.y, k = e / p4, q = e - k * p4;
  const bool fwd = blockIdx.z == 0;
  const int64_t stride = (int64_t)n * p4;
  float* buf = (fwd ? ust : vst) + (int64_t)bh * n_chunks * stride + e;
  const float* sl = slast + (int64_t)bh * n_chunks;
  const float* init = fwd ? h0 : gfinal;
  const int64_t at = ((int64_t)bh * n + k) * p + q;
  float hv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) hv[i] = init && q + i < p ? init[at + i] : 0.0f;
  for (int i0 = 0; i0 < n_chunks; i0 += kBatch) {
    float4 u[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int c = fwd ? i0 + i : n_chunks - 1 - (i0 + i);
      if (i0 + i < n_chunks) {
        u[i] = *reinterpret_cast<const float4*>(buf + c * stride);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (i0 + i >= n_chunks) break;
      const int c = fwd ? i0 + i : n_chunks - 1 - (i0 + i);
      *reinterpret_cast<float4*>(buf + c * stride) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
      const float a = expf(sl[c]);
      hv[0] = fmaf(a, hv[0], u[i].x);
      hv[1] = fmaf(a, hv[1], u[i].y);
      hv[2] = fmaf(a, hv[2], u[i].z);
      hv[3] = fmaf(a, hv[3], u[i].w);
    }
  }
  if (!fwd && dh0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q + i < p) dh0[at + i] = hv[i];
    }
  }
}

// --- 3. chunk gradients ----------------------------------------------------

template <typename TX, typename TBC, int NM>
__global__ void __launch_bounds__(kThreads, 1)
grad_kernel(const TX* __restrict__ x, const float* __restrict__ la,
            const TBC* __restrict__ bm, const TBC* __restrict__ cm,
            const TX* __restrict__ dy, const float* __restrict__ hst,
            const float* __restrict__ gst, TX* __restrict__ dx,
            float* __restrict__ part_b, float* __restrict__ part_c,
            float* __restrict__ part_s, Strides st, int seq, int heads,
            int n, int p) {
  using S = Smem<NM>;
  constexpr int L = kChunk, NS = S::NS, PS = S::PS, LS = S::LS;
  constexpr bool kBX = sizeof(TBC) == 2;  // b and c hold bf16 values
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // [NM][PS]  state entering the chunk
  float* gs = hs + NM * PS;      // [NM][PS]  gradient of the one leaving it
  float* xs = gs + NM * PS;      // [L][PS]   x chunk, the block's columns
  float* ys = xs + L * PS;       // [L][PS]   dy chunk
  float* bs = ys + L * PS;       // [L][NS]   b chunk
  float* cs = bs + L * NS;       // [L][NS]   c chunk
  float* cbd = cs + L * NS;      // [L][LS]   (c_i.b_j) e^{s_i-s_j}, j <= i
  float* mds = cbd + L * LS;     // [L][LS]   (dy_i.x_j) e^{s_i-s_j}, j <= i
  float* ss = mds + L * LS;      // [L]
  float* es = ss + L;            // [L]
  float* ws = es + L;            // [L]
  float* rowp = ws + L;             // [kParts][L]  A's row sums
  float* colp = rowp + kParts * L;  // [4][L]  A's column sums, by row tile
  float* hdp = colp + 4 * L;        // [kParts][L]  c.(H dy)
  float* gxp = hdp + kParts * L;    // [kParts][L]  b.(G x)
  float* qv = gxp + kParts * L;     // [L]     w b.(G x)
  float* red = qv + L;           // [kWarps] <G, H>

  const int c = blockIdx.x, bh = blockIdx.y, pb = blockIdx.z;
  const int n_chunks = gridDim.x, n_pb = gridDim.z, c0 = c * L;
  const int b = bh / heads, h = bh % heads, spad = n_chunks * L;
  const int p0 = pb * kPT, pw = min(kPT, p - p0), p4 = pad4(p);
  const int qmax = min(kPT, p4 - p0);
  const int parts = heads * n_pb;  // db/dc partials a batch row
  const int64_t sbase = ((int64_t)bh * n_chunks + c) * n * p4 + p0;

  // H and G by cp.async, in flight through the loads and first products
  for (int e = threadIdx.x; e < NM * (kPT / 4); e += kThreads) {
    const int r = e / (kPT / 4), q = 4 * (e % (kPT / 4));
    const bool ok = r < n && q < qmax;
    const int64_t off = ok ? sbase + (int64_t)r * p4 + q : 0;
    cp_async16(hs + r * PS + q, hst + off, ok);
    cp_async16(gs + r * PS + q, gst + off, ok);
  }
  cp_async_commit();
  {
    Fetch<TX, kPT> fx, fy;
    Fetch<TBC, NM> fb, fc;
    fx.load(x + b * st.xb + h * st.xh + p0, st.xs, c0, seq, pw);
    fy.load(dy + b * st.gb + h * st.gh + p0, st.gs, c0, seq, pw);
    fb.load(bm + b * st.bb, st.bs, c0, seq, n);
    fc.load(cm + b * st.cb, st.cs, c0, seq, n);
    chunk_decay(la + b * st.lb + h * st.lh, st.ls, c0, seq, ss, es, ws);
    fx.store(xs, PS);
    fy.store(ys, PS);
    fb.store(bs, NS);
    fc.store(cs, NS);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n8 = (n + 7) & ~7, n16 = (n + 15) & ~15;

  // (a) C B^T and dY X^T, each warp 16 rows x 32 columns; then C B^T e and
  // M = (dY X^T) e to shared memory, and A = (C B^T)(dY X^T) e summed by
  // row and by column
  {
    using W = WarpTile<L, L>;
    const int m0 = W::m0(warp), n0 = W::n0(warp);
    float cb[W::NT][4], yx[W::NT][4];
    zero_acc(cb);
    zero_acc(yx);
    if (n0 <= m0 + 15) {  // the tile reaches the diagonal
      if (kBX) {
        warp_abt_bf16<W::NT>(cb, cs, NS, bs, NS, m0, n0, n16);
      } else {
        warp_mm<W::NT, false, true, false, false>(cb, cs, NS, bs, NS, m0, n0,
                                                   0, n8);
      }
      warp_mm<W::NT, false, true, false, false>(yx, ys, PS, xs, PS, m0, n0, 0,
                                                 kPT);
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
      float cs2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + 8 * (e >> 1), jj = n0 + 8 * j + 2 * t + (e & 1);
        const float d = jj <= i ? expf(ss[i] - ss[jj]) : 0.0f;
        cbd[i * LS + jj] = cb[j][e] * d;
        mds[i * LS + jj] = yx[j][e] * d;
        const float av = cb[j][e] * yx[j][e] * d;
        rs[e >> 1] += av;
        cs2[e & 1] += av;
      }
      // column sums over the warp's 16 rows: the 8 lanes of a column pair
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs2[0] += __shfl_xor_sync(0xffffffffu, cs2[0], off);
        cs2[1] += __shfl_xor_sync(0xffffffffu, cs2[1], off);
      }
      if (g == 0) {
        colp[(m0 / 16) * L + n0 + 8 * j + 2 * t] = cs2[0];
        colp[(m0 / 16) * L + n0 + 8 * j + 2 * t + 1] = cs2[1];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
      rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
      if (t == 0) rowp[W::part(warp) * L + m0 + g + 8 * half] = rs[half];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // (b) dx = (C B^T e)^T dY + w (B G)
  {
    using W = WarpTile<L, kPT>;
    const int m0 = W::m0(warp), n0 = W::n0(warp);
    float acc[W::NT][4];
    zero_acc(acc);
    warp_mm<W::NT, false, false, kBX, false>(acc, bs, NS, gs, PS, m0, n0, 0,
                                              n8);
#pragma unroll
    for (int j = 0; j < W::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= ws[m0 + g + 8 * (e >> 1)];
    }
    warp_mm<W::NT, true, false, false, false>(acc, cbd, LS, ys, PS, m0, n0, m0,
                                               L);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int pos = c0 + m0 + g + 8 * half;
      if (pos >= seq) continue;
      TX* out = dx + (((int64_t)b * seq + pos) * heads + h) * p + p0;
#pragma unroll
      for (int j = 0; j < W::NT; ++j) {
        const int q = n0 + 8 * j + 2 * t;
        if (q < pw) out[q] = from_f32<TX>(acc[j][2 * half]);
        if (q + 1 < pw) out[q + 1] = from_f32<TX>(acc[j][2 * half + 1]);
      }
    }
  }

  using WN = WarpTile<L, NM>;
  const int m0 = WN::m0(warp), n0 = WN::n0(warp);
  // (c) dc partial = e^s (dY H^T) + M B; ds's c_i.(H dy_i) on the way
  {
    float acc[WN::NT][4];
    zero_acc(acc);
    warp_mm<WN::NT, false, true, false, false>(acc, ys, PS, hs, PS, m0, n0, 0,
                                                kPT);
    float rd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < WN::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + 8 * (e >> 1);
        rd[e >> 1] = fmaf(cs[i * NS + n0 + 8 * j + 2 * t + (e & 1)], acc[j][e],
                          rd[e >> 1]);
        acc[j][e] *= es[i];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rd[half] += __shfl_xor_sync(0xffffffffu, rd[half], 1);
      rd[half] += __shfl_xor_sync(0xffffffffu, rd[half], 2);
      if (t == 0) hdp[WN::part(warp) * L + m0 + g + 8 * half] = rd[half];
    }
    warp_mm<WN::NT, false, false, false, kBX>(acc, mds, LS, bs, NS, m0, n0, 0,
                                               m0 + 16);
    float* pcp = part_c + ((int64_t)b * parts + h * n_pb + pb) * spad * n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* out = pcp + (int64_t)(c0 + m0 + g + 8 * half) * n;
#pragma unroll
      for (int j = 0; j < WN::NT; ++j) {
        const int k = n0 + 8 * j + 2 * t;
        if (k < n) out[k] = acc[j][2 * half];
        if (k + 1 < n) out[k + 1] = acc[j][2 * half + 1];
      }
    }
  }
  // (d) db partial = w (X G^T) + M^T C; ds's b_j.(G x_j) on the way
  {
    float acc[WN::NT][4];
    zero_acc(acc);
    warp_mm<WN::NT, false, true, false, false>(acc, xs, PS, gs, PS, m0, n0, 0,
                                                kPT);
    float rd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < WN::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + g + 8 * (e >> 1);
        rd[e >> 1] = fmaf(bs[i * NS + n0 + 8 * j + 2 * t + (e & 1)], acc[j][e],
                          rd[e >> 1]);
        acc[j][e] *= ws[i];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      rd[half] += __shfl_xor_sync(0xffffffffu, rd[half], 1);
      rd[half] += __shfl_xor_sync(0xffffffffu, rd[half], 2);
      if (t == 0) gxp[WN::part(warp) * L + m0 + g + 8 * half] = rd[half];
    }
    warp_mm<WN::NT, true, false, false, kBX>(acc, mds, LS, cs, NS, m0, n0, m0,
                                              L);
    float* pbp = part_b + ((int64_t)b * parts + h * n_pb + pb) * spad * n;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* out = pbp + (int64_t)(c0 + m0 + g + 8 * half) * n;
#pragma unroll
      for (int j = 0; j < WN::NT; ++j) {
        const int k = n0 + 8 * j + 2 * t;
        if (k < n) out[k] = acc[j][2 * half];
        if (k + 1 < n) out[k + 1] = acc[j][2 * half + 1];
      }
    }
  }
  // (e) <G, H> over the block's columns
  {
    float r = 0.0f;
    for (int e = threadIdx.x; e < NM * kPT; e += kThreads) {
      const int k = e / kPT, q = e % kPT;
      r = fmaf(gs[k * PS + q], hs[k * PS + q], r);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      r += __shfl_xor_sync(0xffffffffu, r, off);
    }
    if (lane == 0) red[warp] = r;
  }
  __syncthreads();

  // (f) the ds partials, each sum in a fixed order; row L-1 also takes
  // a <G, H> + sum_j w_j b_j.(G x_j)
  float ds = 0.0f;
  if (threadIdx.x < L) {
    const int i = threadIdx.x;
    float ra = 0.0f, hd = 0.0f, gx = 0.0f;
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      ra += rowp[q * L + i];
      hd += hdp[q * L + i];
      gx += gxp[q * L + i];
    }
    const float ca =
        (colp[i] + colp[L + i]) + (colp[2 * L + i] + colp[3 * L + i]);
    qv[i] = ws[i] * gx;
    ds = fmaf(es[i], hd, ra - ca) - qv[i];
  }
  __syncthreads();
  if (threadIdx.x < L) {
    const int i = threadIdx.x;
    if (i == L - 1) {
      float gh = 0.0f, q = 0.0f;
      for (int w = 0; w < kWarps; ++w) gh += red[w];
      for (int j = 0; j < L; ++j) q += qv[j];
      ds += fmaf(expf(ss[L - 1]), gh, q);
    }
    part_s[((int64_t)bh * n_pb + pb) * spad + c0 + i] = ds;
  }
}

// --- 4. fixed-order reductions ---------------------------------------------

// db and dc [B, S, N]: the partials [B, parts, S_pad, N] summed over parts
// in order; blockIdx.y picks db (0) or dc (1).
template <typename TBC>
__global__ void __launch_bounds__(kThreads)
reduce_bc_kernel(const float* __restrict__ part_b,
                 const float* __restrict__ part_c, TBC* __restrict__ db,
                 TBC* __restrict__ dc, int batch, int parts, int seq,
                 int spad, int n) {
  const float* part = blockIdx.y ? part_c : part_b;
  TBC* out = blockIdx.y ? dc : db;
  const int64_t per_row = (int64_t)seq * n, total = batch * per_row;
  for (int64_t e = blockIdx.x * (int64_t)kThreads + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * kThreads) {
    const int64_t b = e / per_row, r = e - b * per_row;
    const float* src = part + b * parts * (int64_t)spad * n + r;
    float acc = 0.0f;
    for (int q = 0; q < parts; ++q) acc += src[(int64_t)q * spad * n];
    out[e] = from_f32<TBC>(acc);
  }
}

// dla [B, S, H]: per (b, h, chunk) the ds partials summed over the column
// blocks, then the suffix sum inside the chunk, one thread each.
__global__ void __launch_bounds__(kThreads)
dla_kernel(const float* __restrict__ part_s, float* __restrict__ dla,
           int rows, int heads, int n_pb, int seq, int n_chunks) {
  const int64_t e = blockIdx.x * (int64_t)kThreads + threadIdx.x;
  if (e >= (int64_t)rows * n_chunks) return;
  const int bh = (int)(e / n_chunks), c = (int)(e % n_chunks);
  const int b = bh / heads, h = bh % heads, spad = n_chunks * kChunk;
  float run = 0.0f;
  for (int i = kChunk - 1; i >= 0; --i) {
    const int pos = c * kChunk + i;
    float v = 0.0f;
    for (int q = 0; q < n_pb; ++q) {
      v += part_s[((int64_t)bh * n_pb + q) * spad + pos];
    }
    run += v;
    if (pos < seq) dla[((int64_t)b * seq + pos) * heads + h] = run;
  }
}

template <typename TX, typename TBC, int NM>
int launch(const void* x, const void* la, const void* b, const void* c,
           const void* h0, const void* dy, const void* gfinal, void* dx,
           void* dla, void* db, void* dc, void* dh0, void* ust, void* vst,
           void* slast, void* part_b, void* part_c, void* part_s,
           const int64_t* s, int batch, int seq, int heads, int n, int p,
           cudaStream_t stream) {
  using S = Smem<NM>;
  const size_t incr_smem = S::incr * sizeof(float);
  const size_t grad_smem = S::grad * sizeof(float);
  if (n > NM || grad_smem > kMaxSmem || incr_smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  // once per template instance, not per launch
  static const cudaError_t a1 = cudaFuncSetAttribute(
      incr_kernel<TX, TBC, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)incr_smem);
  if (a1 != cudaSuccess) return (int)a1;
  static const cudaError_t a2 = cudaFuncSetAttribute(
      grad_kernel<TX, TBC, NM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)grad_smem);
  if (a2 != cudaSuccess) return (int)a2;
  // all of the unified L1 as shared memory: as many blocks an SM as fit
  static const cudaError_t a3 = cudaFuncSetAttribute(
      incr_kernel<TX, TBC, NM>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (a3 != cudaSuccess) return (int)a3;
  static const cudaError_t a4 = cudaFuncSetAttribute(
      grad_kernel<TX, TBC, NM>,
      cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (a4 != cudaSuccess) return (int)a4;
  const Strides st{s[0], s[1], s[2], s[3],  s[4],  s[5], s[6],
                   s[7], s[8], s[9], s[10], s[11], s[12]};
  const int n_pb = (p + kPT - 1) / kPT;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const int rows = batch * heads;
  const dim3 grid(n_chunks, rows, n_pb);
  incr_kernel<TX, TBC, NM><<<grid, kThreads, incr_smem, stream>>>(
      (const TX*)x, (const float*)la, (const TBC*)b, (const TBC*)c,
      (const TX*)dy, (float*)ust, (float*)vst, (float*)slast, st, seq, heads,
      n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int quads = n * pad4(p) / 4;
  pass_kernel<<<dim3((quads + kThreads - 1) / kThreads, rows, 2), kThreads, 0,
                stream>>>((float*)ust, (float*)vst, (const float*)slast,
                          (const float*)h0, (const float*)gfinal,
                          (float*)dh0, n_chunks, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  grad_kernel<TX, TBC, NM><<<grid, kThreads, grad_smem, stream>>>(
      (const TX*)x, (const float*)la, (const TBC*)b, (const TBC*)c,
      (const TX*)dy, (const float*)ust, (const float*)vst, (TX*)dx,
      (float*)part_b, (float*)part_c, (float*)part_s, st, seq, heads, n, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)batch * seq * n;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 65535
                               ? (total + kThreads - 1) / kThreads : 65535);
  reduce_bc_kernel<TBC><<<dim3(blocks, 2), kThreads, 0, stream>>>(
      (const float*)part_b, (const float*)part_c, (TBC*)db, (TBC*)dc, batch,
      heads * n_pb, seq, n_chunks * kChunk, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t lines = (int64_t)rows * n_chunks;
  dla_kernel<<<(int)((lines + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>((const float*)part_s, (float*)dla, rows, heads, n_pb,
                         seq, n_chunks);
  return (int)cudaGetLastError();
}

// The state tiles' rows: 64 while N <= 64, else 128
template <typename TX, typename TBC>
int launch_n(const void* x, const void* la, const void* b, const void* c,
             const void* h0, const void* dy, const void* gfinal, void* dx,
             void* dla, void* db, void* dc, void* dh0, void* ust, void* vst,
             void* slast, void* part_b, void* part_c, void* part_s,
             const int64_t* s, int batch, int seq, int heads, int n, int p,
             cudaStream_t stream) {
  if (n <= 64) {
    return launch<TX, TBC, 64>(x, la, b, c, h0, dy, gfinal, dx, dla, db, dc,
                               dh0, ust, vst, slast, part_b, part_c, part_s,
                               s, batch, seq, heads, n, p, stream);
  }
  return launch<TX, TBC, 128>(x, la, b, c, h0, dy, gfinal, dx, dla, db, dc,
                              dh0, ust, vst, slast, part_b, part_c, part_s, s,
                              batch, seq, heads, n, p, stream);
}

}  // namespace ssd_bwd

extern "C" {

// The state columns a block takes (64 at every N): the wrapper sizes the
// partials by it.
int ssd_scan_bwd_columns(int n) {
  (void)n;
  return ssd_bwd::kPT;
}

// dtype: 0 = float32, 1 = bfloat16, of x, dy and dx; bc_dtype the same for
// b, c, db and dc.  strides: 13 int64 values in elements, (b, s, h) of x,
// of dy and of la, (b, s) of b and of c.  h0, gfinal and dh0 may be null
// (dh0 only when h0 is).  Scratch, f32: ust and vst batch * heads * chunks
// * n * p4 values each (p4 = p rounded up to a multiple of 4, 16-byte
// aligned), slast batch * heads * chunks; part_b and part_c batch * heads *
// ceil(p / cols) * chunks * 64 * n each; part_s batch * heads * ceil(p /
// cols) * chunks * 64, with cols = ssd_scan_bwd_columns(n) and chunks =
// ceil(seq / 64).  Launches the chunk increments, the two passes over
// chunks, the chunk gradients and the two reductions.  Returns a cudaError_t
// code: 0 on successful launches.
int ssd_scan_bwd(const void* x, const void* la, const void* b, const void* c,
                 const void* h0, const void* dy, const void* gfinal,
                 void* dx, void* dla, void* db, void* dc, void* dh0,
                 void* ust, void* vst, void* slast, void* part_b,
                 void* part_c, void* part_s, const int64_t* strides,
                 int batch, int seq, int heads, int n, int p, int dtype,
                 int bc_dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n <= 0 ||
      n > ssd_bwd::kMaxN || p <= 0 || (dh0 && !h0) ||
      (int64_t)batch * heads > 65535 ||
      (p + ssd_bwd::kPT - 1) / ssd_bwd::kPT > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (((uintptr_t)ust | (uintptr_t)vst) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
#define SSD_BWD(TX, TBC)                                                      \
  return ssd_bwd::launch_n<TX, TBC>(x, la, b, c, h0, dy, gfinal, dx, dla, db, \
                                    dc, dh0, ust, vst, slast, part_b, part_c, \
                                    part_s, strides, batch, seq, heads, n, p, \
                                    st)
  if (dtype == 0 && bc_dtype == 0) SSD_BWD(float, float);
  if (dtype == 0 && bc_dtype == 1) SSD_BWD(float, bf16);
  if (dtype == 1 && bc_dtype == 0) SSD_BWD(bf16, float);
  if (dtype == 1 && bc_dtype == 1) SSD_BWD(bf16, bf16);
#undef SSD_BWD
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
