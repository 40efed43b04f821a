// Backward of the Mamba2 SSD chunked scan (kernel B5) for NVIDIA Hopper
// (sm_90a).  Built with nvcc into a shared library of its own with a plain
// C interface and loaded with ctypes (kernels/build.py,
// kernels/ssd_scan/ssd_scan.py); ssd_scan.cu, the forward, is unchanged.
//
// Replaces no Pallas kernel: the TPU's _ssd_kernel has no VJP, and the JAX
// package trains through XLA's autodiff of the jnp scan
// (src/repro/models/ssm.py::ssd_chunked).  On the port's side it replaces
// the gradient in torch ops (ssd_scan.py's _SSDScan.backward before: the
// plain scan recomputed and differentiated, ~28,000 small kernels a call
// that the host launches).
//
// The math, per (batch, head) and chunk of L = 64 steps, with s_i the
// inclusive in-chunk cumsum of la, H the state entering the chunk [N, P]
// and G the gradient of the state leaving it (grad_final at the last
// chunk, or zero):
//   dH   = e^{s_{L-1}} G + sum_i e^{s_i} c_i dy_i^T        (to the chunk before)
//   dx_j = sum_{i>=j} (c_i.b_j) e^{s_i-s_j} dy_i + e^{s_{L-1}-s_j} G^T b_j
//   db_j = sum_h [sum_{i>=j} e^{s_i-s_j} (dy_i.x_j) c_i + e^{s_{L-1}-s_j} G x_j]
//   dc_i = sum_h [sum_{j<=i} e^{s_i-s_j} (dy_i.x_j) b_j + e^{s_i} H dy_i]
//   ds_i = sum_{j<=i} A_ij - sum_{k>=i} A_ki + e^{s_i} c_i.(H dy_i)
//          - e^{s_{L-1}-s_i} b_i.(G x_i),  A_ij = (c_i.b_j)(dy_i.x_j) e^{s_i-s_j},
//          plus at i = L-1: e^{s_{L-1}} <G, H> + sum_j e^{s_{L-1}-s_j} b_j.(G x_j)
//   dla_t = sum_{i>=t} ds_i inside the chunk.
// e^{s_i-s_j} is only evaluated for j <= i, as in the forward.  A ragged last
// chunk is zero-padded (la = 0, x = b = c = dy = 0), which leaves every
// gradient exact: the padded rows' terms vanish and the i = L-1 term lands
// on s_{L-1}, which equals s at the last real step.
//
// Design (simple first):
//   1. states_kernel: the forward's state recurrence again, writing the
//      state entering every chunk to f32 scratch [B, H, chunks, N, P]
//      (134 MB at zamba2-1.2b's train shape).  Grid (B*H, ceil(P / PT)).
//   2. bwd_kernel: a reverse sweep over chunks, grid (B*H, ceil(P / PT)),
//      split by state columns as the forward is: dH, dx and dy's column p
//      depend only on column p.  Each block carries its [N, PT] slice of dH
//      in shared memory.  Every product of a chunk is a small matrix
//      product over shared memory (kernels/csrc/f32_tile.cuh's mm4: a 4 x 4
//      register tile a thread, float4 reads along the inner dimension, as
//      in B4's CUDA-core backward); triangular sums stop at the
//      diagonal tile.  db, dc and ds sum over heads and column blocks:
//      each block writes its partials (f32), no atomics.
//   3. reduce_bc_kernel sums the db and dc partials over heads and column
//      blocks, and dla_kernel the ds partials over column blocks, then the
//      in-chunk suffix sum; both in a fixed order, so two runs give the
//      same bits.
// Products stay f32 on the CUDA cores, for the forward's reason: TF32 keeps
// 10 mantissa bits and misses the f32 gates.
//
// What bounds it on the card: about twice the forward's multiply-adds
// (every product of the forward has a transpose in the backward, plus the
// recomputed states) on the same inputs: f32 operations, at 67 TFLOP/s.
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

namespace ssd_bwd {

using namespace f32_tile;

constexpr int kThreads = 256;
constexpr int kChunk = 64;
constexpr int kMaxN = 128;
constexpr int kLS = kChunk + 4;       // floats per row of an L x L tile
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

struct Strides {
  int64_t xb, xs, xh;  // x
  int64_t gb, gs, gh;  // dy
  int64_t lb, ls, lh;  // la
  int64_t bb, bs;      // b
  int64_t cb, cs;      // c
};

__host__ __device__ inline int padded_n(int n) { return (n + 3) & ~3; }
// the largest N a block of PT state columns takes
__host__ __device__ constexpr int max_n(int pt) { return pt == 64 ? 64 : 128; }

// Floats of shared memory: the b/c row stride NS, the x/dy/state row stride
// PS, and the buffers of each kernel.
template <int PT>
struct Smem {
  static constexpr int NM = max_n(PT);
  static constexpr int NS = NM + 4;
  static constexpr int PS = PT + 4;
  static constexpr int WS = NS > kLS ? NS : kLS;  // the work buffer's rows
  static constexpr size_t bwd =
      2 * (size_t)kChunk * NS      // b, c
      + 2 * (size_t)kChunk * PS    // x, dy
      + 2 * (size_t)NM * PS        // H, G
      + 2 * (size_t)kChunk * kLS   // C B^T e^{s_i-s_j}, M
      + (size_t)kChunk * WS        // A, then H dy, then G x
      + 5 * kChunk + 32;           // s, e^s, e^{s_L-s}, ds, scratch; sums
  static constexpr size_t states =
      (size_t)kChunk * NS + (size_t)kChunk * PS + (size_t)NM * PS +
      2 * kChunk;
};

// One chunk of a [S, width] stream (row stride `stride`, the first `width`
// values of a row real) into shared rows of `row` floats, `cols` of them
// filled: zeros past `width` and past the sequence.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int row, int cols,
                                           const T* src, int64_t stride,
                                           int c0, int seq, int width) {
  for (int e = threadIdx.x; e < kChunk * cols; e += kThreads) {
    const int i = e / cols, k = e - i * cols;
    const int pos = c0 + i;
    dst[i * row + k] =
        pos < seq && k < width ? to_f32(src[pos * stride + k]) : 0.0f;
  }
}

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
  if (es) {
    es[lane] = expf(lo);
    es[32 + lane] = expf(hi);
  }
  ws[lane] = expf(s_last - lo);
  ws[32 + lane] = expf(s_last - hi);
}

// The state entering every chunk, [B*H, chunks, n, p] f32.
template <typename TX, typename TBC, int PT>
__global__ void __launch_bounds__(kThreads)
states_kernel(const TX* __restrict__ x, const float* __restrict__ la,
              const TBC* __restrict__ bm, const float* __restrict__ h0,
              float* __restrict__ states, Strides st, int seq, int heads,
              int n, int p) {
  using S = Smem<PT>;
  constexpr int L = kChunk, NS = S::NS, PS = S::PS;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;            // [L][NS]
  float* xs = bs + L * NS;     // [L][PS]
  float* hs = xs + L * PS;     // [NM][PS]
  float* ss = hs + S::NM * PS;  // [L]
  float* ws = ss + L;          // [L]
  const int t = threadIdx.x, bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int p0 = blockIdx.y * PT, np = padded_n(n);
  const int n_chunks = (seq + L - 1) / L, pw = min(PT, p - p0);
  const TX* xp = x + b * st.xb + h * st.xh + p0;
  const float* lp = la + b * st.lb + h * st.lh;
  const TBC* bp = bm + b * st.bb;
  for (int e = t; e < np * PT; e += kThreads) {
    const int k = e / PT, q = e % PT;
    hs[k * PS + q] = h0 && k < n && q < pw
                         ? h0[((int64_t)bh * n + k) * p + p0 + q] : 0.0f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * L;
    __syncthreads();  // the state is complete; the last chunk's reads done
    float* out = states + ((int64_t)bh * n_chunks + c) * n * p + p0;
    for (int e = t; e < n * PT; e += kThreads) {
      const int k = e / PT, q = e % PT;
      if (q < pw) out[k * p + q] = hs[k * PS + q];
    }
    load_chunk(xs, PS, PT, xp, st.xs, c0, seq, pw);
    load_chunk(bs, NS, np, bp, st.bs, c0, seq, n);
    chunk_decay(lp, st.ls, c0, seq, ss, nullptr, ws);
    __syncthreads();
    // h = e^{s_L} h + sum_j (b_j e^{s_L - s_j}) x_j^T, each tile in place
    const float decay = expf(ss[L - 1]);
    for (int tile = t; tile < (np / 4) * (PT / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (PT / 4)), q0 = 4 * (tile % (PT / 4));
      float acc[4][4];
      zero4(acc);
      mm4<true, false, true>(acc, bs, NS, xs, PS, r0, q0, 0, L, ws);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float* hv = hs + (r0 + u) * PS + q0 + v;
          *hv = fmaf(decay, *hv, acc[u][v]);
        }
      }
    }
  }
}

template <typename TX, typename TBC, int PT>
__global__ void __launch_bounds__(kThreads, 1)
bwd_kernel(const TX* __restrict__ x, const float* __restrict__ la,
           const TBC* __restrict__ bm, const TBC* __restrict__ cm,
           const TX* __restrict__ dy, const float* __restrict__ states,
           const float* __restrict__ gfinal, TX* __restrict__ dx,
           float* __restrict__ dh0, float* __restrict__ part_b,
           float* __restrict__ part_c, float* __restrict__ part_s,
           Strides st, int seq, int heads, int n, int p) {
  using S = Smem<PT>;
  constexpr int L = kChunk, NS = S::NS, PS = S::PS, WS = S::WS;
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;              // [L][NS]   b chunk
  float* cs = bs + L * NS;       // [L][NS]   c chunk
  float* xs = cs + L * NS;       // [L][PS]   x chunk, the block's columns
  float* gys = xs + L * PS;      // [L][PS]   dy chunk
  float* hs = gys + L * PS;      // [NM][PS]  state entering the chunk
  float* gs = hs + S::NM * PS;   // [NM][PS]  gradient of the state leaving it
  float* cbd = gs + S::NM * PS;  // [L][kLS]  (c_i.b_j) e^{s_i-s_j}, j <= i
  float* mm = cbd + L * kLS;     // [L][kLS]  (dy_i.x_j) e^{s_i-s_j}, j <= i
  float* wk = mm + L * kLS;      // [L][WS]   A, then H dy, then G x
  float* ss = wk + L * WS;       // [L]
  float* es = ss + L;            // [L]
  float* ws = es + L;            // [L]
  float* dsv = ws + L;           // [L]
  float* tmp = dsv + L;          // [L]
  float* red = tmp + L;          // [32]

  const int t = threadIdx.x, bh = blockIdx.x, pb = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int p0 = pb * PT, np = padded_n(n), pw = min(PT, p - p0);
  const int n_chunks = (seq + L - 1) / L, spad = n_chunks * L;
  const int parts = heads * gridDim.y;  // db/dc partials a batch row
  const TX* xp = x + b * st.xb + h * st.xh + p0;
  const TX* gyp = dy + b * st.gb + h * st.gh + p0;
  const float* lp = la + b * st.lb + h * st.lh;
  const TBC* bp = bm + b * st.bb;
  const TBC* cp = cm + b * st.cb;
  float* pbp = part_b + ((int64_t)b * parts + h * gridDim.y + pb) * spad * n;
  float* pcp = part_c + ((int64_t)b * parts + h * gridDim.y + pb) * spad * n;
  float* psp = part_s + ((int64_t)bh * gridDim.y + pb) * spad;

  for (int e = t; e < np * PT; e += kThreads) {
    const int k = e / PT, q = e % PT;
    gs[k * PS + q] = gfinal && k < n && q < pw
                         ? gfinal[((int64_t)bh * n + k) * p + p0 + q] : 0.0f;
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int c0 = c * L;
    __syncthreads();  // the previous chunk's readers are done
    load_chunk(xs, PS, PT, xp, st.xs, c0, seq, pw);
    load_chunk(gys, PS, PT, gyp, st.gs, c0, seq, pw);
    load_chunk(bs, NS, np, bp, st.bs, c0, seq, n);
    load_chunk(cs, NS, np, cp, st.cs, c0, seq, n);
    const float* hin = states + ((int64_t)bh * n_chunks + c) * n * p + p0;
    for (int e = t; e < np * PT; e += kThreads) {
      const int k = e / PT, q = e % PT;
      hs[k * PS + q] = k < n && q < pw ? hin[k * p + q] : 0.0f;
    }
    chunk_decay(lp, st.ls, c0, seq, ss, es, ws);
    __syncthreads();

    // (1) C B^T e^{s_i-s_j}, M = (dy x^T) e^{s_i-s_j} and A = C B^T * M,
    // j <= i; zeros above the diagonal
    for (int tile = t; tile < (L / 4) * (L / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (L / 4)), q0 = 4 * (tile % (L / 4));
      float cb[4][4], yx[4][4];
      zero4(cb);
      zero4(yx);
      if (q0 <= r0) {
        mm4<false, true>(cb, cs, NS, bs, NS, r0, q0, 0, np);
        mm4<false, true>(yx, gys, PS, xs, PS, r0, q0, 0, PT);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = r0 + u;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = q0 + v;
          const float e = j <= i ? expf(ss[i] - ss[j]) : 0.0f;
          cbd[i * kLS + j] = cb[u][v] * e;
          mm[i * kLS + j] = yx[u][v] * e;
          wk[i * kLS + j] = cb[u][v] * yx[u][v] * e;
        }
      }
    }
    __syncthreads();

    // (2) ds_i = sum_{j<=i} A_ij - sum_{k>=i} A_ki: rows, then columns
    if (t < L) {
      float r = 0.0f;
      for (int j = 0; j <= t; ++j) r += wk[t * kLS + j];
      dsv[t] = r;
    } else if (t < 2 * L) {
      const int j = t - L;
      float r = 0.0f;
      for (int k = j; k < L; ++k) r += wk[k * kLS + j];
      tmp[j] = r;
    }
    __syncthreads();

    // (3) dx = (C B^T e)^T dy + e^{s_L - s} (B G); H dy into the work buffer
    if (t < L) dsv[t] -= tmp[t];
    for (int tile = t; tile < (L / 4) * (PT / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (PT / 4)), q0 = 4 * (tile % (PT / 4));
      float acc[4][4], bg[4][4];
      zero4(acc);
      zero4(bg);
      mm4<true, false>(acc, cbd, kLS, gys, PS, r0, q0, r0, L);
      mm4<false, false>(bg, bs, NS, gs, PS, r0, q0, 0, np);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = c0 + r0 + u;
        if (pos >= seq) continue;
        TX* out = dx + (((int64_t)b * seq + pos) * heads + h) * p + p0;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (q0 + v < pw) {
            out[q0 + v] =
                from_f32<TX>(fmaf(ws[r0 + u], bg[u][v], acc[u][v]));
          }
        }
      }
    }
    for (int tile = t; tile < (L / 4) * (np / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (np / 4)), q0 = 4 * (tile % (np / 4));
      float acc[4][4];
      zero4(acc);
      mm4<false, true>(acc, gys, PS, hs, PS, r0, q0, 0, PT);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) wk[(r0 + u) * WS + q0 + v] = acc[u][v];
      }
    }
    __syncthreads();

    // (4) dc partial = M B + e^s (H dy); ds += e^s c.(H dy); <G, H>
    for (int tile = t; tile < (L / 4) * (np / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (np / 4)), q0 = 4 * (tile % (np / 4));
      float acc[4][4];
      zero4(acc);
      mm4<false, false>(acc, mm, kLS, bs, NS, r0, q0, 0, r0 + 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = r0 + u;
        float* out = pcp + (int64_t)(c0 + i) * n;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (q0 + v < n) {
            out[q0 + v] = fmaf(es[i], wk[i * WS + q0 + v], acc[u][v]);
          }
        }
      }
    }
    if (t < L) {
      float r = 0.0f;
      for (int k = 0; k < np; ++k) r = fmaf(cs[t * NS + k], wk[t * WS + k], r);
      dsv[t] = fmaf(es[t], r, dsv[t]);
    }
    {
      float r = 0.0f;
      for (int e = t; e < np * PT; e += kThreads) {
        const int k = e / PT, q = e % PT;
        r = fmaf(gs[k * PS + q], hs[k * PS + q], r);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        r += __shfl_xor_sync(0xffffffffu, r, off);
      }
      if ((t & 31) == 0) red[t >> 5] = r;
    }
    __syncthreads();

    // (5) G x into the work buffer
    for (int tile = t; tile < (L / 4) * (np / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (np / 4)), q0 = 4 * (tile % (np / 4));
      float acc[4][4];
      zero4(acc);
      mm4<false, true>(acc, xs, PS, gs, PS, r0, q0, 0, PT);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) wk[(r0 + u) * WS + q0 + v] = acc[u][v];
      }
    }
    __syncthreads();

    // (6) db partial = M^T C + e^{s_L - s} (G x); ds -= e^{s_L - s} b.(G x);
    // G = e^{s_L} G + (e^s C)^T dy, each tile in place
    for (int tile = t; tile < (L / 4) * (np / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (np / 4)), q0 = 4 * (tile % (np / 4));
      float acc[4][4];
      zero4(acc);
      mm4<true, false>(acc, mm, kLS, cs, NS, r0, q0, r0, L);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = r0 + u;
        float* out = pbp + (int64_t)(c0 + j) * n;
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          if (q0 + v < n) {
            out[q0 + v] = fmaf(ws[j], wk[j * WS + q0 + v], acc[u][v]);
          }
        }
      }
    }
    if (t < L) {
      float r = 0.0f;
      for (int k = 0; k < np; ++k) r = fmaf(bs[t * NS + k], wk[t * WS + k], r);
      tmp[t] = ws[t] * r;
      dsv[t] -= tmp[t];
    }
    const float decay = expf(ss[L - 1]);
    for (int tile = t; tile < (np / 4) * (PT / 4); tile += kThreads) {
      const int r0 = 4 * (tile / (PT / 4)), q0 = 4 * (tile % (PT / 4));
      float acc[4][4];
      zero4(acc);
      mm4<true, false, true>(acc, cs, NS, gys, PS, r0, q0, 0, L, es);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float* gv = gs + (r0 + u) * PS + q0 + v;
          *gv = fmaf(decay, *gv, acc[u][v]);
        }
      }
    }
    __syncthreads();

    // (7) the ds partials; row L-1 also takes e^{s_L} <G, H> + sum_j
    // e^{s_L - s_j} b_j.(G x_j), in a fixed order
    if (t < L) {
      float v = dsv[t];
      if (t == L - 1) {
        float gh = 0.0f, q = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) gh += red[w];
        for (int j = 0; j < L; ++j) q += tmp[j];
        v += fmaf(decay, gh, q);
      }
      psp[c0 + t] = v;
    }
  }

  if (dh0) {
    __syncthreads();
    for (int e = t; e < n * PT; e += kThreads) {
      const int k = e / PT, q = e % PT;
      if (q < pw) dh0[((int64_t)bh * n + k) * p + p0 + q] = gs[k * PS + q];
    }
  }
}

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

template <typename TX, typename TBC, int PT>
int launch(const void* x, const void* la, const void* b, const void* c,
           const void* h0, const void* dy, const void* gfinal, void* dx,
           void* dla, void* db, void* dc, void* dh0, void* states,
           void* part_b, void* part_c, void* part_s, const int64_t* s,
           int batch, int seq, int heads, int n, int p, cudaStream_t stream) {
  using S = Smem<PT>;
  if (n > max_n(PT)) return (int)cudaErrorInvalidValue;
  const size_t smem = S::bwd * sizeof(float);
  const size_t st_smem = S::states * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // once per template instance, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      bwd_kernel<TX, TBC, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  static const cudaError_t st_attr = cudaFuncSetAttribute(
      states_kernel<TX, TBC, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st_smem);
  if (st_attr != cudaSuccess) return (int)st_attr;
  const Strides st{s[0], s[1], s[2], s[3],  s[4],  s[5], s[6],
                   s[7], s[8], s[9], s[10], s[11], s[12]};
  const int n_pb = (p + PT - 1) / PT;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const dim3 grid(batch * heads, n_pb);
  states_kernel<TX, TBC, PT><<<grid, kThreads, st_smem, stream>>>(
      (const TX*)x, (const float*)la, (const TBC*)b, (const float*)h0,
      (float*)states, st, seq, heads, n, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<TX, TBC, PT><<<grid, kThreads, smem, stream>>>(
      (const TX*)x, (const float*)la, (const TBC*)b, (const TBC*)c,
      (const TX*)dy, (const float*)states, (const float*)gfinal, (TX*)dx,
      (float*)dh0, (float*)part_b, (float*)part_c, (float*)part_s, st, seq,
      heads, n, p);
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
  const int64_t rows = (int64_t)batch * heads * n_chunks;
  dla_kernel<<<(int)((rows + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>((const float*)part_s, (float*)dla, batch * heads,
                         heads, n_pb, seq, n_chunks);
  return (int)cudaGetLastError();
}

// PT = 64 while N <= 64, else 32: the forward's column split
template <typename TX, typename TBC>
int launch_pt(const void* x, const void* la, const void* b, const void* c,
              const void* h0, const void* dy, const void* gfinal, void* dx,
              void* dla, void* db, void* dc, void* dh0, void* states,
              void* part_b, void* part_c, void* part_s, const int64_t* s,
              int batch, int seq, int heads, int n, int p,
              cudaStream_t stream) {
  if (n <= max_n(64)) {
    return launch<TX, TBC, 64>(x, la, b, c, h0, dy, gfinal, dx, dla, db, dc,
                               dh0, states, part_b, part_c, part_s, s, batch,
                               seq, heads, n, p, stream);
  }
  return launch<TX, TBC, 32>(x, la, b, c, h0, dy, gfinal, dx, dla, db, dc,
                             dh0, states, part_b, part_c, part_s, s, batch,
                             seq, heads, n, p, stream);
}

}  // namespace ssd_bwd

extern "C" {

// The state columns a block takes for state size n (64 or 32): the
// wrapper sizes the partials by it.
int ssd_scan_bwd_columns(int n) {
  return n <= ssd_bwd::max_n(64) ? 64 : 32;
}

// dtype: 0 = float32, 1 = bfloat16, of x, dy and dx; bc_dtype the same for
// b, c, db and dc.  strides: 13 int64 values in elements, (b, s, h) of x,
// of dy and of la, (b, s) of b and of c.  h0, gfinal and dh0 may be null
// (dh0 only when h0 is).  Scratch, f32: states batch * heads * chunks * n *
// p values; part_b and part_c batch * heads * ceil(p / cols) * chunks * 64
// * n each; part_s batch * heads * ceil(p / cols) * chunks * 64, with cols
// = ssd_scan_bwd_columns(n) and chunks = ceil(seq / 64).  Launches the
// state pass, the reverse sweep and the two reductions.  Returns a
// cudaError_t code: 0 on successful launches.
int ssd_scan_bwd(const void* x, const void* la, const void* b, const void* c,
                 const void* h0, const void* dy, const void* gfinal,
                 void* dx, void* dla, void* db, void* dc, void* dh0,
                 void* states, void* part_b, void* part_c, void* part_s,
                 const int64_t* strides, int batch, int seq, int heads,
                 int n, int p, int dtype, int bc_dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n <= 0 ||
      n > ssd_bwd::kMaxN || p <= 0 || (p + 31) / 32 > 65535 ||
      (dh0 && !h0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
#define SSD_BWD(TX, TBC)                                                   \
  return ssd_bwd::launch_pt<TX, TBC>(x, la, b, c, h0, dy, gfinal, dx, dla, \
                                     db, dc, dh0, states, part_b, part_c,  \
                                     part_s, strides, batch, seq, heads, n, \
                                     p, st)
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
