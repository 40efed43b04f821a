// Mamba2 SSD chunked scan (state-space duality) for NVIDIA Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (kernels/build.py,
// kernels/ssd_scan/ssd_scan.py).
//
// Replaces, on the TPU side of the repository:
//   * src/repro/kernels/ssd_scan/ssd_scan.py::_ssd_kernel — per (batch x
//     head) row, the sequence is cut into chunks of L steps; within a chunk
//       s       = cumsum(la)                           (inclusive)
//       scores  = (c b^T) * exp(s_i - s_j)  for j <= i, 0 above
//       y       = scores x + exp(s) * (c h_in)
//       h_out   = exp(s_L) h_in + (b * exp(s_L - s))^T x
//     with the [N, P] f32 state h carried across the sequential chunk axis
//     in VMEM scratch.
// Beyond _ssd_kernel, the state starts from an optional h0 and the final
// state is written out (models/ssm.py::ssd_chunked's state0 and final, for
// the serving caches); with h0 = 0 and the final state dropped it is the
// TPU kernel's function.  exp(s_i - s_j) is only evaluated for j <= i: above
// the diagonal the exponent is positive and would overflow.
//
// Layouts are read through strides, as the model holds them: x [B, S, H, P]
// (f32 or bf16, P contiguous), la [B, S, H] f32, b and c [B, S, N] (f32 or
// bf16, both the same; one B/C stream shared by the H heads, N contiguous,
// converted to f32 on load, which is exact); y [B, S, H, P] in x's type,
// final [B, H, N, P] f32 contiguous.  The TPU signature [BH, S, P] is the
// case H = 1.
//
// What bounds it on the card: per (b, h) and chunk the algorithm does
// L^2 N / 2 + L^2 P / 2 + 2 L N P multiply-adds on L (P + 2N + 1) inputs:
// at the serving shapes (L = P = 64, N = 64 or 128) ~80-140 FLOP per f32
// byte, above the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20), so f32
// operations bound it.  Scalar FMAs with both operands in shared memory
// (one shared load per FMA) would be bound by shared-memory bandwidth at
// ~5 TFLOP/s, and one block per (b, h) gives only 256 or 192 blocks for
// 132 SMs.
//
// Design.  The products stay f32 on the CUDA cores: TF32 tensor cores keep
// 10 mantissa bits and miss the 5e-6 scaled gate, and 3xTF32 would triple
// the tensor work for a kernel whose chunk products are small (64 x 64);
// register tiling first.
//   * C B^T once per (batch, chunk): it does not depend on the head (the
//     reference computes it without heads too), so cb_kernel writes it for
//     every chunk to f32 scratch ([B, chunks, 64, 64], 2 MB at the serving
//     shapes) before the scan, instead of 48-64 blocks recomputing it.
//   * More blocks, more warps: columns of the state are independent
//     (y[:, p] needs only x[:, p] and h[:, p]), so the scan's grid is
//     (B*H, ceil(P / PT)) and each block of 256 threads carries an [N, PT]
//     slice of the state: PT = 64 for N <= 64 (zamba2-1.2b: 256 blocks,
//     two per SM), PT = 32 for N up to 128 (mamba2-780m: 384 blocks, two
//     per SM).  At most 128 registers a thread.
//   * Register tiles: each thread computes a micro-tile from float4 reads
//     of shared memory, so one shared load feeds 4-16 FMAs:
//       G = C B^T * exp(s_i - s_j), j <= i   staged from the scratch;
//       y = G x + e^s (C h)   4 rows x PT/16 columns per thread, the G x
//                             sum cut at the thread's last row;
//       h = e^{s_L} h + (B w)^T x   4 (or 8) state rows x PT/16 columns per
//                             thread, held in registers across chunks and
//                             mirrored to shared memory for C h.
//   * The chunk's cumulative decay is a warp scan (two 32-step halves).
//     Its tree order rounds s unlike the plain version's sequential
//     torch.cumsum, and exp(s_i - s_j) turns that into most of the
//     kernel's 1.6-3.2e-6 scaled error against the plain version (a
//     sequential chain gives ~1e-7; PERF.md says why the scan stays).
// L = 64; N up to 128 (b, c rows padded to a multiple of 4 with zeros).
// A ragged last chunk is padded with zeros (la = 0, b = c = x = 0), which
// leaves y and the state exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;
constexpr int kMaxN = 128;
constexpr int kGStride = kChunk + 4;  // floats per row of G
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

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

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[V]);
template <>
__device__ __forceinline__ void load_vec<2>(const float* p, float (&o)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  o[0] = t.x;
  o[1] = t.y;
}
template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x;
  o[1] = t.y;
  o[2] = t.z;
  o[3] = t.w;
}

struct Strides {
  int64_t xb, xs, xh;  // x
  int64_t yb, ys, yh;  // y
  int64_t lb, ls, lh;  // la
  int64_t bb, bs;      // b
  int64_t cb, cs;      // c
};

// rows of b and c in shared memory: N padded to a multiple of 4, plus 4
__host__ __device__ inline int padded_n(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int bc_stride(int n) { return padded_n(n) + 4; }

// PT state columns per block; the largest N it takes
__host__ __device__ constexpr int max_n(int pt) { return pt == 64 ? 64 : 128; }

size_t smem_floats(int n, int pt) {
  const size_t L = kChunk;
  return 2 * L * bc_stride(n)        // b, c chunks
         + L * kGStride              // G
         + L * pt                    // x chunk, the block's columns
         + (size_t)padded_n(n) * pt  // state slice
         + 3 * L;                    // s, exp(s), exp(s_L - s)
}

size_t cb_smem_floats(int n) { return 2 * (size_t)kChunk * bc_stride(n); }

// Four consecutive values from global memory as floats: the first `valid`
// of them (0..4), zeros after; one 8- or 16-byte load when `vec`.
__device__ __forceinline__ float4 load4(const float* p, int valid, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float t[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) t[u] = u < valid ? p[u] : 0.0f;
  return make_float4(t[0], t[1], t[2], t[3]);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int valid,
                                        bool vec) {
  if (vec) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  float t[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) t[u] = u < valid ? to_f32(p[u]) : 0.0f;
  return make_float4(t[0], t[1], t[2], t[3]);
}

// Whether rows of width `n` at `p` with row stride `stride` can be read
// four values at a time.
template <typename T>
__device__ __forceinline__ bool vec4_ok(const T* p, int n, int64_t stride) {
  return n % 4 == 0 && stride % 4 == 0 &&
         reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

// One chunk of a [S, N] stream (row stride `stride`) into shared rows of
// bc_stride(n) floats: zeros past N and past the sequence.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int c0, int seq,
                                          int n) {
  const int nq = padded_n(n) / 4, row = bc_stride(n);
  const bool vec = vec4_ok(src, n, stride);
  for (int e = threadIdx.x; e < kChunk * nq; e += kThreads) {
    const int i = e / nq, k = 4 * (e - i * nq);
    const int pos = c0 + i;
    const float4 v = pos < seq ? load4(src + pos * stride + k, n - k, vec)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(dst + i * row + k) = v;
  }
}

// C B^T of one chunk of one batch row: [64, 64] f32, the 4 x 4 tiles on or
// below the diagonal (the scan reads j <= i only).
template <typename TBC>
__global__ void __launch_bounds__(kThreads)
cb_kernel(const TBC* __restrict__ bm, const TBC* __restrict__ cm,
          float* __restrict__ cb, int64_t sbb, int64_t sbs, int64_t scb,
          int64_t scs, int seq, int n) {
  constexpr int L = kChunk;
  extern __shared__ __align__(16) float smem[];
  const int np = padded_n(n), row = bc_stride(n);
  float* bs = smem;
  float* cs = bs + L * row;
  const int chunk = blockIdx.x, b = blockIdx.y;
  load_rows(bs, bm + b * sbb, sbs, chunk * L, seq, n);
  load_rows(cs, cm + b * scb, scs, chunk * L, seq, n);
  __syncthreads();
  const int gi = threadIdx.x >> 4, gj = threadIdx.x & 15;
  if (gj > gi) return;
  float g[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) g[r][c] = 0.0f;
  }
  for (int k4 = 0; k4 < np; k4 += 4) {
    float c4[4][4], b4[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      load_vec<4>(cs + (4 * gi + r) * row + k4, c4[r]);
      load_vec<4>(bs + (4 * gj + r) * row + k4, b4[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          g[r][c] = fmaf(c4[r][kk], b4[c][kk], g[r][c]);
        }
      }
    }
  }
  float* out = cb + ((size_t)b * gridDim.x + chunk) * L * L;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    *reinterpret_cast<float4*>(out + (4 * gi + r) * L + 4 * gj) =
        make_float4(g[r][0], g[r][1], g[r][2], g[r][3]);
  }
}

template <typename TX, typename TBC, int PT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ la,
                const TBC* __restrict__ bm, const TBC* __restrict__ cm,
                const float* __restrict__ cb, const float* __restrict__ h0,
                TX* __restrict__ y, float* __restrict__ final_state,
                Strides st, int seq, int heads, int n, int p) {
  constexpr int L = kChunk;
  constexpr int QV = PT / 16;          // columns per thread
  constexpr int MK = max_n(PT) / 64;   // groups of 64 state rows
  static_assert(PT == 32 || PT == 64, "PT is 32 or 64");
  extern __shared__ __align__(16) float smem[];
  const int np = padded_n(n), row = bc_stride(n);
  float* bs = smem;                 // [L][row]
  float* cs = bs + L * row;         // [L][row]
  float* gs = cs + L * row;         // [L][kGStride]
  float* xs = gs + L * kGStride;    // [L][PT]
  float* hs = xs + L * PT;          // [np][PT]
  float* ss = hs + np * PT;         // [L]
  float* es = ss + L;               // [L]
  float* ws = es + L;               // [L]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int p0 = blockIdx.y * PT;
  const int n_chunks = (seq + L - 1) / L;
  const TX* xp = x + b * st.xb + h * st.xh + p0;
  TX* yp = y + b * st.yb + h * st.yh + p0;
  const float* lp = la + b * st.lb + h * st.lh;
  const TBC* bp = bm + b * st.bb;
  const TBC* cp = cm + b * st.cb;
  const float* cbp = cb + (size_t)b * n_chunks * L * L;
  const bool x_vec = vec4_ok(xp, p, st.xs);

  // y and state roles: t >> 4 picks 4 rows, t & 15 picks QV columns
  const int i0 = 4 * (t >> 4);
  const int q0 = (t & 15) * QV;

  // the state slice: rows k = i0 + 64 m + u, columns q0 + v
  float hreg[MK][4][QV];
  for (int e = t; e < np * PT; e += kThreads) hs[e] = 0.0f;
#pragma unroll
  for (int m = 0; m < MK; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = i0 + 64 * m + u;
#pragma unroll
      for (int v = 0; v < QV; ++v) {
        const int q = p0 + q0 + v;
        hreg[m][u][v] = (h0 && k < n && q < p)
                            ? h0[((int64_t)bh * n + k) * p + q] : 0.0f;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MK; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = i0 + 64 * m + u;
      if (k < n) {
#pragma unroll
        for (int v = 0; v < QV; ++v) hs[k * PT + q0 + v] = hreg[m][u][v];
      }
    }
  }

  for (int c0 = 0; c0 < seq; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = t; e < L * PT / 4; e += kThreads) {
      const int i = e / (PT / 4), q = 4 * (e % (PT / 4));
      const int pos = c0 + i;
      const float4 v = (pos < seq && p0 + q < p)
                           ? load4(xp + pos * st.xs + q, p - p0 - q, x_vec)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(xs + i * PT + q) = v;
    }
    load_rows(bs, bp, st.bs, c0, seq, n);
    load_rows(cs, cp, st.cs, c0, seq, n);
    if (warp == 0) {  // inclusive cumsum of la over the chunk: warp scan
      float lo = c0 + lane < seq ? lp[(c0 + lane) * st.ls] : 0.0f;
      float hi = c0 + 32 + lane < seq ? lp[(c0 + 32 + lane) * st.ls] : 0.0f;
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
    __syncthreads();

    // G = C B^T * exp(s_i - s_j) for j <= i, 0 above
    const float* gsrc = cbp + (size_t)(c0 / L) * L * L;
    for (int e = t; e < L * L / 4; e += kThreads) {
      const int i = e >> 4, j = 4 * (e & 15);
      float out[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (j <= i) {
        float raw[4];
        load_vec<4>(gsrc + i * L + j, raw);
        const float si = ss[i];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (j + u <= i) out[u] = raw[u] * expf(si - ss[j + u]);
        }
      }
      *reinterpret_cast<float4*>(gs + i * kGStride + j) =
          make_float4(out[0], out[1], out[2], out[3]);
    }

    // y starts as exp(s) (C h_in): rows i0..i0+3, columns q0..q0+QV-1
    float yacc[4][QV];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int v = 0; v < QV; ++v) yacc[r][v] = 0.0f;
    }
    for (int k4 = 0; k4 < np; k4 += 4) {
      float c4[4][4], hv[4][QV];
#pragma unroll
      for (int r = 0; r < 4; ++r) load_vec<4>(cs + (i0 + r) * row + k4,
                                              c4[r]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) load_vec<QV>(hs + (k4 + kk) * PT + q0,
                                                  hv[kk]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int v = 0; v < QV; ++v) {
            yacc[r][v] = fmaf(c4[r][kk], hv[kk][v], yacc[r][v]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = es[i0 + r];
#pragma unroll
      for (int v = 0; v < QV; ++v) yacc[r][v] *= e;
    }
    __syncthreads();

    // y += G x over j <= i0 + 3, then store
    for (int j4 = 0; j4 <= i0; j4 += 4) {
      float g4[4][4], xv[4][QV];
#pragma unroll
      for (int r = 0; r < 4; ++r) load_vec<4>(gs + (i0 + r) * kGStride + j4,
                                              g4[r]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_vec<QV>(xs + (j4 + jj) * PT + q0,
                                                  xv[jj]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int v = 0; v < QV; ++v) {
            yacc[r][v] = fmaf(g4[r][jj], xv[jj][v], yacc[r][v]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int pos = c0 + i0 + r;
      if (pos < seq) {
#pragma unroll
        for (int v = 0; v < QV; ++v) {
          if (p0 + q0 + v < p) {
            yp[pos * st.ys + q0 + v] = from_f32<TX>(yacc[r][v]);
          }
        }
      }
    }

    // h = exp(s_L) h + sum_j (b_j exp(s_L - s_j)) x_j^T, in registers
    const float decay = expf(ss[L - 1]);
#pragma unroll
    for (int m = 0; m < MK; ++m) {
      const int k0 = i0 + 64 * m;
      if (k0 >= n) continue;
      float acc[4][QV];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < QV; ++v) acc[u][v] = 0.0f;
      }
      for (int j4 = 0; j4 < L; j4 += 4) {
        float b4[4][4], xv[4][QV], w4[4];
        load_vec<4>(ws + j4, w4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          load_vec<4>(bs + (j4 + jj) * row + k0, b4[jj]);
          load_vec<QV>(xs + (j4 + jj) * PT + q0, xv[jj]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float bw = b4[jj][u] * w4[jj];
#pragma unroll
            for (int v = 0; v < QV; ++v) {
              acc[u][v] = fmaf(bw, xv[jj][v], acc[u][v]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < QV; ++v) {
          hreg[m][u][v] = fmaf(decay, hreg[m][u][v], acc[u][v]);
        }
        if (k0 + u < n) {
#pragma unroll
          for (int v = 0; v < QV; ++v) {
            hs[(k0 + u) * PT + q0 + v] = hreg[m][u][v];
          }
        }
      }
    }
  }

  float* fp = final_state + (int64_t)bh * n * p;
#pragma unroll
  for (int m = 0; m < MK; ++m) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = i0 + 64 * m + u;
      if (k >= n) continue;
#pragma unroll
      for (int v = 0; v < QV; ++v) {
        const int q = p0 + q0 + v;
        if (q < p) fp[k * p + q] = hreg[m][u][v];
      }
    }
  }
}

template <typename TX, typename TBC, int PT>
int launch(const void* x, const void* la, const void* b, const void* c,
           const void* h0, void* y, void* final_state, void* cb,
           const int64_t* s, int batch, int seq, int heads, int n, int p,
           cudaStream_t stream) {
  if (n > max_n(PT)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(n, PT) * sizeof(float);
  const size_t cb_smem = cb_smem_floats(n) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // once per template instance, at the largest size its n can ask for
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<TX, TBC, PT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(max_n(PT), PT) * sizeof(float)));
  if (attr != cudaSuccess) return (int)attr;
  static const cudaError_t cb_attr = cudaFuncSetAttribute(
      cb_kernel<TBC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(cb_smem_floats(kMaxN) * sizeof(float)));
  if (cb_attr != cudaSuccess) return (int)cb_attr;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5], s[6],
                  s[7], s[8], s[9], s[10], s[11], s[12]};
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  cb_kernel<TBC><<<dim3(n_chunks, batch), kThreads, cb_smem, stream>>>(
      (const TBC*)b, (const TBC*)c, (float*)cb, st.bb, st.bs, st.cb, st.cs,
      seq, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * heads, (p + PT - 1) / PT);
  ssd_scan_kernel<TX, TBC, PT><<<grid, kThreads, smem, stream>>>(
      (const TX*)x, (const float*)la, (const TBC*)b, (const TBC*)c,
      (const float*)cb, (const float*)h0, (TX*)y, (float*)final_state, st,
      seq, heads, n, p);
  return (int)cudaGetLastError();
}

// PT = 64 while the state fits (N <= 64), else 32
template <typename TX, typename TBC>
int launch_pt(const void* x, const void* la, const void* b, const void* c,
              const void* h0, void* y, void* final_state, void* cb,
              const int64_t* s, int batch, int seq, int heads, int n, int p,
              cudaStream_t stream) {
  if (n <= max_n(64)) {
    return launch<TX, TBC, 64>(x, la, b, c, h0, y, final_state, cb, s, batch,
                               seq, heads, n, p, stream);
  }
  return launch<TX, TBC, 32>(x, la, b, c, h0, y, final_state, cb, s, batch,
                             seq, heads, n, p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, of x and y; bc_dtype the same for b
// and c.  strides: 13 int64 values in elements, (b, s, h) of x, of y and
// of la, (b, s) of b and of c.  h0 may be null (zero initial state).  cb:
// f32 scratch of batch * ceil(seq / 64) * 64 * 64 values.  Launches the
// C B^T pass, then the scan.  Returns a cudaError_t code: 0 on successful
// launches.
int ssd_scan_fwd(const void* x, const void* la, const void* b, const void* c,
                 const void* h0, void* y, void* final_state, void* cb,
                 const int64_t* strides, int batch, int seq, int heads,
                 int n, int p, int dtype, int bc_dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n <= 0 || n > kMaxN ||
      p <= 0 || (p + 31) / 32 > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  typedef __nv_bfloat16 bf16;
#define SSD_LAUNCH(TX, TBC)                                                 \
  return launch_pt<TX, TBC>(x, la, b, c, h0, y, final_state, cb, strides,   \
                            batch, seq, heads, n, p, st)
  if (dtype == 0 && bc_dtype == 0) SSD_LAUNCH(float, float);
  if (dtype == 0 && bc_dtype == 1) SSD_LAUNCH(float, bf16);
  if (dtype == 1 && bc_dtype == 0) SSD_LAUNCH(bf16, float);
  if (dtype == 1 && bc_dtype == 1) SSD_LAUNCH(bf16, bf16);
#undef SSD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
