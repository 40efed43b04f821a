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
// (f32 or bf16, P contiguous), la [B, S, H] f32, b and c [B, S, N] f32 (one
// B/C stream shared by the H heads, N contiguous); y [B, S, H, P] in x's
// type, final [B, H, N, P] f32 contiguous.  The TPU signature [BH, S, P] is
// the case H = 1.
//
// What bounds it on the card: per (b, h) and chunk it does about
// L^2 N + 2 L^2 P + 2 L N P multiply-adds on L (P + 2N + 1) input floats, so
// at N = P = 64, L = 64 it is ~150 FLOP per byte read; at the serving shape
// (B*H = 256, S = 2048) its bytes bound (f32 x in, y out) and its operations
// bound are of the same order, both well under 0.1 ms.
//
// Design: this is the first, simple version.  Blocks run in no order, so
// the sequential chunk grid of the TPU kernel becomes a loop inside one
// block of 256 threads per (b, h).  The [N, P] state lives in dynamic shared
// memory (16 KB at N = P = 64, 32 KB at N = 128) beside the chunk's x, b, c
// (rows padded to N + 1), cumulative decays and the [L, L] score tile; L is
// fixed at 64 so that N = 128 still fits (132 KB).  All products are f32
// FMAs on the CUDA cores, one output element per thread per step of a
// strided loop (no wgmma yet).  A ragged last chunk is padded with zeros
// (la = 0, b = c = x = 0), which leaves y and the state exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;
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

struct Strides {
  int64_t xb, xs, xh;  // x
  int64_t yb, ys, yh;  // y
  int64_t lb, ls, lh;  // la
  int64_t bb, bs;      // b
  int64_t cb, cs;      // c
};

size_t smem_floats(int n, int p) {
  const size_t L = kChunk;
  return (size_t)n * p            // state
         + L * p                  // x chunk
         + 2 * L * (n + 1)        // b, c chunks, padded rows
         + L * (L + 1)            // scores
         + 3 * L;                 // s, exp(s), exp(s_L - s)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ la,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ final_state, Strides st, int seq,
                int heads, int n, int p) {
  constexpr int L = kChunk;
  extern __shared__ float smem[];
  float* hs = smem;                 // [n][p]
  float* xs = hs + n * p;           // [L][p]
  float* bs = xs + L * p;           // [L][n+1]
  float* cs = bs + L * (n + 1);     // [L][n+1]
  float* sc = cs + L * (n + 1);     // [L][L+1]
  float* ss = sc + L * (L + 1);     // [L] inclusive cumsum of la
  float* es = ss + L;               // [L] exp(s)
  float* ws = es + L;               // [L] exp(s_L - s)

  const int t = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh % heads;
  const int np = n * p;
  const T* xp = x + b * st.xb + h * st.xh;
  T* yp = y + b * st.yb + h * st.yh;
  const float* lp = la + b * st.lb + h * st.lh;
  const float* bp = bm + b * st.bb;
  const float* cp = cm + b * st.cb;
  float* fp = final_state + (int64_t)bh * np;

  for (int e = t; e < np; e += kThreads) {
    hs[e] = h0 ? h0[(int64_t)bh * np + e] : 0.0f;
  }

  for (int c0 = 0; c0 < seq; c0 += L) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = t; e < L * p; e += kThreads) {
      const int i = e / p, q = e % p;
      const int pos = c0 + i;
      xs[e] = pos < seq ? to_f32(xp[pos * st.xs + q]) : 0.0f;
    }
    for (int e = t; e < L * n; e += kThreads) {
      const int i = e / n, k = e % n;
      const int pos = c0 + i;
      const bool ok = pos < seq;
      bs[i * (n + 1) + k] = ok ? bp[pos * st.bs + k] : 0.0f;
      cs[i * (n + 1) + k] = ok ? cp[pos * st.cs + k] : 0.0f;
    }
    if (t < L) ss[t] = c0 + t < seq ? lp[(c0 + t) * st.ls] : 0.0f;
    __syncthreads();
    if (t == 0) {
      float run = 0.0f;
      for (int i = 0; i < L; ++i) {
        run += ss[i];
        ss[i] = run;
      }
    }
    __syncthreads();
    const float s_last = ss[L - 1];
    if (t < L) {
      es[t] = expf(ss[t]);
      ws[t] = expf(s_last - ss[t]);
    }

    // intra-chunk scores: (c_i . b_j) exp(s_i - s_j) for j <= i
    for (int e = t; e < L * L; e += kThreads) {
      const int i = e / L, j = e % L;
      float v = 0.0f;
      if (j <= i) {
        const float* ci = cs + i * (n + 1);
        const float* bj = bs + j * (n + 1);
        for (int k = 0; k < n; ++k) v = fmaf(ci[k], bj[k], v);
        v *= expf(ss[i] - ss[j]);
      }
      sc[i * (L + 1) + j] = v;
    }
    __syncthreads();

    // y = scores x + exp(s) (c h_in)
    for (int e = t; e < L * p; e += kThreads) {
      const int i = e / p, q = e % p;
      if (c0 + i >= seq) continue;
      const float* si = sc + i * (L + 1);
      float intra = 0.0f;
      for (int j = 0; j <= i; ++j) intra = fmaf(si[j], xs[j * p + q], intra);
      const float* ci = cs + i * (n + 1);
      float inter = 0.0f;
      for (int k = 0; k < n; ++k) inter = fmaf(ci[k], hs[k * p + q], inter);
      yp[(c0 + i) * st.ys + q] = from_f32<T>(intra + es[i] * inter);
    }
    __syncthreads();  // every reader of h_in is done

    // h_out = exp(s_L) h_in + (b * exp(s_L - s))^T x
    const float decay = expf(s_last);
    for (int e = t; e < np; e += kThreads) {
      const int k = e / p, q = e % p;
      float acc = 0.0f;
      for (int j = 0; j < L; ++j) {
        acc = fmaf(bs[j * (n + 1) + k] * ws[j], xs[j * p + q], acc);
      }
      hs[e] = decay * hs[e] + acc;
    }
  }
  __syncthreads();
  for (int e = t; e < np; e += kThreads) fp[e] = hs[e];
}

template <typename T>
int launch(const void* x, const void* la, const void* b, const void* c,
           const void* h0, void* y, void* final_state, const int64_t* s,
           int batch, int seq, int heads, int n, int p, cudaStream_t stream) {
  const size_t smem = smem_floats(n, p) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides st{s[0], s[1], s[2],  s[3],  s[4],  s[5], s[6],
                  s[7], s[8], s[9], s[10], s[11], s[12]};
  ssd_scan_kernel<T><<<batch * heads, kThreads, smem, stream>>>(
      (const T*)x, (const float*)la, (const float*)b, (const float*)c,
      (const float*)h0, (T*)y, (float*)final_state, st, seq, heads, n, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y).  strides: 13 int64 values in
// elements, (b, s, h) of x, of y and of la, (b, s) of b and of c.
// h0 may be null (zero initial state).  Returns a cudaError_t code: 0 on a
// successful launch.
int ssd_scan_fwd(const void* x, const void* la, const void* b, const void* c,
                 const void* h0, void* y, void* final_state,
                 const int64_t* strides, int batch, int seq, int heads,
                 int n, int p, int dtype, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || n <= 0 || p <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(x, la, b, c, h0, y, final_state, strides, batch, seq,
                         heads, n, p, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, la, b, c, h0, y, final_state, strides,
                                 batch, seq, heads, n, p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of dynamic shared memory a launch at (n, p) needs.
int64_t ssd_scan_smem_bytes(int n, int p) {
  return (int64_t)(smem_floats(n, p) * sizeof(float));
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
