// Flash-attention forward (blocked online softmax) for NVIDIA Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (kernels/build.py,
// kernels/flash_attention/flash_attention.py).
//
// Replaces, on the TPU side of the repository:
//   * src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel —
//     one (BLK_Q, D) query tile per grid step, K/V streamed in (BLK_K, D)
//     tiles, running max / normaliser / accumulator in f32, GQA through the
//     head index map, causal KV stream cut at the diagonal tile.
//
// The function, per query row i of a (b, h) pair (kv head h / group):
//   row i sees column j  iff  j < kv_len  and, when causal,  j <= q_offset + i
//   out[i] = sum_j softmax_j(scale * q_i . k_j) v_j
// With q_offset = 0 and kv_len = Sk this is _flash_kernel (top-left causal).
// The model's cache path passes q_offset = cache length and kv_len = cache
// length + new tokens, so prefill into a cache and each decode step run here.
// Masked scores are -1e30 (the reference's NEG_INF, not -inf) and the result
// is acc / max(l, 1e-30), as in the reference.
//
// What bounds it on the card: at the serving shapes (D = 64, Sq = Sk = 2048)
// the work is 4·Sq·Sk·D/2 causal FLOPs against (3 + 1)·S·D·2 bytes, far
// above the H100's ~295 FLOP/byte ridge, so the bound is operations
// (tensor-core bf16 rate).  At decode (Sq = 1) it is the bytes of the KV
// cache.
//
// Design: this is the first, simple version.  One block of 256 threads per
// (q tile of 64 rows, head, batch).  Q (pre-scaled, f32) and each K/V tile
// (converted to f32 on load) sit in shared memory; scores, the softmax and
// P·V are plain f32 FMAs on the CUDA cores (no wgmma or TMA yet):
//   S = Q K^T   each thread owns one column c = t % 64 and 16 rows,
//               reads K[c][:] (rows padded to D+1: no bank conflicts) once
//               per d and broadcasts Q[r][d];
//   softmax     four threads per row, combined with warp shuffles;
//   O += P V    each thread owns one output column d = t % D and D / 4
//               rows in registers, reads V[j][d] once per j.
// The head dim D is a template parameter: 8, 16, 32, 64 or 128 (the
// serving models use 64; the reduced test configs 8).
// Ragged tails of Sq and Sk are masked in the loads (zeros) and the store.
// The KV loop ends at the last tile a row of the q tile can see.
//
// Strides are in elements; the last dimension of q, k, v and o must be
// contiguous.  The wrapper guarantees kv_len >= 1 and q_offset >= 0, so
// every row sees column 0 and no row is fully masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

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
  int64_t b, h, s;
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBlockQ * D            // Q tile, scaled
         + (size_t)kBlockK * (D + 1)    // K tile, padded rows
         + (size_t)kBlockK * D          // V tile
         + (size_t)kBlockQ * (kBlockK + 1)  // scores / probabilities
         + 3 * kBlockQ;                 // running max, normaliser, rescale
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, Strides sq_,
                 Strides sk_, Strides sv_, Strides so_, int sq, int group,
                 int kv_len, int q_offset, int causal, float scale) {
  static_assert(kThreads % D == 0 && kThreads % kBlockK == 0, "tiling");
  static_assert(kBlockQ * 4 == kThreads, "four softmax threads per row");
  constexpr int kRowsS = kBlockQ * kBlockK / kThreads;  // 16 score rows
  constexpr int kRowStepS = kThreads / kBlockK;         // 4
  constexpr int kRowsO = kBlockQ * D / kThreads;        // D / 4
  constexpr int kRowStepO = kThreads / D;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * D;
  float* vs = ks + kBlockK * (D + 1);
  float* ps = vs + kBlockK * D;
  float* m_s = ps + kBlockQ * (kBlockK + 1);
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qp = q + b * sq_.b + h * sq_.h;
  const T* kp = k + b * sk_.b + hk * sk_.h;
  const T* vp = v + b * sv_.b + hk * sv_.h;
  T* op = o + b * so_.b + h * so_.h;

  for (int e = t; e < kBlockQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const int row = q0 + r;
    qs[e] = row < sq ? to_f32(qp[row * sq_.s + d]) * scale : 0.0f;
  }
  if (t < kBlockQ) {
    m_s[t] = kNegInf;
    l_s[t] = 0.0f;
  }

  // last column any row of this tile can see, then the tiles up to it
  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int visible = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (visible + kBlockK - 1) / kBlockK;

  float acc[kRowsO];
#pragma unroll
  for (int i = 0; i < kRowsO; ++i) acc[i] = 0.0f;

  const int c_s = t % kBlockK;     // score column of this thread
  const int r_s = t / kBlockK;     // first score row
  const int d_o = t % D;           // output column of this thread
  const int r_o = t / D;           // first output row
  const int r_sm = t / 4;          // softmax row
  const int part = t % 4;          // softmax quarter of that row

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int j0 = tile * kBlockK;
    __syncthreads();  // previous tile's readers are done
    for (int e = t; e < kBlockK * D; e += kThreads) {
      const int j = e / D, d = e % D;
      const bool ok = j0 + j < kv_len;
      ks[j * (D + 1) + d] = ok ? to_f32(kp[(j0 + j) * sk_.s + d]) : 0.0f;
      vs[j * D + d] = ok ? to_f32(vp[(j0 + j) * sv_.s + d]) : 0.0f;
    }
    __syncthreads();

    // S = Q K^T with the mask
    float s[kRowsS];
#pragma unroll
    for (int i = 0; i < kRowsS; ++i) s[i] = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float kv = ks[c_s * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsS; ++i) {
        s[i] = fmaf(qs[(r_s + kRowStepS * i) * D + d], kv, s[i]);
      }
    }
    const int col = j0 + c_s;
#pragma unroll
    for (int i = 0; i < kRowsS; ++i) {
      const int r = r_s + kRowStepS * i;
      const bool ok = col < kv_len && (!causal || col <= q_offset + q0 + r);
      ps[r * (kBlockK + 1) + c_s] = ok ? s[i] : kNegInf;
    }
    __syncthreads();

    // online softmax: four threads per row
    {
      float* prow = ps + r_sm * (kBlockK + 1);
      float mx = kNegInf;
      for (int c = part; c < kBlockK; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r_sm];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = part; c < kBlockK; c += 4) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r_sm] = m_new;
        l_s[r_sm] = l_s[r_sm] * alpha + sum;
        a_s[r_sm] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int i = 0; i < kRowsO; ++i) acc[i] *= a_s[r_o + kRowStepO * i];
    for (int j = 0; j < kBlockK; ++j) {
      const float vv = vs[j * D + d_o];
#pragma unroll
      for (int i = 0; i < kRowsO; ++i) {
        acc[i] = fmaf(ps[(r_o + kRowStepO * i) * (kBlockK + 1) + j], vv,
                      acc[i]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsO; ++i) {
    const int r = r_o + kRowStepO * i;
    const int row = q0 + r;
    if (row < sq) {
      op[row * so_.s + d_o] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int64_t* st, int batch, int heads, int sq, int group,
           int kv_len, int q_offset, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides s_q{st[0], st[1], st[2]}, s_k{st[3], st[4], st[5]},
      s_v{st[6], st[7], st[8]}, s_o{st[9], st[10], st[11]};
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s_q, s_k, s_v, s_o, sq,
      group, kv_len, q_offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 int64 values, (b, h, s)
// for q, k, v, o in elements.  Returns a cudaError_t code: 0 on a
// successful launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const int64_t* strides, int batch, int heads, int sq,
                        int kv_heads, int kv_len, int q_offset, int causal,
                        float scale, int head_dim, int dtype, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || kv_len <= 0 || q_offset < 0 ||
      heads > 65535 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = heads / kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_LAUNCH(T, D)                                                  \
  return launch<T, D>(q, k, v, o, strides, batch, heads, sq, group, kv_len, \
                      q_offset, causal, scale, s)
#define FLASH_DIMS(T)                       \
  switch (head_dim) {                       \
    case 8: FLASH_LAUNCH(T, 8);             \
    case 16: FLASH_LAUNCH(T, 16);           \
    case 32: FLASH_LAUNCH(T, 32);           \
    case 64: FLASH_LAUNCH(T, 64);           \
    case 128: FLASH_LAUNCH(T, 128);         \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) FLASH_DIMS(float);
  if (dtype == 1) FLASH_DIMS(__nv_bfloat16);
#undef FLASH_DIMS
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
