// Flash-attention forward (blocked online softmax) for NVIDIA Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (kernels/build.py,
// kernels/flash_attention/flash_attention.py); this file includes the
// other forms (flash_tc.cuh, flash_split.cuh in bf16 and f32,
// flash_tc_f32.cuh) and is the one translation unit.
//
// Replaces, on the TPU side of the repository:
//   * src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel —
//     one (BLK_Q, D) query tile per grid step, K/V streamed in (BLK_K, D)
//     tiles, running max / normaliser / accumulator in f32, GQA through the
//     head index map, causal KV stream cut at the diagonal tile.
//
// The function, per query row i of a (b, h) pair (kv head h / group):
//   row i sees column j  iff  j < kv_len,  when causal  j <= q_offset + i,
//                             and with a window W > 0   j > q_offset + i - W
//   out[i] = sum_j softmax_j(scale * q_i . k_j) v_j
// With q_offset = 0, kv_len = Sk and no window (W = 0) this is _flash_kernel
// (top-left causal).  The model's cache path passes q_offset = cache length
// and kv_len = cache length + new tokens, so prefill into a cache and each
// decode step run here; the window is the reference's sliding window
// (models/attention.py::_mask, mixtral), which the TPU kernel does not have.
// Every form starts its KV stream at the lowest column its rows can see, so a
// windowed call reads O(rows * (W + tile)) columns, not O(rows * kv_len).
// Without causality (an encoder, cross-attention over a source: Sq and Sk may
// differ) every row sees columns 0 .. kv_len - 1 and each form streams them
// all; the q-tile order and the diagonal masks then have no effect.
// The result is acc / max(l, 1e-30), as in the reference.  Masked scores are
// -inf against a running max that starts at -1e30 (the reference's NEG_INF):
// exp(-inf - m) is 0 even while a row has seen nothing, so a tile that lies
// wholly below a row's window edge, which a block visits before that row's
// first visible one, adds nothing to the row.  The wrapper guarantees that
// every row sees at least one column, so no row is fully masked, and the
// output equals the reference's, whose masked scores are -1e30.
//
// What bounds it on the card.  Prefill (zamba2-1.2b: Sq = 2048, D = 64,
// bf16) does 4·D operations per visible (row, column) pair on 4·S·D·2
// bytes, far above the H100's ~295 FLOP/byte ridge: operations, at the
// bf16 tensor-core rate.  A decode step (Sq = 1) reads the whole KV cache
// for one row per head: bytes.  f32 FMAs on the CUDA cores run the prefill
// at ~68x that bound, and a 64-row q tile is 63/64 padding at decode, so
// the wrapper picks one of five forms:
//   tensor-core (flash_tc.cuh)   bf16, D in {64, 96, 128}, more than kMaxRows q
//       rows per kv head: mma.sync bf16 tiles, cp.async double buffering,
//       S / softmax / O in registers (FlashAttention-2's shape);
//   split-KV (flash_split.cuh)   bf16, D in {64, 96, 128}, at most kMaxRows
//       rows per kv head (decode): the cache cut across blocks, each kv
//       head's rows together, partials merged by a second kernel;
//   split-KV f32 (flash_split.cuh)   the same for f32 decode steps, in
//       splits of 64 columns (the CUDA-core form ran them at 9x their bytes
//       bound);
//   tensor-core f32 (flash_tc_f32.cuh)   f32, D in {64, 96, 128}, more than
//       kMaxRows rows per kv head: the tensor-core form's shape with 3xTF32
//       products (each f32 operand in a TF32 high and low part, three mma a
//       product, f32 sums), which meets the f32 gates (2e-5 on the kernel,
//       1e-4 and 2e-4 on the served logits) where TF32 alone would not; the
//       f32 bound is 3x the operations at the TF32 rate (495 TFLOP/s);
//   CUDA-core (below)            f32 and bf16 at D in {8, 16, 32}.
// The tensor-core and split-KV forms read rows with 16-byte copies, so the
// wrapper sends them only 16-byte-aligned tensors whose (b, h, s) strides
// are multiples of 16 bytes (8 bf16, 4 f32 elements); anything else goes to
// the CUDA-core form.
//
// CUDA-core form: one block of 256 threads per (q tile of 64 rows, head,
// batch).  Q (pre-scaled, f32) and each K/V tile (converted to f32 on load)
// sit in shared memory; scores, the softmax and P·V are plain f32 FMAs:
//   S = Q K^T   each thread owns one column c = t % 64 and 16 rows,
//               reads K[c][:] (rows padded to D+1: no bank conflicts) once
//               per d and broadcasts Q[r][d];
//   softmax     four threads per row, combined with warp shuffles;
//   O += P V    C = min(D, 32) threads along a row: each thread owns the
//               output columns d = t % C + C u (D / C of them; 3 at D = 96)
//               and the rows t / C + (256 / C) i in registers, and reads
//               V[j][d] once per j: a warp reads one V row's 32 neighbouring
//               floats and one broadcast P value.
// Ragged tails of Sq and Sk are masked in the loads (zeros) and the store.
// The KV loop runs from the tile holding the first row's window edge to the
// last tile a row of the q tile can see.
//
// Strides are in elements; the last dimension of q, k, v and o must be
// contiguous.  The wrapper guarantees kv_len >= 1, q_offset >= 0 and, with a
// window, that the last row sees a column, so no row is fully masked.

#include "flash_common.cuh"
#include "flash_split.cuh"
#include "flash_tc.cuh"
#include "flash_tc_f32.cuh"

namespace flash_simt {

using namespace flash;

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;

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
simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, Strides sq_,
            Strides sk_, Strides sv_, Strides so_, int sq, int group,
            int kv_len, int q_offset, int causal, int window, float scale) {
  static_assert(kThreads % kBlockK == 0, "tiling");
  static_assert(kBlockQ * 4 == kThreads, "four softmax threads per row");
  constexpr int kRowsS = kBlockQ * kBlockK / kThreads;  // 16 score rows
  constexpr int kRowStepS = kThreads / kBlockK;         // 4
  constexpr int kColThreads = D < 32 ? D : 32;          // threads along a row
  constexpr int kColsO = D / kColThreads;               // columns per thread
  constexpr int kRowStepO = kThreads / kColThreads;
  constexpr int kRowsO = kBlockQ / kRowStepO;           // rows per thread
  static_assert(D % kColThreads == 0 && kThreads % kColThreads == 0 &&
                    kBlockQ % kRowStepO == 0,
                "P V tiling");

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

  // the tiles from the first row's window edge to the last column any row
  // of this tile can see
  const int last_row = min(q0 + kBlockQ, sq) - 1;
  const int visible = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  const int n_tiles = (visible + kBlockK - 1) / kBlockK;
  const int first_tile =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBlockK : 0;

  float acc[kRowsO][kColsO];
#pragma unroll
  for (int i = 0; i < kRowsO; ++i) {
#pragma unroll
    for (int u = 0; u < kColsO; ++u) acc[i][u] = 0.0f;
  }

  const int c_s = t % kBlockK;     // score column of this thread
  const int r_s = t / kBlockK;     // first score row
  const int d_o = t % kColThreads;  // first output column of this thread
  const int r_o = t / kColThreads;  // first output row
  const int r_sm = t / 4;          // softmax row
  const int part = t % 4;          // softmax quarter of that row

  for (int tile = first_tile; tile < n_tiles; ++tile) {
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
      const int pos = q_offset + q0 + r;
      const bool ok = col < kv_len && (!causal || col <= pos) &&
                      (window <= 0 || col > pos - window);
      ps[r * (kBlockK + 1) + c_s] = ok ? s[i] : -INFINITY;
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
    for (int i = 0; i < kRowsO; ++i) {
      const float alpha = a_s[r_o + kRowStepO * i];
#pragma unroll
      for (int u = 0; u < kColsO; ++u) acc[i][u] *= alpha;
    }
    for (int j = 0; j < kBlockK; ++j) {
      float vv[kColsO];
#pragma unroll
      for (int u = 0; u < kColsO; ++u) vv[u] = vs[j * D + d_o + kColThreads * u];
#pragma unroll
      for (int i = 0; i < kRowsO; ++i) {
        const float p = ps[(r_o + kRowStepO * i) * (kBlockK + 1) + j];
#pragma unroll
        for (int u = 0; u < kColsO; ++u) acc[i][u] = fmaf(p, vv[u], acc[i][u]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kRowsO; ++i) {
    const int r = r_o + kRowStepO * i;
    const int row = q0 + r;
    if (row < sq) {
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int u = 0; u < kColsO; ++u) {
        op[row * so_.s + d_o + kColThreads * u] = from_f32<T>(acc[i][u] / l);
      }
    }
  }
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, T* o, const Strides (&st)[4],
           int batch, int heads, int sq, int group, int kv_len, int q_offset,
           int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  // once per template instance, not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      simt_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  simt_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, st[0], st[1], st[2], st[3], sq, group, kv_len, q_offset,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash_simt

namespace {

using flash::bf16;
using flash::Strides;

template <int D>
int launch_bf16(int form, const bf16* q, const bf16* k, const bf16* v,
                bf16* o, float* lse, bf16* o_lo, const Strides (&st)[4],
                int batch, int heads, int sq, int kv_heads, int group,
                int kv_len, int q_offset, int causal, int window,
                float scale, int n_splits, float* part_ml, float* part_acc,
                cudaStream_t s) {
  if (form == 1) {
    return flash_tc::launch<D>(q, k, v, o, lse, o_lo, st, batch, heads, sq,
                               group, kv_len, q_offset, causal, window, scale,
                               s);
  }
  return flash_split::launch<bf16, D>(q, k, v, o, lse, o_lo, st, batch,
                                      kv_heads, sq, group, kv_len, q_offset,
                                      causal, window, scale, n_splits,
                                      part_ml, part_acc, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  form: 0 = CUDA-core, 1 = tensor-core,
// 2 = split-KV (forms 1 and 2: bf16, head_dim 64, 96 or 128), 3 =
// tensor-core f32, 4 = split-KV f32 (forms 3 and 4: f32, head_dim 64, 96 or
// 128).  strides: 12 int64 values, (b, h, s) for q, k, v, o in elements.
// window: 0 = none, else W >= 1 (the last row must see a column: q_offset +
// sq - W < kv_len).  Split-KV only (forms 2 and 4): n_splits splits of
// flash_attention_split_columns(dtype) columns (those from the first row's
// window edge to the last visible column), and f32 scratch part_ml [batch,
// kv_heads, n_splits, rows, 2] and part_acc [batch, kv_heads, n_splits,
// rows, head_dim], rows = heads / kv_heads * sq <=
// flash_attention_split_max_rows().  lse and o_lo: both null, or (forms 1
// and 2, a training step's forward) f32 [batch, heads, sq] for each row's
// ln sum_j e^{scale s_ij} and a bf16 tensor of o's shape and strides for
// o's rounding residual, which the backward's tensor-core form reads.  Form
// 3: o_lo null, lse null or (under autograd) the log-sum-exp alone.  Forms 0
// and 4: both null.  Returns a cudaError_t code: 0 on a successful launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const int64_t* strides, int batch, int heads, int sq,
                        int kv_heads, int kv_len, int q_offset, int causal,
                        int window, float scale, int head_dim, int dtype,
                        int form,
                        int n_splits, void* part_ml, void* part_acc,
                        void* lse, void* o_lo, void* stream) {
  if (batch <= 0 || heads <= 0 || sq <= 0 || kv_heads <= 0 ||
      heads % kv_heads != 0 || kv_len <= 0 || q_offset < 0 || window < 0 ||
      (window > 0 && (long long)q_offset + sq - window >= kv_len) ||
      batch > 65535 || form < 0 || form > 4 ||
      ((form == 0 || form == 4) && (lse || o_lo)) ||
      ((form == 1 || form == 2) && !lse != !o_lo) || (form == 3 && o_lo)) {
    return (int)cudaErrorInvalidValue;
  }
  const int group = heads / kv_heads;
  cudaStream_t s = (cudaStream_t)stream;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  if (form == 3) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
#define FLASH_F32(D)                                                        \
  return flash_tc_f32::launch<D>((const float*)q, (const float*)k,          \
                                 (const float*)v, (float*)o, (float*)lse,   \
                                 st, batch, heads, sq, group, kv_len,       \
                                 q_offset, causal, window, scale, s)
    if (head_dim == 64) FLASH_F32(64);
    if (head_dim == 96) FLASH_F32(96);
    if (head_dim == 128) FLASH_F32(128);
#undef FLASH_F32
    return (int)cudaErrorInvalidValue;
  }
  if (form == 4) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
#define FLASH_SPLIT_F32(D)                                                  \
  return flash_split::launch<float, D>(                                     \
      (const float*)q, (const float*)k, (const float*)v, (float*)o, nullptr, \
      nullptr, st, batch, kv_heads, sq, group, kv_len, q_offset, causal,    \
      window, scale, n_splits, (float*)part_ml, (float*)part_acc, s)
    if (head_dim == 64) FLASH_SPLIT_F32(64);
    if (head_dim == 96) FLASH_SPLIT_F32(96);
    if (head_dim == 128) FLASH_SPLIT_F32(128);
#undef FLASH_SPLIT_F32
    return (int)cudaErrorInvalidValue;
  }
  if (form != 0) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    const bf16 *qb = (const bf16*)q, *kb = (const bf16*)k,
               *vb = (const bf16*)v;
    bf16* ob = (bf16*)o;
#define FLASH_BF16(D)                                                       \
  return launch_bf16<D>(form, qb, kb, vb, ob, (float*)lse, (bf16*)o_lo, st, \
                        batch, heads, sq, kv_heads, group, kv_len, q_offset,\
                        causal, window, scale, n_splits, (float*)part_ml,   \
                        (float*)part_acc, s)
    if (head_dim == 64) FLASH_BF16(64);
    if (head_dim == 96) FLASH_BF16(96);
    if (head_dim == 128) FLASH_BF16(128);
#undef FLASH_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (heads > 65535) return (int)cudaErrorInvalidValue;
#define FLASH_LAUNCH(T, D)                                                  \
  return flash_simt::launch<T, D>((const T*)q, (const T*)k, (const T*)v,    \
                                  (T*)o, st, batch, heads, sq, group,       \
                                  kv_len, q_offset, causal, window, scale,  \
                                  s)
#define FLASH_DIMS(T)                       \
  switch (head_dim) {                       \
    case 8: FLASH_LAUNCH(T, 8);             \
    case 16: FLASH_LAUNCH(T, 16);           \
    case 32: FLASH_LAUNCH(T, 32);           \
    case 64: FLASH_LAUNCH(T, 64);           \
    case 96: FLASH_LAUNCH(T, 96);           \
    case 128: FLASH_LAUNCH(T, 128);         \
    default: return (int)cudaErrorInvalidValue; \
  }
  if (dtype == 0) FLASH_DIMS(float);
  if (dtype == 1) FLASH_DIMS(bf16);
#undef FLASH_DIMS
#undef FLASH_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Columns a split of the split-KV form in dtype (0 = float32, 1 =
// bfloat16); -1 for another dtype.
int flash_attention_split_columns(int dtype) {
  return dtype == 0   ? flash_split::Split<float>::kColumns
         : dtype == 1 ? flash_split::Split<bf16>::kColumns
                      : -1;
}

int flash_attention_split_max_rows(void) { return flash_split::kMaxRows; }

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
