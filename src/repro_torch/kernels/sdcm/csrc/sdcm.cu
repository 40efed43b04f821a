// SDCM hit probability P(h|D) (paper Eq. 1) and its Eq. 3 row fold, for
// NVIDIA Hopper (sm_90a).  Built with nvcc into a shared library with a
// plain C interface and loaded with ctypes (kernels/build.py,
// kernels/sdcm/sdcm.py).
//
// Replaces, on the TPU side of the repository:
//   * src/repro/kernels/sdcm/sdcm.py::_sdcm_kernel — P(h|D) for a flat
//     stream of distances, A fixed at compile time, one (8, 128) VMEM
//     tile per grid step;
//   * src/repro/api/batched.py::_phit_row / _grid_fn — the vmapped
//     per-row form with run-time A and B that the served grid evaluates
//     (padded [G, M] profiles, Eq. 3 row sums).
// One device function, sdcm_phit<A_MAX>, serves every entry point: A and
// B arrive at run time, and the template bucket A_MAX (8/16/32/64) only
// bounds the unrolled term loop.
//
// Maths, per element (the reference's rules, in its order):
//   D = -1 (first touch)        -> 0
//   A >= B (fully associative)  -> [D < B]        (exact LRU stack rule)
//   D <= A - 1                  -> 1
//   otherwise p = clip(A/B, 1e-30, 1 - 1e-7) and
//     P = min(1, sum_{k<A} exp(log C(D,k) + k log p + (D-k) log(1-p))),
//   with log C(D,k) built incrementally (sum of log((D-j+1)/j)).  Here
//   D >= A, so min(A, D+1) = A terms.  A set-associative row with
//   A > A_MAX yields NaN, so a caller's wrong bucket cannot pass silently.
//
// Precision: the term sum runs in double and the Eq. 3 fold accumulates
// in double.  The reference evaluates in float32; double keeps the grid
// well inside the 1e-6 hit-rate bound against the float64 oracle at the
// large distances of million-reference traces.
//
// What bounds it on the card: the per-reference form (sdcm_hit_probs)
// reads 4 and writes 4 bytes per element but evaluates ~2·A double
// log/exp per element, so it is bound by operations, not bytes.  The grid
// form at the prediction path's size (tens of rows, a few thousand
// entries) is far below a microsecond of work at either bound; what a
// predict paid for it was the host: four launches (one per row-shape
// group), three copies and one synchronisation each.
//
// Design: each row folds in one block: each thread takes a strided slice
// of the row in a fixed order, and a shared-memory tree combines the
// partial sums in a fixed order — no atomics — so a row's bits depend on
// that row alone and are the same whether it is launched alone or inside
// any batch (composition invariance).  Two grid entry points share that
// fold (rate_row):
//   * sdcm_rates — one row-shape group, padded [G, M], one A_MAX bucket;
//   * sdcm_rates_ragged — every row of a predict in one launch: rows lie
//     back to back at their own lengths, and a per-row record gives the
//     offset, length, A, B and A_MAX bucket.  Each block branches once,
//     block-uniformly, on its row's bucket.  A padded group's padding
//     entries (probability 0) add +0.0 to a thread's sum, so a row gives
//     the same bits in both forms.
// There is no matrix product, so wgmma and TMA do not apply.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRateThreads = 128;   // threads per row in the grid form
constexpr int kProbThreads = 256;   // threads per block, per-reference form
constexpr int64_t kMaxProbBlocks = 1 << 20;
constexpr int kMetaWidth = 5;       // (offset, length, A, B, A_MAX) a row

template <int A_MAX>
__device__ __forceinline__ double sdcm_phit(double d, double assoc,
                                            double blocks) {
  if (d < 0.0) return 0.0;                             // INF_RD
  if (assoc >= blocks) return d < blocks ? 1.0 : 0.0;  // fully associative
  if (d <= assoc - 1.0) return 1.0;
  if (assoc > (double)A_MAX) return CUDART_NAN;
  const double p = fmin(fmax(assoc / blocks, 1e-30), 1.0 - 1e-7);
  const double log_p = log(p);
  const double log_1mp = log1p(-p);
  const int a = (int)assoc;
  double acc = exp(d * log_1mp);  // k = 0 term: (1-p)^D
  double log_comb = 0.0;
#pragma unroll
  for (int k = 1; k < A_MAX; ++k) {
    if (k >= a) break;
    const double kf = (double)k;
    log_comb = log_comb + (log(d - kf + 1.0) - log(kf));
    acc += exp(log_comb + kf * log_p + (d - kf) * log_1mp);
  }
  return fmin(acc, 1.0);
}

// Eq. 3 fold of one row of ``len`` entries; every thread of the block
// calls it and gets the row's rate.
template <int A_MAX>
__device__ __forceinline__ double rate_row(const double* __restrict__ dr,
                                           const double* __restrict__ pr,
                                           int64_t len, double a, double b,
                                           double* part) {
  double s = 0.0;
  for (int64_t i = threadIdx.x; i < len; i += kRateThreads) {
    s += pr[i] * sdcm_phit<A_MAX>(dr[i], a, b);
  }
  part[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int off = kRateThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) part[threadIdx.x] += part[threadIdx.x + off];
    __syncthreads();
  }
  return part[0];
}

// Grid form: rates[g] = sum_m probs[g, m] * P(h | d[g, m]; assoc[g], blocks[g]).
template <int A_MAX>
__global__ void __launch_bounds__(kRateThreads)
sdcm_rates_kernel(const double* __restrict__ d,
                  const double* __restrict__ probs,
                  const double* __restrict__ assoc,
                  const double* __restrict__ blocks,
                  double* __restrict__ rates, int m) {
  __shared__ double part[kRateThreads];
  const int g = blockIdx.x;
  const double r = rate_row<A_MAX>(d + (int64_t)g * m, probs + (int64_t)g * m,
                                   m, assoc[g], blocks[g], part);
  if (threadIdx.x == 0) rates[g] = r;
}

// Ragged grid form: row r is d[off, off + len) with meta[r] = (off, len,
// A, B, A_MAX) as doubles (exact integers).  A record out of [0, total)
// or with another bucket gives NaN, as a wrong bucket does.
__global__ void __launch_bounds__(kRateThreads)
sdcm_rates_ragged_kernel(const double* __restrict__ d,
                         const double* __restrict__ probs,
                         const double* __restrict__ meta, int64_t total,
                         double* __restrict__ rates) {
  __shared__ double part[kRateThreads];
  const double* rec = meta + (int64_t)blockIdx.x * kMetaWidth;
  const int64_t off = (int64_t)rec[0], len = (int64_t)rec[1];
  const double a = rec[2], b = rec[3];
  double r = CUDART_NAN;
  if (off >= 0 && len >= 0 && off + len <= total) {
    const double* dr = d + off;
    const double* pr = probs + off;
    switch ((int)rec[4]) {  // the same for every thread of the block
      case 8: r = rate_row<8>(dr, pr, len, a, b, part); break;
      case 16: r = rate_row<16>(dr, pr, len, a, b, part); break;
      case 32: r = rate_row<32>(dr, pr, len, a, b, part); break;
      case 64: r = rate_row<64>(dr, pr, len, a, b, part); break;
      default: break;
    }
  }
  if (threadIdx.x == 0) rates[blockIdx.x] = r;
}

// Per-reference form: out[i] = P(h | d[i]) for one (assoc, blocks).
template <int A_MAX>
__global__ void __launch_bounds__(kProbThreads)
sdcm_hit_probs_kernel(const float* __restrict__ d, float* __restrict__ out,
                      int64_t n, double assoc, double blocks) {
  const int64_t step = (int64_t)gridDim.x * kProbThreads;
  for (int64_t i = (int64_t)blockIdx.x * kProbThreads + threadIdx.x; i < n;
       i += step) {
    out[i] = (float)sdcm_phit<A_MAX>((double)d[i], assoc, blocks);
  }
}

}  // namespace

#define SDCM_DISPATCH(A_MAX_VALUE, LAUNCH) \
  switch (A_MAX_VALUE) {                   \
    case 8: LAUNCH(8); break;              \
    case 16: LAUNCH(16); break;            \
    case 32: LAUNCH(32); break;            \
    case 64: LAUNCH(64); break;            \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" {

// Returns a cudaError_t code: 0 on a successful launch.
int sdcm_rates(const void* d, const void* probs, const void* assoc,
               const void* blocks, void* rates, int g, int m, int a_max,
               void* stream) {
  if (g <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SDCM_RATES_LAUNCH(A)                                              \
  sdcm_rates_kernel<A><<<g, kRateThreads, 0, s>>>(                        \
      (const double*)d, (const double*)probs, (const double*)assoc,       \
      (const double*)blocks, (double*)rates, m)
  SDCM_DISPATCH(a_max, SDCM_RATES_LAUNCH)
#undef SDCM_RATES_LAUNCH
  return (int)cudaGetLastError();
}

// d, probs: double [total]; meta: double [rows, 5]; rates: double [rows].
int sdcm_rates_ragged(const void* d, const void* probs, const void* meta,
                      int64_t total, void* rates, int rows, void* stream) {
  if (rows <= 0 || total < 0) return (int)cudaErrorInvalidValue;
  sdcm_rates_ragged_kernel<<<rows, kRateThreads, 0, (cudaStream_t)stream>>>(
      (const double*)d, (const double*)probs, (const double*)meta, total,
      (double*)rates);
  return (int)cudaGetLastError();
}

int sdcm_hit_probs(const void* d, void* out, int64_t n, double assoc,
                   double blocks, int a_max, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int64_t nb = (n + kProbThreads - 1) / kProbThreads;
  const int grid = (int)(nb < kMaxProbBlocks ? nb : kMaxProbBlocks);
#define SDCM_PROBS_LAUNCH(A)                                              \
  sdcm_hit_probs_kernel<A><<<grid, kProbThreads, 0, s>>>(                 \
      (const float*)d, (float*)out, n, assoc, blocks)
  SDCM_DISPATCH(a_max, SDCM_PROBS_LAUNCH)
#undef SDCM_PROBS_LAUNCH
  return (int)cudaGetLastError();
}

const char* sdcm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
