// Log2-binned reuse-distance histogram (paper Table 2 / §3.3.1, the
// binned profile mode), for NVIDIA Hopper (sm_90a).  Built with nvcc into
// a shared library with a plain C interface and loaded with ctypes
// (kernels/build.py, kernels/reuse_hist/reuse_hist.py).
//
// Replaces, on the TPU side of the repository:
//   * src/repro/kernels/reuse_hist/reuse_hist.py::_moments_kernel — per
//     log2 bin, the weighted count (row 0) and the weighted finite-distance
//     mass (row 1), [2, 64];
//   * src/repro/kernels/reuse_hist/reuse_hist.py::_hist_kernel — row 0
//     alone, [64].
// One kernel serves both; a template flag drops the mass row.
//
// Bins (the documented rule, docs/kernels.md): bin 0 <- D < 0 (first
// touch, INF_RD); bin 1 <- D = 0; otherwise bin = bit length of D
// (1 + floor(log2 D)), clamped to 63.  The TPU kernel computes the rule
// through a float32 log2 and lands one bin off at some powers of two and
// at 2^k - 1 for k >= 21 (ROADMAP C2); integer distances and __clzll
// follow the rule exactly at every int64 value.
//
// Precision and reproducibility: the distances arrive as int64 straight
// from the reuse-distance engine (no float cast pass) and every sum runs
// in double.  With unit weights (the pipeline's path, a flag, so no
// weight array is read) every addend is an integer, so every partial sum
// below 2^53 is exact whatever the order of the atomics: counts and
// masses are bit-reproducible from run to run.  Fractional weights may
// differ in the last bits between runs.
//
// What bounds it on the card: it reads 8 bytes per distance (plus 4 per
// weight) and does a handful of integer operations and one or two
// shared-memory atomics per element, so the bound is bytes.  This first
// version is far from it: all threads of a block add into one
// shared-memory histogram, and distances cluster in few bins, so the
// double atomics of a block contend.
//
// Design: blocks run in no order on the card, so the TPU's sequential
// accumulator block does not carry over.  Pass 1: each block folds a
// grid-stride slice of the stream into its shared-memory histogram and
// writes it to partials[block].  Pass 2: one thread per output bin sums
// the partials in block order, so the cross-block order is fixed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ int bin_of(int64_t d) {
  if (d < 0) return 0;
  if (d == 0) return 1;
  const int b = 64 - __clzll((unsigned long long)d);  // bit length
  return b < kBins - 1 ? b : kBins - 1;
}

template <bool kWeighted, bool kMoments>
__global__ void __launch_bounds__(kThreads)
reuse_hist_partials(const int64_t* __restrict__ d,
                    const float* __restrict__ w, int64_t n,
                    double* __restrict__ partials) {
  constexpr int kWidth = (kMoments ? 2 : 1) * kBins;
  __shared__ double hist[kWidth];
  for (int i = threadIdx.x; i < kWidth; i += kThreads) hist[i] = 0.0;
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const int64_t x = d[i];
    const double wt = kWeighted ? (double)w[i] : 1.0;
    const int b = bin_of(x);
    atomicAdd(&hist[b], wt);
    if (kMoments && x > 0) atomicAdd(&hist[kBins + b], wt * (double)x);
  }
  __syncthreads();
  double* out = partials + (int64_t)blockIdx.x * kWidth;
  for (int i = threadIdx.x; i < kWidth; i += kThreads) out[i] = hist[i];
}

__global__ void reuse_hist_reduce(const double* __restrict__ partials,
                                  int ctas, int width,
                                  double* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= width) return;
  double s = 0.0;
  for (int c = 0; c < ctas; ++c) s += partials[(int64_t)c * width + t];
  out[t] = s;
}

}  // namespace

extern "C" {

// out: double [2, 64] (moments != 0) or [64]; partials: double
// [ctas, width] scratch.  w may be null (unit weights).  Returns a
// cudaError_t code: 0 when both passes launched.
int reuse_hist(const void* d, const void* w, int64_t n, int moments,
               void* partials, int ctas, void* out, void* stream) {
  if (n <= 0 || ctas <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* dd = (const int64_t*)d;
  const float* ww = (const float*)w;
  double* pp = (double*)partials;
  if (moments) {
    if (w) reuse_hist_partials<true, true><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
    else reuse_hist_partials<false, true><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
  } else {
    if (w) reuse_hist_partials<true, false><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
    else reuse_hist_partials<false, false><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = (moments ? 2 : 1) * kBins;
  reuse_hist_reduce<<<1, width, 0, s>>>(pp, ctas, width, (double*)out);
  return (int)cudaGetLastError();
}

const char* reuse_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
