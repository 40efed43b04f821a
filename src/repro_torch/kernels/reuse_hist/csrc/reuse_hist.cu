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
// What bounds it on the card: it reads 8 bytes per distance (plus 4 per
// weight) and does a few dozen integer operations per element, so the
// bound is bytes.  What held the first version back was contention:
// distances cluster in few bins, and every thread of a block added into
// one shared histogram of doubles, so the adds of a block queued on the
// same few addresses.
//
// Design, unit weights (the pipeline's path: FusedReuseHistogram passes
// no weights, so no weight array is read):
//   * Each lane loads two distances at once (16-byte longlong2 loads,
//     grid-stride; an unaligned head and an odd tail element go through
//     one extra round of the first warp).
//   * Lanes of a warp that hold the same bin merge first
//     (__match_any_sync): the count is the group's popcount, the mass the
//     group's integer sum, and one leader lane adds both to its warp's
//     private histogram in shared memory.  Only the leader of a bin
//     writes that bin in a round, so the warp histograms take plain
//     stores, no atomics.  When a round holds few bins (clustered
//     distances: the contended case) each bin's mass is one
//     __reduce_add_sync per 21-bit limb over the warp; when it holds
//     many, each leader adds its (small) group's distances, staged in
//     shared memory.
//   * Counts and masses stay integers throughout.  A bin's mass can pass
//     2^64 (D < 2^63, and a call holds up to 2^31 and more distances), so
//     masses are kept as 128-bit (hi, lo) pairs of unsigned 64-bit words:
//     exact and associative, with no upper bins treated apart.  A double
//     for the high bins would round, and its sum would depend on the
//     order of the adds.
//   * At the end of a block the warp histograms are summed and added with
//     integer atomics into one global accumulator (each bin's mass as
//     three 42-bit limbs, so no add waits for a carry), so one pass over
//     the data suffices:
//     integer addition is associative, so the result is the same in any
//     order.  The last block to finish (a ticket counter after
//     __threadfence) converts each bin to double once, correctly rounded,
//     writes (or adds into) the output, and leaves the accumulator at
//     zero for the next launch.  So every unit-weight sum is the exact
//     integer rounded once: bit-reproducible, and equal to the plain
//     version's (which sums in integers too).
//
// Design, fractional weights (tests and chip_smoke.py only): the same
// warp groups, whose leader sums the group's weights and weighted
// distances in double in lane order into its warp's private histogram;
// each block sums its warps in order into a row of a partials buffer,
// and a second kernel reduces the rows in a fixed order, one block per
// output entry.  The order of every add is fixed, so the result is the
// same from run to run; it differs from the plain version's in the last
// bits (rtol 1e-12).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 64;
constexpr int kNone = kBins;  // bin of a lane with no element this round
constexpr int kThreads = 512;  // 16 warps: at the path's ~2 blocks an SM,
                               // more warps in flight hide more latency
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kReduceThreads = 256;
constexpr unsigned long long kLimb = (1ull << 21) - 1;
constexpr unsigned long long kLimb42 = (1ull << 42) - 1;
constexpr unsigned long long kLimb20 = (1ull << 20) - 1;
constexpr int kMaxCtas = 1 << 20;  // 42-bit limbs: their sums stay < 2^62
// a round with at most this many bins sums each bin by warp reductions
constexpr int kFewGroups = 4;

typedef unsigned long long u64;

__device__ __forceinline__ int bin_of(int64_t d) {
  if (d < 0) return 0;
  if (d == 0) return 1;
  const int b = 64 - __clzll((unsigned long long)d);  // bit length
  return b < kBins - 1 ? b : kBins - 1;
}

__device__ __forceinline__ void add128(u64& hi, u64& lo, u64 v) {
  lo += v;
  hi += lo < v;
}

// Correctly rounded double of hi * 2^64 + lo.
__device__ __forceinline__ double u128_to_double(u64 hi, u64 lo) {
  if (hi == 0) return __ull2double_rn(lo);
  const int shift = 64 - __clzll(hi);  // bits below the top 64, 1..64
  u64 top = hi, rest = lo;
  if (shift < 64) {
    top = (hi << (64 - shift)) | (lo >> shift);
    rest = lo << (64 - shift);
  }
  // the dropped bits only matter as a sticky bit below the rounding bit
  return ldexp(__ull2double_rn(top | (rest != 0)), shift);
}

struct UnitShared {
  u64 count[kWarps][kBins];
  u64 mass_hi[kWarps][kBins];
  u64 mass_lo[kWarps][kBins];
  u64 stage[kWarps][32];
  unsigned last;
};

// Sum over the warp of v < 2^bits (bits warp-uniform, <= 63) as a
// 128-bit (hi, lo): one __reduce_add_sync when 32 addends fit 32 bits,
// else 21-bit limbs (32 of them sum below 2^26).
__device__ __forceinline__ void warp_sum(u64 v, int bits, u64& hi, u64& lo) {
  hi = 0;
  if (bits <= 26) {
    lo = __reduce_add_sync(kFull, (unsigned)v);
    return;
  }
  const u64 s0 = __reduce_add_sync(kFull, (unsigned)(v & kLimb));
  const u64 s1 = __reduce_add_sync(kFull, (unsigned)((v >> 21) & kLimb));
  lo = s0 + (s1 << 21);  // < 2^47: no carry
  if (bits > 42) {
    const u64 s2 = __reduce_add_sync(kFull, (unsigned)(v >> 42));
    add128(hi, lo, s2 << 42);
    hi += s2 >> 22;
  }
}

// One round of a warp: every lane holds one (bin, distance), kNone when
// it has none.  All 32 lanes call it.
template <bool kMoments>
__device__ __forceinline__ void unit_round(UnitShared& sh, int warp,
                                           int lane, int b, int64_t x) {
  const unsigned grp = __match_any_sync(kFull, b);
  const bool lead = b != kNone && lane == __ffs(grp) - 1;
  if (kMoments) {
    // Bins 0 and 1 need no sum: D < 0 carries no mass, and bin 1's mass
    // is its number of D = 1.  Real traces put most distances there.
    const unsigned ones = __ballot_sync(kFull, x == 1);
    const u64 xm = x > 0 ? (u64)x : 0ull;
    u64 hi = 0, lo = lead && b == 1 ? (u64)__popc(grp & ones) : 0ull;
    if (grp == kFull) {  // warp-uniform: the whole warp on one bin
      if (b >= 2 && b != kNone) warp_sum(xm, b, hi, lo);
    } else {
      unsigned todo = __ballot_sync(kFull, lead && b >= 2);  // a bit a bin
      if (__popc(todo) <= kFewGroups) {
        // few bins (clustered distances): one warp reduction per bin
        while (todo) {
          const int l = __ffs(todo) - 1;
          todo &= todo - 1;
          const int gb = __shfl_sync(kFull, b, l);
          u64 h, s;
          warp_sum(b == gb ? xm : 0ull, gb, h, s);  // bin gb: D < 2^gb
          if (lane == l) {
            hi = h;
            lo = s;
          }
        }
      } else {
        // many small groups: each leader adds its group's staged distances
        sh.stage[warp][lane] = xm;
        __syncwarp();
        if (lead && b >= 2) {
          for (unsigned g = grp; g; g &= g - 1) {
            add128(hi, lo, sh.stage[warp][__ffs(g) - 1]);
          }
        }
      }
    }
    if (lead) {
      u64 h = sh.mass_hi[warp][b], l = sh.mass_lo[warp][b];
      add128(h, l, lo);
      sh.mass_hi[warp][b] = h + hi;
      sh.mass_lo[warp][b] = l;
    }
  }
  if (lead) sh.count[warp][b] += (u64)__popc(grp);
  __syncwarp();
}

// acc: u64 [4, 64] (count, then the mass's three 42-bit limbs) then a
// u32 ticket; all zero between launches.  out: double [2, 64] or [64].
template <bool kMoments>
__global__ void __launch_bounds__(kThreads)
reuse_hist_unit(const int64_t* __restrict__ d, int64_t n,
                u64* __restrict__ acc, double* __restrict__ out,
                int accumulate) {
  __shared__ UnitShared sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&sh.count[0][0])[i] = 0;
    (&sh.mass_hi[0][0])[i] = 0;
    (&sh.mass_lo[0][0])[i] = 0;
  }
  __syncthreads();

  // 16-byte loads from the first aligned element on
  const int64_t head = ((uintptr_t)d & 15) ? 1 : 0;
  const int64_t nvec = n > head ? (n - head) / 2 : 0;
  const longlong2* v = (const longlong2*)(d + head);
  // each warp's next load is in flight while it bins the current pair
  const int64_t stride = (int64_t)gridDim.x * kWarps * 32;
  int64_t i = ((int64_t)blockIdx.x * kWarps + warp) * 32 + lane;
  longlong2 x = make_longlong2(0, 0);
  if (i < nvec) x = __ldg(v + i);
  for (int64_t base = i - lane; base < nvec; base += stride, i += stride) {
    longlong2 next = make_longlong2(0, 0);
    if (i + stride < nvec) next = __ldg(v + i + stride);
    unit_round<kMoments>(sh, warp, lane, i < nvec ? bin_of(x.x) : kNone, x.x);
    unit_round<kMoments>(sh, warp, lane, i < nvec ? bin_of(x.y) : kNone, x.y);
    x = next;
  }
  if (blockIdx.x == 0 && warp == 0) {  // the head and tail elements
    const int64_t tail = head + 2 * nvec;  // index of the odd last element
    int64_t e = 0;
    bool has = false;
    if (lane == 0 && head && n > 0) { e = d[0]; has = true; }
    if (lane == 1 && tail < n) { e = d[tail]; has = true; }
    unit_round<kMoments>(sh, warp, lane, has ? bin_of(e) : kNone, e);
  }
  __syncthreads();

  // The global mass is kept in three 42-bit limbs, each a plain u64
  // sum (below 2^62 over at most kMaxCtas blocks), so a block's adds are
  // independent atomics with no carry to wait for.
  u64* g_count = acc;
  u64* g_limb = acc + kBins;  // [3][kBins]
  unsigned* ticket = (unsigned*)(acc + 4 * kBins);
  const int t = threadIdx.x;
  if (t < kBins) {
    u64 c = 0, hi = 0, lo = 0;
    for (int w = 0; w < kWarps; ++w) {
      c += sh.count[w][t];
      if (kMoments) {
        add128(hi, lo, sh.mass_lo[w][t]);
        hi += sh.mass_hi[w][t];
      }
    }
    if (c) atomicAdd(g_count + t, c);
    if (kMoments) {
      const u64 limb[3] = {lo & kLimb42, (lo >> 42) | ((hi & kLimb20) << 22),
                           hi >> 20};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (limb[k]) atomicAdd(g_limb + k * kBins + t, limb[k]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) sh.last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  if (t < kBins) {
    const double c = __ull2double_rn(atomicExch(g_count + t, 0ull));
    out[t] = accumulate ? out[t] + c : c;
    if (kMoments) {
      const u64 m0 = atomicExch(g_limb + t, 0ull);
      const u64 m1 = atomicExch(g_limb + kBins + t, 0ull);
      const u64 m2 = atomicExch(g_limb + 2 * kBins + t, 0ull);
      // m0 + m1 2^42 + m2 2^84; the true sum is below 2^128, so hi's
      // terms cannot pass 2^64
      u64 hi = 0, lo = m0;
      add128(hi, lo, m1 << 42);
      hi += (m1 >> 22) + (m2 << 20);
      const double m = u128_to_double(hi, lo);
      out[kBins + t] = accumulate ? out[kBins + t] + m : m;
    }
  }
  if (t == 0) atomicExch(ticket, 0u);
}

struct WeightedShared {
  double count[kWarps][kBins];
  double mass[kWarps][kBins];
  double stage_w[kWarps][32];
  double stage_m[kWarps][32];
};

template <bool kMoments>
__global__ void __launch_bounds__(kThreads)
reuse_hist_weighted(const int64_t* __restrict__ d,
                    const float* __restrict__ w, int64_t n,
                    double* __restrict__ partials) {
  constexpr int kWidth = (kMoments ? 2 : 1) * kBins;
  __shared__ WeightedShared sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
    (&sh.count[0][0])[i] = 0.0;
    (&sh.mass[0][0])[i] = 0.0;
  }
  __syncthreads();
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t base = ((int64_t)blockIdx.x * kWarps + warp) * 32; base < n;
       base += warps * 32) {
    const int64_t i = base + lane;
    const int64_t x = i < n ? d[i] : 0;
    const double wt = i < n ? (double)w[i] : 0.0;
    const int b = i < n ? bin_of(x) : kNone;
    const unsigned grp = __match_any_sync(kFull, b);
    sh.stage_w[warp][lane] = wt;
    sh.stage_m[warp][lane] = x > 0 ? wt * (double)x : 0.0;
    __syncwarp();
    if (b != kNone && lane == __ffs(grp) - 1) {
      double c = 0.0, m = 0.0;
      for (unsigned g = grp; g; g &= g - 1) {  // in lane order
        c += sh.stage_w[warp][__ffs(g) - 1];
        if (kMoments) m += sh.stage_m[warp][__ffs(g) - 1];
      }
      sh.count[warp][b] += c;
      if (kMoments) sh.mass[warp][b] += m;
    }
    __syncwarp();
  }
  __syncthreads();
  double* row = partials + (int64_t)blockIdx.x * kWidth;
  for (int t = threadIdx.x; t < kWidth; t += kThreads) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) {
      s += t < kBins ? sh.count[k][t] : sh.mass[k][t - kBins];
    }
    row[t] = s;
  }
}

// One block per output entry: its threads take the partials rows in a
// strided order and a fixed shared-memory tree combines them.
__global__ void __launch_bounds__(kReduceThreads)
reuse_hist_reduce(const double* __restrict__ partials, int ctas, int width,
                  double* __restrict__ out, int accumulate) {
  __shared__ double part[kReduceThreads];
  const int e = blockIdx.x;
  double s = 0.0;
  for (int c = threadIdx.x; c < ctas; c += kReduceThreads) {
    s += partials[(int64_t)c * width + e];
  }
  part[threadIdx.x] = s;
  __syncthreads();
#pragma unroll
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) part[threadIdx.x] += part[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[e] = accumulate ? out[e] + part[0] : part[0];
}

}  // namespace

extern "C" {

// Bytes of the unit-weight accumulator ``acc`` (zero-filled once by the
// caller; every launch leaves it at zero).
int64_t reuse_hist_acc_bytes(void) {
  return (int64_t)(4 * kBins * sizeof(u64) + sizeof(u64));
}

// out: double [2, 64] (moments != 0) or [64], written, or added into when
// accumulate != 0.  w may be null (unit weights: acc is used, partials may
// be null); with w, partials is double [ctas, width] scratch.  Returns a
// cudaError_t code: 0 when every pass launched.
int reuse_hist(const void* d, const void* w, int64_t n, int moments,
               int ctas, void* partials, void* acc, void* out,
               int accumulate, void* stream) {
  if (n <= 0 || ctas <= 0 || ctas > kMaxCtas) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t* dd = (const int64_t*)d;
  if (!w) {
    if (!acc) return (int)cudaErrorInvalidValue;
    if (moments) {
      reuse_hist_unit<true><<<ctas, kThreads, 0, s>>>(
          dd, n, (u64*)acc, (double*)out, accumulate);
    } else {
      reuse_hist_unit<false><<<ctas, kThreads, 0, s>>>(
          dd, n, (u64*)acc, (double*)out, accumulate);
    }
    return (int)cudaGetLastError();
  }
  if (!partials) return (int)cudaErrorInvalidValue;
  const float* ww = (const float*)w;
  double* pp = (double*)partials;
  if (moments) {
    reuse_hist_weighted<true><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
  } else {
    reuse_hist_weighted<false><<<ctas, kThreads, 0, s>>>(dd, ww, n, pp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int width = (moments ? 2 : 1) * kBins;
  reuse_hist_reduce<<<width, kReduceThreads, 0, s>>>(pp, ctas, width,
                                                     (double*)out, accumulate);
  return (int)cudaGetLastError();
}

const char* reuse_hist_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
