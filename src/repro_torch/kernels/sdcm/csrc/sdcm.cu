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
// One device function, sdcm_phit<A_MAX>, serves the grid forms: A and B
// arrive at run time, and the template bucket A_MAX (8/16/32/64) only bounds
// the unrolled term loop.  The per-reference forms evaluate the same sum
// from the binomial's mode (phit_mode, below).
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
// What bounds it on the card.  The per-reference forms read 4 and write 4
// bytes per element and evaluate up to A binomial terms per element.  Term
// by term in log space (sdcm_phit: 2·A double log/exp, each a software
// sequence of tens of FP64 instructions) the form ran at 24-57x its
// operations bound at 2^22 distances (PERF.md); at the sweep's calls
// (~136 distances each) a launch's latency is all there is.  So
// phit_mode takes one set of transcendentals per element, at the
// binomial's mode, and reaches the other terms by their ratios (three
// multiplies and an add a term, no divide), and sdcm_hit_probs_ragged
// evaluates every (level, geometry) of a sweep_grid call in one launch.
// The grid form at the prediction path's size (tens of rows, a few
// thousand entries) is far below a microsecond of work at either bound;
// what a predict paid for it was the host: four launches (one per
// row-shape group), three copies and one synchronisation each.
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
// The per-reference forms share one kernel (sdcm_hit_probs_kernel):
//   * sdcm_hit_probs — one geometry over a flat float32 stream;
//   * sdcm_hit_probs_ragged — many: a record (offset, length, A, B, A_MAX,
//     output offset) per (level, geometry), the grid (chunk, record), so a
//     sweep's every P(h|D) comes from one launch.  The Eq. 3 fold stays
//     outside, as kernels/sdcm/ops.py::sdcm_hit_rate keeps it outside the
//     Pallas kernel.
// There is no matrix product, so wgmma and TMA do not apply.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRateThreads = 128;   // threads per row in the grid form
constexpr int kProbThreads = 256;   // threads per block, per-reference form
// Blocks of a per-reference launch, at most: ~16 resident a SM, so that a
// thread takes several elements and its geometry's constants (two logs and
// two divides) once for them.
constexpr int64_t kMaxProbBlocks = 2048;
constexpr int kMetaWidth = 5;       // (offset, length, A, B, A_MAX) a row
// (offset, length, A, B, A_MAX, output offset) a per-reference record
constexpr int kProbMetaWidth = 6;
// Past this D - k + 1, ln Gamma(D + 1) - ln Gamma(D - k + 1) comes from
// Stirling's series (see log_binom).
constexpr double kStirlingFrom = 64.0;

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

// ln n! for n = 0 .. 127, correctly rounded (decimal arithmetic at 50
// digits).
__constant__ double kLogFactorial[128] = {
    0.0, 0.0, 0.6931471805599453, 1.791759469228055, 3.1780538303479458,
    4.787491742782046, 6.579251212010101, 8.525161361065415,
    10.60460290274525, 12.801827480081469, 15.104412573075516,
    17.502307845873887, 19.987214495661885, 22.552163853123425,
    25.19122118273868, 27.89927138384089, 30.671860106080672,
    33.50507345013689, 36.39544520803305, 39.339884187199495,
    42.335616460753485, 45.38013889847691, 48.47118135183523,
    51.60667556776438, 54.78472939811232, 58.00360522298052, 61.261701761002,
    64.55753862700634, 67.88974313718154, 71.25703896716801,
    74.65823634883016, 78.0922235533153, 81.55795945611504, 85.05446701758152,
    88.58082754219768, 92.1361756036871, 95.7196945421432, 99.33061245478743,
    102.96819861451381, 106.63176026064346, 110.32063971475739,
    114.0342117814617, 117.77188139974507, 121.53308151543864,
    125.3172711493569, 129.12393363912722, 132.95257503561632,
    136.80272263732635, 140.67392364823425, 144.5657439463449,
    148.47776695177302, 152.40959258449735, 156.3608363030788,
    160.3311282166309, 164.32011226319517, 168.32744544842765,
    172.3527971391628, 176.39584840699735, 180.45629141754378,
    184.53382886144948, 188.6281734236716, 192.7390472878449, 196.86618167289,
    201.00931639928152, 205.1681994826412, 209.34258675253685,
    213.53224149456327, 217.73693411395422, 221.95644181913033,
    226.1905483237276, 230.43904356577696, 234.70172344281826,
    238.97838956183432, 243.2688490029827, 247.57291409618688,
    251.8904022097232, 256.22113555000954, 260.5649409718632,
    264.9216497985528, 269.2910976510198, 273.6731242856937,
    278.0675734403661, 282.4742926876304, 286.893133295427, 291.3239500942703,
    295.76660135076065, 300.22094864701415, 304.6868567656687,
    309.1641935801469, 313.65282994987905, 318.1526396202093,
    322.66349912672615, 327.1852877037752, 331.7178871969285,
    336.26118197919845, 340.815058870799, 345.37940706226686,
    349.95411804077025, 354.5390855194408, 359.1342053695754,
    363.73937555556347, 368.35449607240474, 372.979468885689,
    377.61419787391867, 382.25858877306, 386.91254912321756,
    391.5759882173296, 396.24881705179155, 400.93094827891576,
    405.6222961611449, 410.32277652693733, 415.03230672824964,
    419.7508055995447, 424.4781934182571, 429.21439186665157,
    433.9593239950148, 438.71291418612117, 443.47508812091894,
    448.2457727453846, 453.0248962384961, 457.81238798127816,
    462.6081785268749, 467.4121995716082, 472.2243839269806,
    477.04466549258564, 481.87297922988796, 486.7092611368394,
    491.553448223298};
// 1 / k for k = 1 .. 63 (entry 0 unused): the up ratio's divisor.
__constant__ double kInverse[64] = {
    0.0, 1.0 / 1, 1.0 / 2, 1.0 / 3, 1.0 / 4, 1.0 / 5, 1.0 / 6, 1.0 / 7,
    1.0 / 8, 1.0 / 9, 1.0 / 10, 1.0 / 11, 1.0 / 12, 1.0 / 13, 1.0 / 14,
    1.0 / 15, 1.0 / 16, 1.0 / 17, 1.0 / 18, 1.0 / 19, 1.0 / 20, 1.0 / 21,
    1.0 / 22, 1.0 / 23, 1.0 / 24, 1.0 / 25, 1.0 / 26, 1.0 / 27, 1.0 / 28,
    1.0 / 29, 1.0 / 30, 1.0 / 31, 1.0 / 32, 1.0 / 33, 1.0 / 34, 1.0 / 35,
    1.0 / 36, 1.0 / 37, 1.0 / 38, 1.0 / 39, 1.0 / 40, 1.0 / 41, 1.0 / 42,
    1.0 / 43, 1.0 / 44, 1.0 / 45, 1.0 / 46, 1.0 / 47, 1.0 / 48, 1.0 / 49,
    1.0 / 50, 1.0 / 51, 1.0 / 52, 1.0 / 53, 1.0 / 54, 1.0 / 55, 1.0 / 56,
    1.0 / 57, 1.0 / 58, 1.0 / 59, 1.0 / 60, 1.0 / 61, 1.0 / 62, 1.0 / 63};
// Each rescaling of the running sum: u past kRescaleAt is multiplied by
// kRescaleBy, exactly (powers of two).
constexpr double kRescaleAt = 0x1p600;
constexpr double kRescaleBy = 0x1p-600;

// A geometry's constants for phit_mode, once per thread.
struct PhitGeom {
  double assoc, blocks, p, log_p, log_1mp, q_up;
  int a, a_max;
};

__device__ __forceinline__ PhitGeom phit_geom(double assoc, double blocks,
                                              int a_max) {
  PhitGeom g;
  g.assoc = assoc;
  g.blocks = blocks;
  g.p = fmin(fmax(assoc / blocks, 1e-30), 1.0 - 1e-7);
  g.log_p = log(g.p);
  g.log_1mp = log1p(-g.p);
  g.q_up = g.p / (1.0 - g.p);
  g.a = (int)assoc;
  g.a_max = a_max;
  return g;
}

// ln C(D, k) for 0 <= k <= D, k < 64.  lgamma(D + 1) and lgamma(D - k + 1)
// are ~D ln D each and cancel: at D ~ 1e8 their ulp (2.4e-7) is already a
// quarter of the 1e-6 bound on P(h|D), relative.  From y = D - k + 1 >=
// kStirlingFrom their difference is Stirling's series of both, written
// without the cancellation:
//   (y - 1/2) ln(1 + k/y) + k ln(D + 1) - k + (1/12)(1/x - 1/y)
//   - (1/360)(1/x^3 - 1/y^3),  x = D + 1,
// whose next term is below 1 / (1260 y^5) <= 7.4e-13.  Below, D < 127: the
// table of ln n! for an integral D (a reuse distance), lgamma otherwise.
__device__ __forceinline__ double log_binom(double d, int k) {
  if (k == 0) return 0.0;
  const double x = d + 1.0, y = d - k + 1.0;
  double diff;
  if (y >= kStirlingFrom) {
    const double r = 1.0 / (x * y), ix = y * r, iy = x * r;
    diff = (y - 0.5) * log1p(k * iy) + k * log(x) - k +
           (ix - iy) / 12.0 - (ix * ix * ix - iy * iy * iy) / 360.0;
  } else if (d == floor(d)) {
    diff = kLogFactorial[(int)d] - kLogFactorial[(int)d - k];
  } else {
    diff = lgamma(x) - lgamma(y);
  }
  return diff - kLogFactorial[k];
}

// P(h | D) for the per-reference forms: sdcm_phit's rules and sum, the sum
// normalised at the binomial's mode.  With D >= A (past the D <= A - 1
// rule) the terms are T_k = C(D, k) p^k (1 - p)^(D - k), k = 0 .. A - 1;
// they grow up to the mode k* = min(floor((D + 1) p), A - 1) and shrink
// past it.  T_k* alone comes from logarithms (log_binom, ln p, ln(1 - p),
// one exp).  The rest is one walk up the ratios of neighbouring terms,
// u_k = T_k / T_0 = u_(k-1) (D - k + 1) / k p / (1 - p), in double, with
// 1 / k from a table (k is the loop counter, the same in every lane) and
// no division: P = T_k* (sum_k u_k) / u_k*.  u grows until k* and shrinks
// after it; a sum near 2^600 is scaled by 2^-600 (exactly), so nothing
// overflows, and every term is read against the largest, T_k*: what
// underflows is below 1e-308 of it.  (T_0 itself, (1 - p)^D, underflows
// at long D, and T_(A-1) at tiny p: a sum taken from either would lose
// the rest.)  Every lane walks A - 1 steps.
__device__ double phit_mode(double d, const PhitGeom& g) {
  if (d < 0.0) return 0.0;                                   // INF_RD
  if (g.assoc >= g.blocks) return d < g.blocks ? 1.0 : 0.0;  // fully assoc.
  if (d <= g.assoc - 1.0) return 1.0;
  if (g.assoc > (double)g.a_max) return CUDART_NAN;
  const int mode = (int)fmin(floor((d + 1.0) * g.p), (double)(g.a - 1));
  const double t_mode = exp(log_binom(d, mode) + mode * g.log_p +
                            (d - mode) * g.log_1mp);
  double u = 1.0, sum = 1.0, u_mode = 1.0, top = d;  // top = D - k + 1
  for (int k = 1; k < g.a; ++k) {
    u *= top * kInverse[k] * g.q_up;
    sum += u;
    top -= 1.0;
    if (k == mode) u_mode = u;
    if (u > kRescaleAt) {
      u *= kRescaleBy;
      sum *= kRescaleBy;
      u_mode *= kRescaleBy;
    }
  }
  return fmin(t_mode * (sum / u_mode), 1.0);
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

// One per-reference record: out[out_off + i] = P(h | d[off + i]), i < len.
struct ProbRecord {
  int64_t off, len, out_off;
  double assoc, blocks;
  int a_max;
};

// Per-reference forms: record blockIdx.y of meta (ragged; doubles, exact
// integers) or, with meta null, ``one``; blocks x stride over its entries.
// A record outside d's [0, total) or with no bucket of (8, 16, 32, 64)
// gives NaN; one whose output lies outside [0, out_total) writes nothing.
__global__ void __launch_bounds__(kProbThreads)
sdcm_hit_probs_kernel(const float* __restrict__ d, float* __restrict__ out,
                      const double* __restrict__ meta, ProbRecord one,
                      int64_t total, int64_t out_total) {
  ProbRecord rec = one;
  if (meta) {
    const double* m = meta + (int64_t)blockIdx.y * kProbMetaWidth;
    rec = {(int64_t)m[0], (int64_t)m[1], (int64_t)m[5], m[2], m[3],
           (int)m[4]};
  }
  if (rec.len < 0 || rec.out_off < 0 || rec.out_off + rec.len > out_total) {
    return;
  }
  const bool ok = rec.off >= 0 && rec.off + rec.len <= total &&
                  (rec.a_max == 8 || rec.a_max == 16 || rec.a_max == 32 ||
                   rec.a_max == 64);
  const PhitGeom g = phit_geom(rec.assoc, rec.blocks, rec.a_max);
  const int64_t step = (int64_t)gridDim.x * kProbThreads;
  for (int64_t i = (int64_t)blockIdx.x * kProbThreads + threadIdx.x;
       i < rec.len; i += step) {
    out[rec.out_off + i] =
        ok ? (float)phit_mode((double)d[rec.off + i], g) : CUDART_NAN_F;
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

// d, out: float [n]; one geometry.
int sdcm_hit_probs(const void* d, void* out, int64_t n, double assoc,
                   double blocks, int a_max, void* stream) {
  if (n <= 0 || (a_max != 8 && a_max != 16 && a_max != 32 && a_max != 64)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = (n + kProbThreads - 1) / kProbThreads;
  const int grid = (int)(nb < kMaxProbBlocks ? nb : kMaxProbBlocks);
  const ProbRecord one = {0, n, 0, assoc, blocks, a_max};
  sdcm_hit_probs_kernel<<<grid, kProbThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, nullptr, one, n, n);
  return (int)cudaGetLastError();
}

// d: float [total]; meta: double [records, 6] (offset, length, A, B, A_MAX,
// output offset); out: float [out_total].  Each record's length is at most
// total (its entries lie in d), so ceil(total / kProbThreads) blocks a
// record, up to kMaxProbBlocks over all records, cover the longest.
int sdcm_hit_probs_ragged(const void* d, const void* meta, int64_t total,
                          void* out, int64_t out_total, int records,
                          void* stream) {
  if (records <= 0 || records > 65535 || total <= 0 || out_total < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t nb = (total + kProbThreads - 1) / kProbThreads;
  const int64_t cap = kMaxProbBlocks / records > 0 ? kMaxProbBlocks / records
                                                   : 1;
  const dim3 grid((unsigned)(nb < cap ? nb : cap), (unsigned)records);
  const ProbRecord none = {0, 0, 0, 0.0, 0.0, 0};
  sdcm_hit_probs_kernel<<<grid, kProbThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (float*)out, (const double*)meta, none, total,
      out_total);
  return (int)cudaGetLastError();
}

const char* sdcm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
