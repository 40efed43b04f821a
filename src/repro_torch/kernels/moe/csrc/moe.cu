// The mixture-of-experts layer's expert pipeline for NVIDIA Hopper
// (sm_90a), bf16: dispatch, two grouped GEMMs and the combine.  Built with
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (kernels/build.py, kernels/moe/moe.py).
//
// Replaces no Pallas kernel.  The JAX package routes with one-hot
// dispatch/combine einsums and leaves the expert products to XLA
// (src/repro/models/moe.py::moe_apply); until these kernels the port ran
// them as a loop on the host over the experts (models/moe.py::_experts),
// which reads each expert's pair count on the host (three syncs a layer)
// and makes about seven launches an expert, with the SwiGLU and the
// weighted combine as separate passes over device memory.  Here no count
// reaches the host: four launches a layer, the counts and offsets on the
// device only.
//
//   moe_route_kernel    one block: each expert's pairs, their exclusive
//                       prefix sum (offs [E + 1], int32) and each
//                       (token, choice) pair's slot in expert order,
//                       stable (pairs of one expert in token order);
//   moe_gather_kernel   x's rows into the contiguous bf16 [pairs, d]
//                       buffer in slot order;
//   grouped_gemm_kernel<0>  h = silu(xs wg[e]) * (xs wi[e]) for every
//                       expert's rows at once, bf16 [pairs, f];
//   grouped_gemm_kernel<1>  yp = h wo[e], bf16 [pairs, d];
//   moe_combine_kernel  y[t] = sum over t's pairs, in expert order, of
//                       bf16(gate) * yp[slot] in f32, cast to bf16.
//
// The combine keeps the reference's two rounding points (models/moe.py):
// the gate rounded to x's dtype, and the sum in f32 before the cast; the
// products and the sums are written __fmul_rn / __fadd_rn so that the
// compiler does not fuse them, and a token's pairs are summed in expert
// order, as the loop's index_add_ does.  With the same yp the combine is
// bit for bit the loop's.
//
// What bounds it on the card: the two GEMMs, 6 d f operations a pair (2 d
// f each for the gate, up and down products): at mixtral's d 4,096, f
// 14,336 and the long cell's 8,960 pairs a layer, 3.16e12 operations,
// 3.2 ms at 989 TFLOP/s; dispatch and combine move ~2 (pairs + tokens) d
// bf16 values, ~0.1 ms at 3.35 TB/s.
//
// GEMM design.  One launch covers every expert: a persistent grid (one
// block an SM, in clusters of two) walks the output tiles of all experts
// in order, reading the offsets from device memory into shared memory; an
// expert's rows are ceil(count / 128) tiles of 128 rows, and an expert
// with no rows has no tile.  A block is two consumer warpgroups (rows 0-63
// and 64-127 of the tile) running wgmma m64n256k16 from shared memory and
// one producer thread that keeps a ring of four 48 KB stages of TMA loads
// in flight (mbarriers full/empty).  A stage holds the A tile (128 x 64,
// K-major, 128-byte swizzle) and four 64 x 64 boxes of B, the weights
// [E, K, N] as they lie (N contiguous: MN-major).  In the gate/up form the
// boxes are wg[e] and wi[e] at the same 128 columns, side by side, so one
// A tile feeds both products in one instruction and the epilogue writes
// only h = silu(g) * i in bf16 (g, i and silu(g) never reach device
// memory).  In the down form they are wo[e]'s 256 columns.  The two blocks
// of a cluster take neighbouring column tiles of one row tile; each loads
// half of the A tile and multicasts it to both.  Each consumer keeps one
// wgmma group in flight and frees a stage, in both blocks, when the group
// that read it has completed.  Rows past the expert's last pair (the next
// expert's, or past the buffer, which TMA fills with zeros) are computed
// and not written; B's rows are e K + k of the weights viewed as [E K, N],
// so K must be a multiple of 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kCluster = 2;             // blocks sharing an A tile
constexpr int kConsumers = 2;           // warpgroups on wgmma, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;    // and a producer warp
constexpr int kBM = 64 * kConsumers;    // rows of a tile
constexpr int kBN = 256;                // columns of a tile's products
constexpr int kBK = 64;                 // depth of a stage: 128-byte rows
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;               // 16 KB
constexpr int kBBox = kBK * 64 * 2;                 // a 64-column box, 8 KB
constexpr int kStageBytes = kATile + kBN * kBK * 2;  // 48 KB
// the gate/up form stages its 128 x 128 bf16 output tile in shared memory
// (16-byte chunks XOR-swizzled by row), then writes whole 256-byte rows
constexpr int kOutTile = kBM * 128 * 2;             // 32 KB
template <int kMode>
constexpr int smem_bytes() {
  return kStages * kStageBytes + (kMode == 0 ? kOutTile : 0) + 1024;
}
// the largest expert count and choices a token (moe.py's MAX_EXPERTS and
// MAX_K, which a CPU test holds equal to these)
constexpr int kMaxExperts = 128;
constexpr int kMaxK = 8;
constexpr int kRouteThreads = 1024;
constexpr int kEncodeError = 100000;  // + CUresult of a tensor map encode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster, with release and acquire:
// the barriers are initialised before any block multicasts into another
// or signals its barriers.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's rows of the A tile into the same place of every block of
// the cluster, each block's `bar` counting the bytes.
__device__ __forceinline__ void tma_load_a(uint32_t dst, const CUtensorMap* map,
                                           uint64_t* bar, int c0, int c1) {
  const uint16_t mask = (uint16_t)((1u << kCluster) - 1u);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// A consumer warpgroup has read a stage: one arrival on the stage's empty
// barrier of every block of the cluster (each multicasts into it).
__device__ __forceinline__ void release(uint64_t* bar) {
  const uint32_t local = smem_u32(bar);
#pragma unroll
  for (uint32_t c = 0; c < (uint32_t)kCluster; ++c) {
    asm volatile(
        "{\n"
        ".reg .b32 remote;\n"
        "mapa.shared::cluster.u32 remote, %0, %1;\n"
        "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
        "}\n" :: "r"(local), "r"(c) : "memory");
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major A:
// rows 128 bytes apart, 8-row groups 1,024 apart (sbo), the leading offset
// unused.  MN-major B: 8-row (k) groups 1,024 apart (sbo), 64-column
// blocks `lbo` apart.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma instructions.
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d += A (64 x 16, K-major) * B (16 x 256, MN-major), f32 sums.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Unit t of the walk over every expert's units (a unit: the kCluster
// neighbouring column tiles of one row tile, one a block of the cluster):
// expert-major, then column unit, then row tile (the blocks working at
// once share B's columns).  Returns this block's row tile and column tile.
__device__ __forceinline__ void tile_at(int t, const int* tiles, const int* offs,
                                        int rank, int& e, int& row0,
                                        int& row_end, int& nt) {
  e = 0;
  while (tiles[e + 1] <= t) ++e;
  const int local = t - tiles[e];
  const int m_tiles = (offs[e + 1] - offs[e] + kBM - 1) / kBM;
  const int nu = local / m_tiles;
  row0 = offs[e] + (local - nu * m_tiles) * kBM;
  row_end = offs[e + 1];
  nt = nu * kCluster + rank;
}

__device__ __forceinline__ float silu(float g) {
  return __fdividef(g, 1.0f + __expf(-g));
}

// The 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// kMode 0: out [rows, N] = silu(A wg[e]) * (A wi[e]) (b0 = wg, b1 = wi: a
// tile's 256 product columns are g and i at 128 output columns);
// kMode 1: out [rows, N] = A wo[e] (b0 = b1 = wo, 256 output columns).
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b0,
                    const __grid_constant__ CUtensorMap map_b1,
                    const int32_t* __restrict__ offs_g, bf16* __restrict__ out,
                    int experts, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  __shared__ int offs[kMaxExperts + 1];
  __shared__ int tiles[kMaxExperts + 1];

  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 1 KB atoms
  constexpr int kCols = kMode == 0 ? kBN / 2 : kBN;   // output columns
  const int n_units = ((N + kCols - 1) / kCols + kCluster - 1) / kCluster;
  const int rank = (int)cluster_rank();
  const int cluster = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;

  for (int e = threadIdx.x; e <= experts; e += blockDim.x) offs[e] = offs_g[e];
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int e = 0; e < experts; ++e) {
      tiles[e] = total;
      total += (offs[e + 1] - offs[e] + kBM - 1) / kBM * n_units;
    }
    tiles[experts] = total;
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      // one arrival a consumer warpgroup of every block of the cluster
      mbar_init(&empty[s], kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  const int total = tiles[experts];
  const int k_steps = K / kBK;
  const int wg = threadIdx.x / 128;

  if (wg == kConsumers) {
    // producer: one thread issues every TMA load
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      constexpr int a_rows = kBM / kCluster;
      for (int t = cluster; t < total; t += clusters) {
        int e, row0, row_end, nt;
        tile_at(t, tiles, offs, rank, e, row0, row_end, nt);
        const int n0 = nt * kCols;
        const int c1 = kMode == 0 ? n0 : n0 + 128;   // b1's first column
        const int brow = e * K;
        for (int ks = 0; ks < k_steps; ++ks) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t sa = base + stage * kStageBytes;
          const uint32_t sb = sa + kATile;
          const int k0 = ks * kBK;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_a(sa + rank * a_rows * 128, &map_a, &full[stage], k0,
                     row0 + rank * a_rows);
          tma_load_2d(sb, &map_b0, &full[stage], n0, brow + k0);
          tma_load_2d(sb + kBBox, &map_b0, &full[stage], n0 + 64, brow + k0);
          tma_load_2d(sb + 2 * kBBox, &map_b1, &full[stage], c1, brow + k0);
          tma_load_2d(sb + 3 * kBBox, &map_b1, &full[stage], c1 + 64,
                      brow + k0);
          if (++stage == kStages) { stage = 0; phase ^= 1; }
        }
      }
      // the block stays until every stage it filled (and every stage the
      // cluster multicast into) has been released by all its readers
      for (int s = 0; s < kStages; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // consumers: warpgroup wg computes rows 64 wg .. 64 wg + 63 of a tile
    // by 256 columns (the four boxes of B side by side: one m64n256k16 a
    // k-slice)
    float acc[128];
    int stage = 0;
    uint32_t phase = 0;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const bool signals = threadIdx.x % 128 == 0;
    for (int t = cluster; t < total; t += clusters) {
      int e, row0, row_end, nt;
      tile_at(t, tiles, offs, rank, e, row0, row_end, nt);
      const int n0 = nt * kCols;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int ks = 0; ks < k_steps; ++ks) {
        mbar_wait(&full[stage], phase);
        const uint32_t sa = base + stage * kStageBytes + wg * 64 * 128;
        const uint32_t sb = base + stage * kStageBytes + kATile;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          wgmma_256(acc, gmma_desc(sa + kk * 32, 16, 1024),
                    gmma_desc(sb + kk * 2048, kBBox, 1024));
        }
        wgmma_commit();
        fence_regs(acc);
        wgmma_wait<1>();   // the group before this one has read its stage
        if (prev >= 0 && signals) release(&empty[prev]);
        prev = stage;
        if (++stage == kStages) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && signals) release(&empty[prev]);

      // accumulator i of m64n256: column 8 (i / 4) + 2 (lane % 4) + i % 2,
      // row 16 warp + lane / 4 + 8 ((i / 2) % 2); in the gate/up form
      // columns 0-127 are g and 128-255 the up product (i + 64)
      const int r_in = warp * 16 + lane / 4;
      const int c_in = (lane % 4) * 2;
      if (kMode == 0) {
        // h into this warpgroup's 64 x 256-byte staging rows, then out in
        // 16-byte chunks, a row's 256 bytes by 16 neighbouring threads
        uint8_t* stage_out = smem_raw + (base - smem_u32(smem_raw))
                             + kStages * kStageBytes + wg * 64 * 256;
        warpgroup_sync(wg);   // the previous tile's chunks have been read
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r_in + 8 * h;
            const int i = j * 4 + 2 * h;
            *reinterpret_cast<__nv_bfloat162*>(
                stage_out + r * 256 + ((j ^ (r & 7)) * 16) + c_in * 2) =
                __floats2bfloat162_rn(silu(acc[i]) * acc[i + 64],
                                      silu(acc[i + 1]) * acc[i + 65]);
          }
        }
        warpgroup_sync(wg);
        for (int q = threadIdx.x % 128; q < 64 * 16; q += 128) {
          const int r = q / 16, chunk = q % 16;
          const int row = row0 + wg * 64 + r;
          const int col = n0 + chunk * 8;
          if (row < row_end && col < N) {
            *reinterpret_cast<uint4*>(out + (size_t)row * N + col) =
                *reinterpret_cast<const uint4*>(
                    stage_out + r * 256 + ((chunk ^ (r & 7)) * 16));
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = row0 + wg * 64 + r_in + 8 * h;
            const int i = j * 4 + 2 * h;
            const int col = n0 + 8 * j + c_in;
            if (row >= row_end || col >= N) continue;
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                __floats2bfloat162_rn(acc[i], acc[i + 1]);
          }
        }
      }
    }
  }
}

// One block: each expert's pair count, the offsets and each pair's slot.
// Pairs go in chunks of 1,024; within a warp a pair's rank among the lanes
// of its expert comes from __match_any_sync, and the warps' counts are
// turned into each warp's start in its expert by a prefix in warp order,
// so the slots are stable (the order of the loop's stable argsort).
__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const int64_t* __restrict__ idx, int pairs, int experts,
                 int32_t* __restrict__ offs, int32_t* __restrict__ slot) {
  __shared__ int warp_start[32][kMaxExperts];
  __shared__ int running[kMaxExperts];
  __shared__ int start[kMaxExperts];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < 32 * experts; i += blockDim.x) {
    warp_start[i / experts][i % experts] = 0;
  }
  for (int e = tid; e < experts; e += blockDim.x) running[e] = 0;
  __syncthreads();
  for (int first = 0; first < pairs; first += kRouteThreads) {
    const int p = first + tid;
    const int e = p < pairs ? (int)idx[p] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (e >= 0 && rank == 0) warp_start[warp][e] = __popc(same);
    __syncthreads();
    for (int ex = tid; ex < experts; ex += blockDim.x) {
      int run = running[ex];
      for (int w = 0; w < 32; ++w) {
        const int c = warp_start[w][ex];
        warp_start[w][ex] = run;
        run += c;
      }
      running[ex] = run;
    }
    __syncthreads();
    if (e >= 0) slot[p] = warp_start[warp][e] + rank;  // rank in its expert
    __syncthreads();
    for (int i = tid; i < 32 * experts; i += blockDim.x) {
      warp_start[i / experts][i % experts] = 0;
    }
    __syncthreads();
  }
  if (tid == 0) {
    int acc = 0;
    for (int e = 0; e < experts; ++e) {
      start[e] = acc;
      offs[e] = acc;
      acc += running[e];
    }
    offs[experts] = acc;
  }
  __syncthreads();
  for (int p = tid; p < pairs; p += blockDim.x) slot[p] += start[(int)idx[p]];
}

// One warp a pair: x's row (token p / k) to row slot[p] of xs, 16 bytes a
// lane at a time (d a multiple of 8).
__global__ void moe_gather_kernel(const bf16* __restrict__ x,
                                  const int32_t* __restrict__ slot,
                                  bf16* __restrict__ xs, int pairs, int k,
                                  int d) {
  const int p = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (p >= pairs) return;
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)(p / k) * d);
  uint4* dst = reinterpret_cast<uint4*>(xs + (size_t)slot[p] * d);
  for (int i = threadIdx.x % 32; i < d / 8; i += 32) dst[i] = src[i];
}

// One block a token: its k pairs sorted by expert, then 8 columns a
// thread at a time, y = sum_j bf16(gate_j) * yp[slot_j] in f32, cast once.
__global__ void moe_combine_kernel(const bf16* __restrict__ yp,
                                   const int32_t* __restrict__ slot,
                                   const float* __restrict__ gate,
                                   const int64_t* __restrict__ idx,
                                   bf16* __restrict__ y, int k, int d) {
  __shared__ int s_slot[kMaxK];
  __shared__ float s_w[kMaxK];
  const int t = blockIdx.x;
  if (threadIdx.x == 0) {
    int64_t ex[kMaxK];
    for (int j = 0; j < k; ++j) {
      int64_t e = idx[(size_t)t * k + j];
      int sl = slot[(size_t)t * k + j];
      float w = __bfloat162float(__float2bfloat16_rn(gate[(size_t)t * k + j]));
      int m = j;
      while (m > 0 && ex[m - 1] > e) {
        ex[m] = ex[m - 1];
        s_slot[m] = s_slot[m - 1];
        s_w[m] = s_w[m - 1];
        --m;
      }
      ex[m] = e;
      s_slot[m] = sl;
      s_w[m] = w;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x * 8; c < d; c += blockDim.x * 8) {
    float acc[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[q] = 0.0f;
    for (int j = 0; j < k; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          yp + (size_t)s_slot[j] * d + c);
      const bf16* vals = reinterpret_cast<const bf16*>(&v);
      const float w = s_w[j];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        acc[q] = __fadd_rn(acc[q], __fmul_rn(__bfloat162float(vals[q]), w));
      }
    }
    uint4 o;
    bf16* ov = reinterpret_cast<bf16*>(&o);
#pragma unroll
    for (int q = 0; q < 8; ++q) ov[q] = __float2bfloat16_rn(acc[q]);
    *reinterpret_cast<uint4*>(y + (size_t)t * d + c) = o;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so the
// library does not link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 [rows, cols] matrix in boxes of box_rows x 64 columns
// (128 bytes: the swizzle's width), 128-byte swizzle, zeros outside.
int make_map(CUtensorMap* map, const void* ptr, uint64_t rows, uint64_t cols,
             uint32_t box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  cuuint64_t dims[2] = {cols, rows};
  cuuint64_t strides[1] = {cols * 2};
  cuuint32_t box[2] = {64, box_rows};
  cuuint32_t elem[2] = {1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + (int)r;
}

// The clusters of a grouped GEMM launch that can be resident at once (the
// persistent grid: one block an SM at this shared memory), by form, 0
// before its first launch.
int resident_clusters[2] = {0, 0};

template <int kMode>
int launch_gemm(const void* a, const void* b0, const void* b1,
                const int32_t* offs, bf16* out, int rows, int K, int N,
                int experts, cudaStream_t st) {
  CUtensorMap ma, mb0, mb1;
  int code = make_map(&ma, a, rows, K, kBM / kCluster);
  if (!code) code = make_map(&mb0, b0, (uint64_t)experts * K, N, kBK);
  if (!code) code = make_map(&mb1, b1, (uint64_t)experts * K, N, kBK);
  if (code) return code;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kMode>());
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes<kMode>();
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (resident_clusters[kMode] == 0) {
    cfg.gridDim = dim3(kCluster * 1024);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, grouped_gemm_kernel<kMode>, &cfg);
    if (err != cudaSuccess) return (int)err;
    resident_clusters[kMode] = n > 0 ? n : 1;
  }
  cfg.gridDim = dim3(resident_clusters[kMode] * kCluster);
  err = cudaLaunchKernelEx(&cfg, grouped_gemm_kernel<kMode>, ma, mb0, mb1,
                           offs, out, experts, K, N);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// idx [tokens, k] int64 (each token's experts), x [tokens, d] bf16.
// Writes offs [experts + 1] int32, slot [tokens k] int32 and xs [tokens
// k, d] bf16.  Two launches.  Returns a cudaError_t code, 0 on success.
int moe_dispatch(const void* idx, const void* x, void* offs, void* slot,
                 void* xs, int tokens, int k, int d, int experts,
                 void* stream) {
  if (tokens <= 0 || k <= 0 || k > kMaxK || d <= 0 || d % 8 ||
      experts <= 0 || experts > kMaxExperts) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int pairs = tokens * k;
  moe_route_kernel<<<1, kRouteThreads, 0, st>>>(
      (const int64_t*)idx, pairs, experts, (int32_t*)offs, (int32_t*)slot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_gather_kernel<<<(pairs + 7) / 8, 256, 0, st>>>(
      (const bf16*)x, (const int32_t*)slot, (bf16*)xs, pairs, k, d);
  return (int)cudaGetLastError();
}

// mode 0: out [rows, N] = silu(a wg[e]) * (a wi[e]) with b0 = wg, b1 = wi
// [experts, K, N]; mode 1: out [rows, N] = a wo[e] with b0 = b1 = wo.  a
// [rows, K] bf16 in expert order, offs [experts + 1] on the device.  K a
// multiple of 64, N of 8.
int moe_gemm(int mode, const void* a, const void* b0, const void* b1,
             const void* offs, void* out, int rows, int K, int N, int experts,
             void* stream) {
  if (rows <= 0 || K <= 0 || K % kBK || N <= 0 || N % 8 || experts <= 0 ||
      experts > kMaxExperts) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) {
    return launch_gemm<0>(a, b0, b1, (const int32_t*)offs, (bf16*)out, rows,
                          K, N, experts, st);
  }
  if (mode == 1) {
    return launch_gemm<1>(a, b0, b1, (const int32_t*)offs, (bf16*)out, rows,
                          K, N, experts, st);
  }
  return (int)cudaErrorInvalidValue;
}

// yp [tokens k, d] bf16, slot [tokens k] int32, gate [tokens, k] f32, idx
// [tokens, k] int64; writes y [tokens, d] bf16.
int moe_combine(const void* yp, const void* slot, const void* gate,
                const void* idx, void* y, int tokens, int k, int d,
                void* stream) {
  if (tokens <= 0 || k <= 0 || k > kMaxK || d <= 0 || d % 8) {
    return (int)cudaErrorInvalidValue;
  }
  moe_combine_kernel<<<tokens, 128, 0, (cudaStream_t)stream>>>(
      (const bf16*)yp, (const int32_t*)slot, (const float*)gate,
      (const int64_t*)idx, (bf16*)y, k, d);
  return (int)cudaGetLastError();
}

const char* moe_error_string(int code) {
  if (code >= kEncodeError) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
