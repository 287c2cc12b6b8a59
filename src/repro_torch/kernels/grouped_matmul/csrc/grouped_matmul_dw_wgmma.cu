// Weight gradient of the grouped (per-expert) matmul on Hopper's tensor cores (sm_90a),
// bf16 only: the backward of the sorted MoE dispatch's expert FFN with respect to the
// expert weights, at the LM train step's widths.
//
//   dW[e] = sum over row tiles i with expert(tile_eid[i]) == e of  x_i^T @ dY_i
//
// (bf16 products, float32 sums, one rounding to bf16 at the store.)  This replaces no
// TPU kernel: the reference trains through its plain grouped matmul, so it has no
// backward kernel.  The port trains through its forward kernels and needs one for dW.
// `grouped_matmul.py::dw_variant` picks this kernel for bf16 operands whose Cin and
// Cout are multiples of 8 and whose row tile is a multiple of 64; every other call
// (float32, odd widths, 16-row tiles) keeps the float32-FMA kernel in
// grouped_matmul_dw.cu, so float32 stays exact (no TF32).
//
// What bounds it on this card.  At granite-moe-1b's train step (4 x 512 tokens, 32
// experts, top 8, capacity 896) a call reads x (28,672 x 1024) and dY (28,672 x 512)
// once and writes dW (32 x 1024 x 512): 121.6 MB, 0.0363 ms at 3.35 TB/s, beside
// 2 x 28,672 x 1024 x 512 = 30.1 GFLOP, 0.0304 ms at 989 TFLOP/s.  It sits near the
// bf16 ridge, so the tensor cores have to be fed from an asynchronous copy pipeline
// and x and dY read from device memory about once.  The earlier design (float32 FMAs,
// synchronous 2-byte staging, a serial walk over tile_eid) took 1.43 ms.
//
// What the design does about it.
//   * The problem as a GEMM per expert: M = Cin (rows of dW), N = Cout, K = the
//     expert's rows.  A = x^T: x is stored with Cin contiguous, so A is M-major; B = dY
//     has N contiguous.  Both go in through the 128-byte-swizzle MN-major descriptor
//     (imm-trans-a = imm-trans-b = 1; transposing from shared memory is allowed for
//     16-bit types): LBO = 8 KB between 64-wide halves along M or N, SBO = 1 KB between
//     groups of 8 K rows.
//   * A CTA computes 128 x 256 tiles of one expert's dW (128 x 128 tiles measured 25 %
//     slower).  Both operands come in through 2-D TMA maps, x over (Cin, R) and dY over
//     (Cout, R), as boxes of 64 columns by 64 rows: per 64-row K step two boxes of x
//     and four of dY, completion counted on a `full` mbarrier.  One producer warp keeps
//     a ring of 4 stages filled; two consumer warpgroups each run
//     `wgmma.mma_async.m64n256k16.f32.bf16.bf16` over their 64 rows of dW, four per
//     stage, and release a stage on an `empty` mbarrier once `wgmma.wait_group` says
//     the products that read it are done (one group stays in flight).
//   * A persistent grid, one CTA an SM, walks the output tiles with the columns
//     fastest, then the channel blocks, then the expert, so the CTAs that run together
//     read one expert's rows of x and dY (2.75 MB at the step) and find them in L2.
//     The stage ring runs on from tile to tile: the producer loads the next tile while
//     the consumers finish this one.
//   * The epilogue goes through a shared-memory buffer of half a tile and TMA stores
//     (`cp.async.bulk.tensor`), which run on under the next tile's main loop; only the
//     staging (float32 rounded once to bf16, written swizzled) holds the consumers.
//     Scattered 4-byte stores straight from the accumulators measured slower; a
//     whole-tile buffer leaves room for 3 stages only, which measured slower than two
//     halves through half a tile (scripts/grouped_matmul_dw_ablation.py, PERF.md).
//   * A 64-row K step never crosses a row tile (row_tile % 64 == 0), so K steps are
//     whole slices of the expert's own tiles.  The kernel takes tile_eid as given (no
//     equal segments assumed): the producer finds the expert's tiles 32 ids at a time
//     with a warp ballot, in order, and each consumer warp counts them the same way,
//     never walking tile_eid one id after another.  Ids resolve by the forward's rule
//     (a negative id wraps once, then clamps: `expert_id`).  An expert that owns no
//     tile runs no K step and stores zeros.
//   * No split over K: at the step's shapes a call has 512 tiles of 128 x 256, enough
//     for the card, so there are no atomics and dW is deterministic.
//   * Tails: a channel block past Cin or a column block past Cout is out of bounds of
//     its load map and TMA fills zeros; the store map is 3-D, (Cout, Cin, E), so rows
//     past Cin and columns past Cout are clipped and never reach the next expert.
//   * No clusters: sharing dY's tile between two CTAs by TMA multicast (a third less
//     L2 traffic) measured slower than loading it twice, as the pair runs in lockstep.
//   * The tensor maps depend on the pointers, so the host encodes them per call
//     (cuTensorMapEncodeTiled through the runtime's entry-point query, no -lcuda), as
//     grouped_matmul_wgmma.cu does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBm = 128;                          // rows of dW (input channels) a CTA
constexpr int kBn = 256;                          // columns of dW a CTA
constexpr int kBk = 64;                           // rows of x and dY a stage (a K step)
constexpr int kConsumers = 2;                     // warpgroups of 64 rows of dW each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kBoxBytes = kBk * 64 * 2;           // 8 KB: 64 K rows of 64 columns
constexpr int kABytes = 2 * kBoxBytes;            // x: 128 channels

constexpr int kStages = 4;
constexpr int kStageBytes = kABytes + (kBn / 64) * kBoxBytes;
constexpr int kOutBytes = kBm * kBn;              // half the tile's bf16 output
constexpr int kSmemBytes = kStages * kStageBytes + kOutBytes + 1024 + 2 * kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The consumer warpgroups only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A box of shared memory at `src` to the 3-D tensor map's box at (c0, c1, c2); the
// parts out of bounds are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1); offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr >> 4) & 0x3FFF) | uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, this warpgroup's fragment) += A (64 x 16) x B (16 x 256), both
// MN-major (imm-trans-a = imm-trans-b = 1): A's 64 rows and B's 256 columns run along
// the 128-byte swizzled rows of their tiles, K down the rows.
__device__ __forceinline__ void wgmma_tt(float (&d)[kBn / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The expert of a row tile by the reference's rule (jnp indexing): a negative
// id wraps once (+E), then the id clamps to [0, E - 1].
__device__ __forceinline__ int expert_id(int id, int n_experts) {
  return min(max(id < 0 ? id + n_experts : id, 0), n_experts - 1);
}

// Row tiles of expert e among tile_eid's n_tiles, counted by one warp, 32 ids a ballot.
__device__ __forceinline__ int tiles_of(const int* __restrict__ tile_eid, int n_tiles,
                                        int n_experts, int e) {
  const int lane = threadIdx.x & 31;
  int owned = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    owned += __popc(__ballot_sync(
        0xffffffffu, t < n_tiles && expert_id(tile_eid[t], n_experts) == e));
  }
  return owned;
}

// Output tile u of the persistent walk: columns fastest, then channel blocks, then
// the expert, so the CTAs that run together share an expert's rows.
struct OutTile {
  int n0, m0, e;
};
__device__ __forceinline__ OutTile out_tile(int u, int n_blocks, int m_blocks) {
  return {u % n_blocks * kBn, u / n_blocks % m_blocks * kBm, u / (n_blocks * m_blocks)};
}

// Columns HALF * kBn / 2 .. + kBn / 2 - 1 of the consumers' tile out through the
// shared-memory buffer `out` and TMA stores that run on under the next tile's main
// loop: once the stores before have read the buffer, each warpgroup writes its 64 rows
// into slabs of 64 columns (128 rows of 128 bytes, 128-byte swizzle: 16-byte chunk c of
// row r at chunk c ^ (r % 8)), and one thread stores each slab; TMA clips rows past Cin
// and columns past Cout.
template <int HALF>
__device__ __forceinline__ void store_half(const float (&acc)[kBn / 2], uint32_t out,
                                           const CUtensorMap* out_map, int n0, int m0,
                                           int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  consumers_sync();
  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8),
  // columns 8 i + 2 (lane % 4) (+ 1)
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBn / 16; ++j) {
    constexpr int kFirst = HALF * kBn / 16;   // the half's first group of 8 columns
    const uint32_t slab = out + (j / 8) * (kBm * 128) + 4 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * (kFirst + j) + 2 * h],
                                                     acc[4 * (kFirst + j) + 2 * h + 1]);
      asm volatile("st.shared.b32 [%0], %1;" ::"r"(slab + r * 128 + (((j % 8) ^ (r & 7)) << 4)),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  consumers_sync();
  if (threadIdx.x == 0) {
    for (int q = 0; q < kBn / 128; ++q)
      tma_store_3d(out_map, out + q * (kBm * 128), n0 + HALF * kBn / 2 + 64 * q, m0, e);
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    grouped_matmul_dw_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                                   const __grid_constant__ CUtensorMap dy_map,
                                   const __grid_constant__ CUtensorMap out_map,
                                   const int* __restrict__ tile_eid, int n_tiles, int cin,
                                   int cout, int n_experts, int row_tile) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle: every tile starts on a 1024-byte boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out = base + kStages * kStageBytes;
  const uint32_t bars = out + kOutBytes;   // full[s], then empty[s]
  const int n_blocks = (cout + kBn - 1) / kBn, m_blocks = (cin + kBm - 1) / kBm;
  const int n_out = n_blocks * m_blocks * n_experts;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the same output tiles; the stage ring runs on across them, so the
  // producer loads the next tile while the consumers finish this one.
  if (warp == kConsumerWarps) {   // producer: each tile's expert rows in order
    int k = 0;
    for (int u = blockIdx.x; u < n_out; u += gridDim.x) {
      const OutTile o = out_tile(u, n_blocks, m_blocks);
      for (int t0 = 0; t0 < n_tiles; t0 += 32) {   // 32 ids a ballot
        const int t = t0 + lane;
        unsigned mine = __ballot_sync(
            0xffffffffu, t < n_tiles && expert_id(tile_eid[t], n_experts) == o.e);
        if (lane == 0) {
          while (mine) {
            const int r0 = (t0 + __ffs(mine) - 1) * row_tile;
            mine &= mine - 1;
            for (int r = r0; r < r0 + row_tile; r += kBk, ++k) {
              const int s = k % kStages;
              const uint32_t full = bars + 8 * s, a = base + s * kStageBytes;
              const uint32_t b = a + kABytes;
              mbar_wait(bars + 8 * (kStages + s), ((k / kStages) & 1) ^ 1);
              mbar_expect_tx(full, kStageBytes);
              tma_load_2d(a, &x_map, full, o.m0, r);
              tma_load_2d(a + kBoxBytes, &x_map, full, o.m0 + 64, r);
#pragma unroll
              for (int q = 0; q < kBn / 64; ++q)
                tma_load_2d(b + q * kBoxBytes, &dy_map, full, o.n0 + 64 * q, r);
            }
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of dW[e]
  const int wg = threadIdx.x >> 7;
  int k = 0, last_e = -1, steps = 0;
  for (int u = blockIdx.x; u < n_out; u += gridDim.x) {
    const OutTile o = out_tile(u, n_blocks, m_blocks);
    if (o.e != last_e) {
      steps = tiles_of(tile_eid, n_tiles, n_experts, o.e) * (row_tile / kBk);
      last_e = o.e;
    }
    float acc[kBn / 2];
#pragma unroll
    for (int i = 0; i < kBn / 2; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int i = 0; i < steps; ++i, ++k) {
      const int s = k % kStages;
      mbar_wait(bars + 8 * s, (k / kStages) & 1);
      const uint32_t a = base + s * kStageBytes + wg * kBoxBytes;
      const uint32_t b = base + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBk / 16; ++j) {
        // 16 K rows are 2 KB further down both tiles (K runs down the swizzled rows)
        wgmma_tt(acc, smem_desc(a + 2048 * j, kBoxBytes, 1024),
                     smem_desc(b + 2048 * j, kBoxBytes, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous stage's products are done: release it
      if (i > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (k - 1) % kStages));
    }
    wgmma_wait<0>();
    // the tile's last stage too: the ring runs on into the next tile
    if (steps > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (k - 1) % kStages));
    fence_acc(acc);

    store_half<0>(acc, out, &out_map, o.n0, o.m0, o.e);
    store_half<1>(acc, out, &out_map, o.n0, o.m0, o.e);
  }
  // the last stores have read shared memory before the CTA may leave
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                : nullptr;
  }();
  return fn;
}

// A bf16 tensor map with 128-byte swizzle and zeros out of bounds (a load) or no
// write there (a store); dims and box innermost first, strides in bytes of every dim
// but the first.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x or dY as (cols, rows), boxes of 64 columns by one K step of rows.
bool encode_rows(CUtensorMap* map, const void* ptr, int cols, int rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {64, kBk};
  return encode(map, ptr, 2, dims, strides, box);
}

int launch(const CUtensorMap& x_map, const CUtensorMap& dy_map, const CUtensorMap& out_map,
           const int* tile_eid, int rows, int cin, int cout, int n_experts, int row_tile,
           cudaStream_t stream) {
  // above 48 KB of dynamic shared memory; set on every call, so on every card
  const cudaError_t attr = cudaFuncSetAttribute(grouped_matmul_dw_wgmma_kernel,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                kSmemBytes);
  if (attr != cudaSuccess) return attr;
  // a persistent grid: one CTA an SM, or one a tile
  int device = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long n_out =
      (long long)((cout + kBn - 1) / kBn) * ((cin + kBm - 1) / kBm) * n_experts;
  if (n_out > 0x7fffffff) return cudaErrorInvalidValue;   // tile indices are ints
  const int grid = int(n_out < n_sm ? n_out : n_sm);
  grouped_matmul_dw_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      x_map, dy_map, out_map, tile_eid, rows / row_tile, cin, cout, n_experts, row_tile);
  return cudaGetLastError();
}

}  // namespace

// x (rows, cin) bf16; dy (rows, cout) bf16; tile_eid (rows / row_tile,) int32;
// dw (n_experts, cin, cout) bf16; all contiguous, x and dy 16-byte aligned.  cin and
// cout are multiples of 8 (TMA strides are multiples of 16 bytes), row_tile a multiple
// of 64, rows > 0 and a multiple of row_tile.  Returns a cudaError_t (0 = launched);
// -1 when libcuda has no cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int grouped_matmul_dw_wgmma(const void* x, const void* dy, const void* tile_eid,
                                       void* dw, int rows, int cin, int cout, int n_experts,
                                       int row_tile, void* stream) {
  if (rows <= 0 || cin <= 0 || cout <= 0 || n_experts <= 0 || n_experts > 65535 ||
      row_tile <= 0 || row_tile % kBk != 0 || rows % row_tile != 0 || cin % 8 != 0 ||
      cout % 8 != 0 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
        reinterpret_cast<uintptr_t>(dw)) & 15) != 0)
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return -1;
  // dW as (Cout, Cin, E) stored in boxes of 64 columns by 128 rows of one expert:
  // rows past Cin are out of bounds, so a store never reaches the next expert
  CUtensorMap x_map, dy_map, out_map;
  const cuuint64_t out_dims[3] = {cuuint64_t(cout), cuuint64_t(cin), cuuint64_t(n_experts)};
  const cuuint64_t out_strides[2] = {cuuint64_t(cout) * 2, cuuint64_t(cin) * cout * 2};
  const cuuint32_t out_box[3] = {64, kBm, 1};
  if (!encode_rows(&x_map, x, cin, rows) || !encode_rows(&dy_map, dy, cout, rows) ||
      !encode(&out_map, dw, 3, out_dims, out_strides, out_box))
    return -2;
  const int* eid = static_cast<const int*>(tile_eid);
  return launch(x_map, dy_map, out_map, eid, rows, cin, cout, n_experts, row_tile,
                static_cast<cudaStream_t>(stream));
}
