// Grouped (per-expert) matmul on Hopper's tensor cores (sm_90a), bf16 only: the sorted
// MoE dispatch's expert FFN at the LM prefill's widths.
//
//   out[r, :] = x[r, :] @ W[tile_eid[r / row_tile]]   (bf16 products, float32 sums,
//                                                       one rounding to bf16 at the store)
//
// Replaces src/repro/kernels/grouped_matmul/grouped_matmul.py:48 grouped_matmul_pallas
// (body _kernel) for bf16 operands whose Cin and Cout are multiples of 8 and whose row
// tile is a multiple of 128; `grouped_matmul.py::variant` picks it by shape and type.
// Every other call (float32, odd widths) keeps the float32-FMA kernel in
// grouped_matmul.cu, so float32 stays exact (no TF32).
//
// What bounds it on this card.  At granite-moe-1b's prefill (4096 tokens, 32 experts,
// top 8, capacity 1664) a call multiplies R = 53,248 rows by one 1024 x 512 (or
// 512 x 1024) expert matrix per row tile: 55.8 GFLOP, 0.056 ms at 989 TFLOP/s, beside
// 197 MB of bytes (x once, the 32 expert matrices once, out once), 0.059 ms at
// 3.35 TB/s.  About 280 FLOP a byte sits on the bf16 ridge, so the kernel has to keep
// the tensor cores fed from an asynchronous copy pipeline and read x and W from device
// memory about once.
//
// What the design does about it.
//   * One CTA owns 128 rows (inside one row tile, so one expert and one tile_eid load)
//     by 128 output columns.  Column tiles are blockIdx.x, the fastest-moving index,
//     so the CTAs that share a row block run together and read x from device memory
//     once; the 13 row tiles of an expert share its W, which stays in L2.
//   * One producer warp keeps a ring of kStages shared-memory stages filled with TMA
//     (`cp.async.bulk.tensor`): per 64-deep K step, x's 128 x 64 tile and W's 64 x 128
//     tile (two boxes of 64 columns: 128-byte swizzle caps a box row at 128 bytes),
//     completion counted on a `full` mbarrier.  Two consumer warpgroups each run
//     `wgmma.mma_async.m64n128k16.f32.bf16.bf16` over their 64 rows, four per stage,
//     and release the stage on an `empty` mbarrier once `wgmma.wait_group` says the
//     products that read it are done (one group stays in flight).
//   * x is K-major (rows of Cin); W (E, Cin, Cout) gives a B tile with N contiguous, so
//     B goes in transposed (imm-trans-b = 1) with the MN-major 128-byte-swizzle
//     descriptor: LBO = 8 KB between the two 64-column halves, SBO = 1 KB between
//     groups of 8 K rows.
//   * Tails read zeros, not a neighbour: W's tensor map is 3-D (Cout, Cin, E), so a K
//     step past Cin is out of bounds inside expert eid and TMA fills zeros (a 2-D map
//     over the flattened (E Cin, Cout) view would read expert eid + 1); x's 2-D map
//     (Cin, R) does the same for its K tail; columns past Cout load as zeros and are
//     masked at the store.  An id out of range wraps once if negative, then
//     clamps, as the reference's gather does (`expert_id`).
//   * Two CTAs fit on an SM (3 stages x 32 KB each), so one CTA's prologue and
//     epilogue overlap the other's main loop.
//   * The tensor maps depend on the pointers, so the host encodes them per call and
//     passes them as __grid_constant__ parameters.  cuTensorMapEncodeTiled lives in
//     libcuda, not in the runtime: it is looked up through the runtime's entry-point
//     query (cudaGetDriverEntryPointByVersion), so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBm = 128;                          // rows of a CTA
constexpr int kBn = 128;                          // output columns of a CTA
constexpr int kBk = 64;                           // K a stage (128 bytes of bf16)
constexpr int kStages = 3;
constexpr int kConsumers = 2;                     // warpgroups of 64 rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kABytes = kBm * kBk * 2;            // 16 KB
constexpr int kBHalfBytes = kBk * 64 * 2;         // 8 KB: 64 K rows of 64 columns
constexpr int kStageBytes = kABytes + 2 * kBHalfBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
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
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32, this warpgroup's fragment) += A (64 x 16, K-major) x B (16 x 128,
// transposed: N contiguous).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n\t}"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The expert of a row tile by the reference's rule (jnp indexing): a negative
// id wraps once (+E), then the id clamps to [0, E - 1].
__device__ __forceinline__ int expert_id(int id, int n_experts) {
  return min(max(id < 0 ? id + n_experts : id, 0), n_experts - 1);
}

__global__ void __launch_bounds__(kThreads, 2)
    grouped_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                                const __grid_constant__ CUtensorMap w_map,
                                const int* __restrict__ tile_eid,
                                __nv_bfloat16* __restrict__ out, int cin, int cout,
                                int n_experts, int row_tile) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle: every tile starts on a 1024-byte boundary
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;   // full[s], then empty[s]
  const int n0 = blockIdx.x * kBn, m0 = blockIdx.y * kBm;
  const int k_steps = (cin + kBk - 1) / kBk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {   // producer
    if (lane == 0) {
      const int eid = expert_id(tile_eid[m0 / row_tile], n_experts);
      for (int k = 0; k < k_steps; ++k) {
        const int s = k % kStages;
        const uint32_t full = bars + 8 * s, a = base + s * kStageBytes;
        const uint32_t b = a + kABytes;
        mbar_wait(bars + 8 * (kStages + s), ((k / kStages) & 1) ^ 1);
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(a, &x_map, full, k * kBk, m0);
        tma_load_3d(b, &w_map, full, n0, k * kBk, eid);
        tma_load_3d(b + kBHalfBytes, &w_map, full, n0 + 64, k * kBk, eid);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = threadIdx.x >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);
  for (int k = 0; k < k_steps; ++k) {
    const int s = k % kStages;
    mbar_wait(bars + 8 * s, (k / kStages) & 1);
    const uint32_t a = base + s * kStageBytes + wg * (64 * kBk * 2);
    const uint32_t b = base + s * kStageBytes + kABytes;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBk / 16; ++j) {
      // A: 16 K columns are 32 bytes further along each swizzled 128-byte row;
      // B: 16 K rows are 2 KB further down each 64-column half
      wgmma_m64n128k16(acc, smem_desc(a + 32 * j, 16, 1024),
                       smem_desc(b + 2048 * j, kBHalfBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the previous stage's products are done: release it
    if (k > 0 && lane == 0) mbar_arrive(bars + 8 * (kStages + (k - 1) % kStages));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane / 4 (+ 8),
  // columns 8 i + 2 (lane % 4) (+ 1)
  const int row = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  __nv_bfloat16* o0 = out + size_t(row) * cout;
  __nv_bfloat16* o1 = o0 + size_t(8) * cout;
#pragma unroll
  for (int i = 0; i < kBn / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    if (col < cout) {
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) =
          __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) =
          __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
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

// A bf16 tensor map with 128-byte swizzle and zero fill out of bounds; dims and box
// innermost first, strides in bytes of every dim but the first.
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x (rows, cin) bf16; tile_eid (rows / row_tile,) int32; w (n_experts, cin, cout) bf16;
// out (rows, cout) bf16; all contiguous, x / w / out 16-byte aligned.  cin and cout are
// multiples of 8 (TMA strides are multiples of 16 bytes), row_tile a multiple of 128,
// rows of row_tile.  Returns a cudaError_t (0 = launched); -1 when libcuda has no
// cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int grouped_matmul_wgmma(const void* x, const void* tile_eid, const void* w,
                                    void* out, int rows, int cin, int cout, int n_experts,
                                    int row_tile, void* stream) {
  if (rows <= 0 || cin <= 0 || cout <= 0 || n_experts <= 0 || row_tile <= 0 ||
      row_tile % kBm != 0 || rows % row_tile != 0 || cin % 8 != 0 || cout % 8 != 0 ||
      rows / kBm > 65535 ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) & 15) != 0)
    return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return -1;
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {cuuint64_t(cin), cuuint64_t(rows)};
  const cuuint64_t x_strides[1] = {cuuint64_t(cin) * 2};
  const cuuint32_t x_box[2] = {kBk, kBm};
  const cuuint64_t w_dims[3] = {cuuint64_t(cout), cuuint64_t(cin), cuuint64_t(n_experts)};
  const cuuint64_t w_strides[2] = {cuuint64_t(cout) * 2, cuuint64_t(cin) * cout * 2};
  const cuuint32_t w_box[3] = {64, kBk, 1};
  if (!encode(&x_map, x, 2, x_dims, x_strides, x_box) ||
      !encode(&w_map, w, 3, w_dims, w_strides, w_box))
    return -2;
  // above 48 KB of dynamic shared memory; set on every call, so on every card
  const cudaError_t attr = cudaFuncSetAttribute(
      grouped_matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((cout + kBn - 1) / kBn, rows / kBm);
  grouped_matmul_wgmma_kernel<<<grid, kThreads, kSmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<const int*>(tile_eid),
      static_cast<__nv_bfloat16*>(out), cin, cout, n_experts, row_tile);
  return cudaGetLastError();
}
