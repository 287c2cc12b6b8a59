// Grouped (per-expert) matmul for Hopper (sm_90a): the sorted MoE dispatch's expert FFN.
//
//   out[r, :] = x[r, :] @ W[tile_eid[r / row_tile]]      (float32 sums, out in x's type)
//
// Replaces src/repro/kernels/grouped_matmul/grouped_matmul.py:grouped_matmul_pallas
// (body _kernel): rows arrive sorted by expert and padded so that every row tile
// belongs to one expert; three launches per MoE layer of a prefill (w_in, w_gate,
// w_out).
//
// What bounds it on this card.  At granite-moe-1b's prefill (4096 tokens, 32 experts,
// top 8, capacity 1664) a call multiplies R = 53,248 rows by one 1024 x 512 (or
// 512 x 1024) expert matrix per row tile: 2 R Cin Cout = 55.8 GFLOP, 0.056 ms at
// 989 TFLOP/s (bf16 tensor cores), beside its bytes (x read once, the 32 expert
// matrices once, out written once: 197 MB in bf16), 0.059 ms at 3.35 TB/s.  The two
// are about even.  This kernel runs float32 FMAs (67 TFLOP/s at most), so it sits far
// above that bound.  bf16 calls at widths that are multiples of 8 go to the tensor-core
// kernel (grouped_matmul_wgmma.cu); this one keeps float32 exact (no TF32) and takes
// odd widths.
//
// What the design does about it.
//   * One CTA owns 64 rows (a row tile of 128 is split over two CTAs) and 128 output
//     columns; Cout is tiled over blockIdx.y.  The block loads its own expert id from
//     tile_eid (no scalar prefetch on this card) and streams W[eid] through shared
//     memory 16 input channels at a time; x's rows are read once per column tile.
//   * Nothing assumes equal expert segments: any tile_eid (an id out of range wraps
//     once if negative, then clamps, as the reference's gather does) and any
//     row_tile that is a multiple of 64.  Odd Cin and Cout are masked in the loads and stores.
//   * Warp w owns rows 8w..8w+7 of the tile and lane l the columns l + 32j (j < 4): a
//     thread keeps an 8 x 4 accumulator in registers; x is staged transposed so a
//     warp reads its 8 rows as two broadcast float4 loads, and W reads are conflict
//     free.
//   * float32 FMAs (bf16 operands are widened exactly), accumulation in float32, one
//     rounding to x's type at the store.  No cp.async double buffering, no tensor
//     cores (simple first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kBm = 64;                  // rows of a CTA (8 a warp)
constexpr int kBn = 128;                 // columns of a CTA (4 a lane)
constexpr int kBk = 16;                  // input channels staged a step
constexpr int kBmP = kBm + 4;            // padded row of the transposed x tile

template <bool BF16>
__device__ __forceinline__ float ld(const void* p, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return static_cast<const float*>(p)[i];
  }
}

template <bool BF16>
__device__ __forceinline__ void st(void* p, size_t i, float v) {
  if constexpr (BF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// The expert of a row tile by the reference's rule (jnp indexing): a negative
// id wraps once (+E), then the id clamps to [0, E - 1].
__device__ __forceinline__ int expert_id(int id, int n_experts) {
  return min(max(id < 0 ? id + n_experts : id, 0), n_experts - 1);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    grouped_matmul_kernel(const void* __restrict__ x, const int* __restrict__ tile_eid,
                          const void* __restrict__ w, void* __restrict__ out, int cin,
                          int cout, int n_experts, int row_tile) {
  __shared__ __align__(16) float s_a[kBk][kBmP];   // x tile, transposed
  __shared__ __align__(16) float s_b[kBk][kBn];    // W[eid] tile
  const int m0 = blockIdx.x * kBm, n0 = blockIdx.y * kBn;
  const int eid = expert_id(tile_eid[m0 / row_tile], n_experts);
  const size_t w_base = size_t(eid) * cin * cout;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < cin; k0 += kBk) {
    for (int t = threadIdx.x; t < kBm * kBk; t += kThreads) {
      const int r = t / kBk, kk = t - r * kBk;
      const int kc = k0 + kk;
      s_a[kk][r] = kc < cin ? ld<BF16>(x, size_t(m0 + r) * cin + kc) : 0.f;
    }
    for (int t = threadIdx.x; t < kBk * kBn; t += kThreads) {
      const int kk = t / kBn, c = t - kk * kBn;
      const int kc = k0 + kk, col = n0 + c;
      s_b[kk][c] = (kc < cin && col < cout)
                       ? ld<BF16>(w, w_base + size_t(kc) * cout + col)
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s_a[kk][warp * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s_a[kk][warp * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const size_t row = size_t(m0 + warp * 8 + i) * cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < cout) st<BF16>(out, row + col, acc[i][j]);
    }
  }
}

}  // namespace

// x (rows, cin); tile_eid (rows / row_tile,) int32; w (n_experts, cin, cout);
// out (rows, cout); x, w and out all float32 (bf16 = 0) or all bfloat16 (bf16 = 1),
// contiguous.  rows and row_tile are multiples of 64, rows of row_tile.  Returns a
// cudaError_t (0 = launched).
extern "C" int grouped_matmul(const void* x, const void* tile_eid, const void* w, void* out,
                              int rows, int cin, int cout, int n_experts, int row_tile,
                              int bf16, void* stream) {
  if (rows <= 0 || cin <= 0 || cout <= 0 || n_experts <= 0 || row_tile <= 0 ||
      row_tile % kBm != 0 || rows % row_tile != 0)
    return cudaErrorInvalidValue;
  const dim3 grid(rows / kBm, (cout + kBn - 1) / kBn);
  auto s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  if (bf16) {
    grouped_matmul_kernel<true><<<grid, kThreads, 0, s>>>(x, eid, w, out, cin, cout,
                                                           n_experts, row_tile);
  } else {
    grouped_matmul_kernel<false><<<grid, kThreads, 0, s>>>(x, eid, w, out, cin, cout,
                                                            n_experts, row_tile);
  }
  return cudaGetLastError();
}
