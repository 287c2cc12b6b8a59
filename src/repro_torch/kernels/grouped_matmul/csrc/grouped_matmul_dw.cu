// Weight gradient of the grouped (per-expert) matmul for Hopper (sm_90a): the
// backward of the sorted MoE dispatch's expert FFN with respect to the weights.
//
//   dW[e] = sum over row tiles i with expert(tile_eid[i]) == e of  x_i^T @ dY_i
//
// x_i (row_tile, Cin) and dY_i (row_tile, Cout) are row tile i of the forward's
// input and of the output's gradient; float32 sums, dW written in x's type.  An id
// out of range is resolved as the forward resolves it (a negative id wraps once,
// then clamps to [0, E - 1]), so dW is the gradient of the forward as computed,
// which is what autograd of the plain version (a gather of W by those ids) gives.
// This is not a port of a TPU kernel: the reference trains through its plain
// grouped matmul, so it has no backward kernel.  The port trains through its
// forward kernels and needs this one.
//
// Design (simple first).
//   * One CTA per (64 rows of dW[e], 128 columns of dW[e], expert e): grid
//     (ceil(Cin / 64), ceil(Cout / 128), E).  Every CTA writes its whole tile, so an
//     expert that owns no row tile gets zeros; no two CTAs write one element, so
//     there are no atomics.
//   * A CTA walks the row tiles in order, skips those of other experts, and streams
//     each of its own 16 rows at a time through shared memory: x's 16 x 64 slice and
//     dY's 16 x 128 slice, both read along contiguous rows.  The product is the
//     forward kernel's inner loop with the roles of rows and channels swapped: warp
//     w owns dW rows 8w..8w+7, lane l the columns l + 32j (j < 4), an 8 x 4 float32
//     accumulator in registers.
//   * float32 FMAs (bf16 operands are widened exactly), one rounding at the store.
//     No tensor cores, no double buffering: the speed-up is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBm = 64;         // rows of dW (input channels) a CTA
constexpr int kBn = 128;        // columns of dW (output channels) a CTA
constexpr int kBk = 16;         // rows of x / dY staged a step
constexpr int kBmP = kBm + 4;   // padded row of the x slice

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

// The forward's rule (jnp indexing): a negative id wraps once (+E), then clamps.
__device__ __forceinline__ int expert_id(int id, int n_experts) {
  return min(max(id < 0 ? id + n_experts : id, 0), n_experts - 1);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    grouped_matmul_dw_kernel(const void* __restrict__ x, const void* __restrict__ dy,
                             const int* __restrict__ tile_eid, void* __restrict__ dw,
                             int n_tiles, int cin, int cout, int n_experts,
                             int row_tile) {
  __shared__ __align__(16) float s_a[kBk][kBmP];   // x rows, channels along a row
  __shared__ __align__(16) float s_b[kBk][kBn];    // dY rows
  const int c0 = blockIdx.x * kBm, n0 = blockIdx.y * kBn, e = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (expert_id(tile_eid[t], n_experts) != e) continue;   // uniform over the CTA
    const size_t r_base = size_t(t) * row_tile;
    for (int k0 = 0; k0 < row_tile; k0 += kBk) {
      for (int u = threadIdx.x; u < kBk * kBm; u += kThreads) {
        const int kk = u / kBm, c = u - kk * kBm;
        const int ch = c0 + c;
        s_a[kk][c] = ch < cin ? ld<BF16>(x, (r_base + k0 + kk) * cin + ch) : 0.f;
      }
      for (int u = threadIdx.x; u < kBk * kBn; u += kThreads) {
        const int kk = u / kBn, c = u - kk * kBn;
        const int col = n0 + c;
        s_b[kk][c] = col < cout ? ld<BF16>(dy, (r_base + k0 + kk) * cout + col) : 0.f;
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
  }

  const size_t base = size_t(e) * cin * cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = c0 + warp * 8 + i;
    if (ch >= cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < cout) st<BF16>(dw, base + size_t(ch) * cout + col, acc[i][j]);
    }
  }
}

}  // namespace

// x (rows, cin); dy (rows, cout); tile_eid (rows / row_tile,) int32;
// dw (n_experts, cin, cout); x, dy and dw all float32 (bf16 = 0) or all bfloat16
// (bf16 = 1), contiguous.  row_tile is a multiple of 16, rows of row_tile.  Returns a
// cudaError_t (0 = launched).
extern "C" int grouped_matmul_dw(const void* x, const void* dy, const void* tile_eid,
                                 void* dw, int rows, int cin, int cout, int n_experts,
                                 int row_tile, int bf16, void* stream) {
  if (rows < 0 || cin <= 0 || cout <= 0 || n_experts <= 0 || row_tile <= 0 ||
      row_tile % kBk != 0 || rows % row_tile != 0 || n_experts > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((cin + kBm - 1) / kBm, (cout + kBn - 1) / kBn, n_experts);
  auto s = static_cast<cudaStream_t>(stream);
  const int* eid = static_cast<const int*>(tile_eid);
  const int n_tiles = rows / row_tile;
  if (bf16) {
    grouped_matmul_dw_kernel<true><<<grid, kThreads, 0, s>>>(
        x, dy, eid, dw, n_tiles, cin, cout, n_experts, row_tile);
  } else {
    grouped_matmul_dw_kernel<false><<<grid, kThreads, 0, s>>>(
        x, dy, eid, dw, n_tiles, cin, cout, n_experts, row_tile);
  }
  return cudaGetLastError();
}
