// Temporal layer fusion for Hopper (sm_90a): a chain of dense layers per row tile, in
// float32 FMAs.  The tensor-core kernel (fused_mlp_tc.cu) takes every 16-byte-aligned
// operand set; this one keeps the rest (fused_mlp.py `plan_mlp`, variant "fma"), and
// `fused_mlp_kernel(..., kind="fma")` runs it for tests and timing.
//
//   h_0 = x;  h_{i+1} = act_i(h_i @ W_i + b_i);  out = h_L   (act = ReLU, none on the
//   last layer unless final_act)
//
// Replaces src/repro/kernels/fused_mlp/fused_mlp.py:fused_mlp_pallas (body _kernel):
// one launch per fusion group of the paper's planner (PointAcc section 4.2.4); only
// the group's last activation is written to device memory.
//
// What bounds it on this card.  The chains of the PointNet family are narrow
// (3..1024 channels).  A PointNet++(s) forward at 16 x 4096 points holds about
// 4 GFLOP of multiply-adds in its six groups, and its widest group (sa1, 131072 rows
// of 3 channels in, 64 out) must write 34 MB.  At 3.35 TB/s and 67 TFLOP/s (float32
// without tensor cores) the row-heavy groups are bound by bytes, the 1024-wide
// PointNet layers by operations.
//
// What the design does about it.
//   * One CTA owns a tile of R = 8 * RPW rows (64, 32, 16 or 8; the wrapper picks the
//     largest whose buffers fit, smaller while the grid would not fill the card).  A
//     single-layer group whose row tiles still do not fill the card (PointNet's head
//     at a few rows) splits its column passes over blockIdx.y.
//     The x tile is staged into shared memory once; each layer reads its input
//     activation from one shared buffer and writes the next into the other
//     (ping-pong), so intermediate activations never touch device memory.  The last
//     layer writes straight from registers to `out`.
//   * Weights are not assumed resident: for each pass of up to 128 output columns,
//     W streams through shared memory in chunks of 32 input channels (16 KB).  This
//     serves the single-layer groups the planner emits far above 227 KB (PointNet's
//     128->1024 and 1024->512).
//   * Warp w owns rows w*RPW .. w*RPW+RPW-1 of the tile and lane l the columns
//     l + 32j (j < 4) of the pass: every activation read is a warp broadcast and
//     every weight read is conflict free.  Passes narrower than 128 columns run with
//     fewer columns a lane (NJ = 1..3), so 32- and 64-wide layers waste no lanes.
//   * Odd widths (3, 67, 131, 259, 6, 13) are masked in the loads and stores, not
//     padded in memory; a ragged last row tile computes zeros and writes nothing.
//   * float32 FMAs, accumulation in float32, no TF32.  x, W, b and out are all float32
//     or all bfloat16; activations stay float32 inside the group and the output is
//     rounded to x's type (round to nearest even), as the Pallas kernel does.
//   * Simple first: no cp.async/TMA overlap of the weight stream, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kKc = 32;                  // input channels of W staged per step
constexpr int kCn = 128;                 // output columns per pass (4 per lane)
constexpr int kMaxLayers = 16;
constexpr size_t kMaxSmem = 232448;      // H100: shared memory a block can use
constexpr size_t kDefaultSmem = 48 * 1024;  // usable without the attribute
constexpr int kMaxDevices = 64;

struct Chain {
  const void* w[kMaxLayers];             // W_i (C_i, C_{i+1}), row major
  const void* b[kMaxLayers];             // b_i (C_{i+1},)
  int widths[kMaxLayers + 1];
  int n_layers;
  int buf0;                              // floats a row in buffer 0 (even layers' inputs)
};

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

// Columns [n0, n0 + ncols) of one layer for the CTA's rows: acc = in @ W[:, n0:],
// W streamed through s_w; then +bias (+ReLU) and the write, to the next shared
// buffer `o`, or to `out` (global, `rows` valid rows from row0) on the last layer.
template <int RPW, int NJ, bool BF16>
__device__ __forceinline__ void column_pass(const float* in, int cin, const void* w,
                                            const void* b, int cout, int n0, int ncols,
                                            bool relu, float* s_w, float* o, void* out,
                                            int row0, int rows) {
  constexpr int kW = 32 * NJ;            // staged columns of this pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[RPW][NJ];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const float* a_rows = in + warp * RPW * cin;
  for (int k0 = 0; k0 < cin; k0 += kKc) {
    const int kc = min(kKc, cin - k0);
    for (int e = threadIdx.x; e < kKc * kW; e += kThreads) {
      const int kk = e / kW, c = e - kk * kW;
      s_w[e] = (kk < kc && c < ncols) ? ld<BF16>(w, size_t(k0 + kk) * cout + n0 + c)
                                      : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kc; ++kk) {
      float bv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = s_w[kk * kW + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float a = a_rows[i * cin + k0 + kk];
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int c = lane + 32 * j;
    if (c >= ncols) continue;
    const float bias = ld<BF16>(b, n0 + c);
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      float v = acc[i][j] + bias;
      if (relu) v = fmaxf(v, 0.f);
      if (out != nullptr) {
        if (r < rows) st<BF16>(out, size_t(row0 + r) * cout + n0 + c, v);
      } else {
        o[r * cout + n0 + c] = v;
      }
    }
  }
}

template <int RPW, bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_fma_kernel(Chain ch, const void* __restrict__ x, void* __restrict__ out,
                     int n_rows, int final_act) {
  constexpr int R = kWarps * RPW;
  extern __shared__ float smem[];
  float* s_w = smem;
  float* buf0 = smem + kKc * kCn;
  float* buf1 = buf0 + R * ch.buf0;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n_rows - row0);

  const int c0 = ch.widths[0];
  for (int e = threadIdx.x; e < R * c0; e += kThreads) {
    buf0[e] = e / c0 < rows ? ld<BF16>(x, size_t(row0) * c0 + e) : 0.f;
  }
  __syncthreads();

  for (int l = 0; l < ch.n_layers; ++l) {
    const int cin = ch.widths[l], cout = ch.widths[l + 1];
    const bool last = l == ch.n_layers - 1;
    const bool relu = !last || final_act;
    const float* in = (l & 1) ? buf1 : buf0;
    float* o = (l & 1) ? buf0 : buf1;
    void* dst = last ? out : nullptr;
    // the last layer's column passes are split over blockIdx.y (the wrapper
    // splits single-layer groups only, so no earlier layer is recomputed)
    const int step = last ? gridDim.y * kCn : kCn;
    for (int n0 = last ? blockIdx.y * kCn : 0; n0 < cout; n0 += step) {
      const int ncols = min(kCn, cout - n0);
      switch ((ncols + 31) / 32) {
        case 1:
          column_pass<RPW, 1, BF16>(in, cin, ch.w[l], ch.b[l], cout, n0, ncols, relu,
                                    s_w, o, dst, row0, rows);
          break;
        case 2:
          column_pass<RPW, 2, BF16>(in, cin, ch.w[l], ch.b[l], cout, n0, ncols, relu,
                                    s_w, o, dst, row0, rows);
          break;
        case 3:
          column_pass<RPW, 3, BF16>(in, cin, ch.w[l], ch.b[l], cout, n0, ncols, relu,
                                    s_w, o, dst, row0, rows);
          break;
        default:
          column_pass<RPW, 4, BF16>(in, cin, ch.w[l], ch.b[l], cout, n0, ncols, relu,
                                    s_w, o, dst, row0, rows);
          break;
      }
    }
    __syncthreads();  // layer l's output is complete before layer l+1 reads it
  }
}

template <int RPW, bool BF16>
cudaError_t launch(const Chain& ch, const void* x, void* out, int n_rows, int col_splits,
                   int final_act, size_t smem, cudaStream_t stream) {
  // The dynamic shared memory this instance may use, per device: raised (once to
  // the card's maximum) the first time a launch needs more than the 48 KB default,
  // so later launches, and launches captured in a CUDA graph, make no extra call.
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && !raised[dev]) {
    err = cudaFuncSetAttribute(fused_mlp_fma_kernel<RPW, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  constexpr int R = kWarps * RPW;
  const dim3 grid((n_rows + R - 1) / R, col_splits);
  fused_mlp_fma_kernel<RPW, BF16><<<grid, kThreads, smem, stream>>>(ch, x, out, n_rows,
                                                                final_act);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const Chain& ch, const void* x, void* out, int n_rows,
                     int rows_per_cta, int col_splits, int final_act, size_t smem,
                     cudaStream_t stream) {
  switch (rows_per_cta) {
    case 64: return launch<8, BF16>(ch, x, out, n_rows, col_splits, final_act, smem, stream);
    case 32: return launch<4, BF16>(ch, x, out, n_rows, col_splits, final_act, smem, stream);
    case 16: return launch<2, BF16>(ch, x, out, n_rows, col_splits, final_act, smem, stream);
    case 8: return launch<1, BF16>(ch, x, out, n_rows, col_splits, final_act, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (n_rows, widths[0]); w[i] (widths[i], widths[i+1]); b[i] (widths[i+1],);
// out (n_rows, widths[n_layers]); all float32 (bf16 = 0) or all bfloat16 (bf16 = 1),
// contiguous.  rows_per_cta is 64, 32, 16 or 8; col_splits CTAs share each row tile's
// last-layer column passes.  Returns a cudaError_t (0 = launched).
extern "C" int fused_mlp(const void* x, void* out, const void* const* w,
                         const void* const* b, const int* widths, int n_layers,
                         int n_rows, int rows_per_cta, int col_splits, int bf16,
                         int final_act, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows <= 0 || col_splits < 1)
    return cudaErrorInvalidValue;
  Chain ch;
  int buf1 = 0;
  ch.buf0 = 0;
  ch.n_layers = n_layers;
  for (int i = 0; i <= n_layers; ++i) ch.widths[i] = widths[i];
  for (int i = 0; i < n_layers; ++i) {
    ch.w[i] = w[i];
    ch.b[i] = b[i];
    if (i & 1) {
      buf1 = widths[i] > buf1 ? widths[i] : buf1;
    } else {
      ch.buf0 = widths[i] > ch.buf0 ? widths[i] : ch.buf0;
    }
  }
  const size_t smem =
      sizeof(float) * (size_t(kKc) * kCn + size_t(rows_per_cta) * (ch.buf0 + buf1));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(ch, x, out, n_rows, rows_per_cta, col_splits, final_act,
                               smem, s)
              : dispatch<false>(ch, x, out, n_rows, rows_per_cta, col_splits, final_act,
                                smem, s);
}
