// Fetch-on-demand sparse convolution for Hopper (sm_90a), float32.
//
//   out[j, :] = epilogue( sum_k  feats[inv[k, j], :] @ W[k] ),  inv[k, j] = -1 -> no term
//
// One template, two C entry points:
//
//   spconv_fod        replaces src/repro/kernels/spconv/spconv.py:spconv_fod_pallas
//                     (body _kernel): the sum alone, no epilogue.  Cout may exceed
//                     one tile: blockIdx.y walks Cout in tiles of up to 256 columns.
//   spconv_fod_fused  replaces src/repro/kernels/spconv/spconv.py:spconv_fod_fused_pallas
//                     (body _fused_kernel): the sum, then at flush
//                     +bias -> layernorm (eps 1e-6, over the true Cout) -> +residual
//                     -> ReLU -> *mask, then one write.  One CTA owns the whole Cout
//                     row, because the layernorm needs it: Cout <= 256 (the largest
//                     on the MinkUNet path), larger Cout is refused.
//
// What bounds it on this card.  The work is data dependent: only the non-empty
// entries of inv are real.  For a full-width MinkUNet forward on a 50k-point scene
// in the 65536 bucket the 41 convs hold about 71 GFLOP of real multiply-adds
// (2 * nnz(inv) * Cin * Cout), against about 2.5 TFLOP if every padded row and
// empty offset were computed.  The bytes each conv must move (features, inv, W,
// output, residual, each once) are a few tens of MB.  At 3.35 TB/s and 67 TFLOP/s
// (float32 without tensor cores) every conv is bound by operations, not bytes.
//
// What the design does about it.
//   * Skip dead work: a CTA loads its 64-row slice of inv[k] and skips offset k
//     when the slice is all -1 (the Pallas kernel's pl.when(jnp.any(ok))); a tile
//     of padding rows skips every offset and only runs its flush.
//   * Output-stationary: the 64 x Cout accumulator lives in registers for the
//     whole K loop; partial sums never touch device memory.  Warp w owns rows
//     8w..8w+7 and lane l owns columns l + 32j, so the layernorm's row reductions
//     are warp shuffles and need no shared memory.
//   * Fetch on demand: for each live offset and each chunk of 32 input channels,
//     the referenced feature rows are gathered straight into shared memory
//     (zeros for -1 and for channels past Cin) next to the matching W[k] slice;
//     the gathered matrix never exists in device memory.  Cin = 4 (the stem) and
//     Cout = 96 are masked, not padded.
//   * Shared memory is one chunk: 64 x 32 inputs + 32 x 256 weights = 40 KB,
//     under the 48 KB static limit, so no dynamic shared memory attribute is
//     needed.  Registers (64 accumulators a thread at Cout 256) limit occupancy.
//   * float32 FMAs on the CUDA cores, no TF32: the reference accumulates in f32.
//
// The main path runs spconv_tc.cu (split-float TF32 on the tensor cores); this kernel
// keeps the shapes that one does not take (spconv.py `variant`: Cin or Cout not a
// multiple of 4, operands not 16-byte aligned) and serves as the earlier kernel that
// chip_smoke.py times beside it.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRows = 64;                              // output rows per CTA
constexpr int kThreads = 256;                          // 8 warps
constexpr int kRowsPerWarp = kRows / (kThreads / 32);  // 8
constexpr int kChunk = 32;                             // input channels per step
constexpr int kMaxCout = 256;
constexpr float kLnEps = 1e-6f;                        // repro nn.layernorm eps

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NJ>
__device__ __forceinline__ void mac(float (&acc)[kRowsPerWarp][NJ],
                                    const float (*s_x)[kChunk],
                                    const float* s_wrow, int warp, int lane, int kk) {
  float b[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) b[j] = s_wrow[lane + 32 * j];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float a = s_x[warp * kRowsPerWarp + i][kk];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
  }
}

// CN: columns per CTA (a power of two, 32..256); FUSED: apply the epilogue.
template <int CN, bool FUSED>
__global__ void __launch_bounds__(kThreads)
spconv_fod_fma_kernel(const float* __restrict__ feats, const int* __restrict__ inv,
                  const float* __restrict__ w, const float* __restrict__ bias,
                  const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                  const float* __restrict__ residual, const float* __restrict__ mask,
                  float* __restrict__ out, int n, int cin, int kvol, int m, int cout,
                  int relu) {
  constexpr int NJ = CN / 32;
  __shared__ int s_idx[kRows];
  __shared__ __align__(16) float s_x[kRows][kChunk];
  __shared__ __align__(16) float s_w[kChunk][CN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * CN;

  float acc[kRowsPerWarp][NJ];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < kvol; ++k) {
    int idx = -1;
    if (tid < kRows) {
      const int r = row0 + tid;
      if (r < m) idx = inv[(size_t)k * m + r];
      if (idx >= n) idx = -1;  // never read outside the feature array
      s_idx[tid] = idx;
    }
    // All -1 in this tile's slice: skip the offset (uniform across the CTA).
    if (!__syncthreads_or(idx >= 0)) continue;

    for (int c0 = 0; c0 < cin; c0 += kChunk) {
      const int kc = min(kChunk, cin - c0);
      for (int e = tid; e < kRows * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        const int src = s_idx[r];
        s_x[r][c] = (src >= 0 && c < kc) ? __ldg(feats + (size_t)src * cin + c0 + c) : 0.f;
      }
      const float* wk = w + ((size_t)k * cin + c0) * cout + n0;
      for (int e = tid; e < kChunk * CN; e += kThreads) {
        const int c = e / CN, col = e % CN;
        s_w[c][col] = (c < kc && n0 + col < cout) ? __ldg(wk + (size_t)c * cout + col) : 0.f;
      }
      __syncthreads();
      if (kc == kChunk) {
#pragma unroll 8
        for (int kk = 0; kk < kChunk; ++kk) mac<NJ>(acc, s_x, s_w[kk], warp, lane, kk);
      } else {
        for (int kk = 0; kk < kc; ++kk) mac<NJ>(acc, s_x, s_w[kk], warp, lane, kk);
      }
      __syncthreads();
    }
  }

  // Flush: every row of the tile is written, live or not (the output is
  // allocated uninitialised), so a row with no input still gets epilogue(0).
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = row0 + warp * kRowsPerWarp + i;  // uniform across the warp
    float v[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) v[j] = acc[i][j];
    if constexpr (FUSED) {
      if (bias != nullptr) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + lane + 32 * j;
          if (col < cout) v[j] += bias[col];
        }
      }
      if (ln_scale != nullptr) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) s += (n0 + lane + 32 * j < cout) ? v[j] : 0.f;
        const float mu = warp_sum(s) / (float)cout;
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float d = v[j] - mu;
          q += (n0 + lane + 32 * j < cout) ? d * d : 0.f;
        }
        const float rstd = rsqrtf(warp_sum(q) / (float)cout + kLnEps);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + lane + 32 * j;
          if (col < cout) v[j] = (v[j] - mu) * rstd * ln_scale[col] + ln_bias[col];
        }
      }
      if (r < m) {
        const float mk = mask != nullptr ? mask[r] : 1.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = n0 + lane + 32 * j;
          if (col >= cout) continue;
          if (residual != nullptr) v[j] += residual[(size_t)r * cout + col];
          if (relu) v[j] = fmaxf(v[j], 0.f);
          if (mask != nullptr) v[j] *= mk;
        }
      }
    }
    if (r < m) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + lane + 32 * j;
        if (col < cout) out[(size_t)r * cout + col] = v[j];
      }
    }
  }
}

int pick_cn(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
}

template <bool FUSED>
int dispatch(dim3 grid, cudaStream_t st, const float* feats, const int* inv,
             const float* w, const float* bias, const float* ln_scale,
             const float* ln_bias, const float* residual, const float* mask,
             float* out, int n, int cin, int kvol, int m, int cout, int relu) {
  switch (pick_cn(cout)) {
    case 32:
      spconv_fod_fma_kernel<32, FUSED><<<grid, kThreads, 0, st>>>(
          feats, inv, w, bias, ln_scale, ln_bias, residual, mask, out, n, cin, kvol, m,
          cout, relu);
      break;
    case 64:
      spconv_fod_fma_kernel<64, FUSED><<<grid, kThreads, 0, st>>>(
          feats, inv, w, bias, ln_scale, ln_bias, residual, mask, out, n, cin, kvol, m,
          cout, relu);
      break;
    case 128:
      spconv_fod_fma_kernel<128, FUSED><<<grid, kThreads, 0, st>>>(
          feats, inv, w, bias, ln_scale, ln_bias, residual, mask, out, n, cin, kvol, m,
          cout, relu);
      break;
    default:
      spconv_fod_fma_kernel<256, FUSED><<<grid, kThreads, 0, st>>>(
          feats, inv, w, bias, ln_scale, ln_bias, residual, mask, out, n, cin, kvol, m,
          cout, relu);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// feats (n, cin), inv (kvol, m) int32, w (kvol, cin, cout), out (m, cout); all
// float32 unless noted, contiguous, on the device.  Returns cudaGetLastError().
extern "C" int spconv_fod(const float* feats, const int* inv, const float* w,
                          float* out, int n, int cin, int kvol, int m, int cout,
                          void* stream) {
  if (n < 0 || cin < 1 || kvol < 1 || m < 1 || cout < 1) return (int)cudaErrorInvalidValue;
  const int cn = pick_cn(cout);
  const dim3 grid((m + kRows - 1) / kRows, (cout + cn - 1) / cn);
  return dispatch<false>(grid, static_cast<cudaStream_t>(stream), feats, inv, w, nullptr,
                         nullptr, nullptr, nullptr, nullptr, out, n, cin, kvol, m, cout, 0);
}

// As spconv_fod, plus the epilogue operands: bias, ln_scale, ln_bias (cout,),
// residual (m, cout), mask (m,) float; each may be null (= skipped), ln_scale and
// ln_bias together.  cout <= 256.
extern "C" int spconv_fod_fused(const float* feats, const int* inv, const float* w,
                                const float* bias, const float* ln_scale,
                                const float* ln_bias, const float* residual,
                                const float* mask, float* out, int n, int cin, int kvol,
                                int m, int cout, int relu, void* stream) {
  if (n < 0 || cin < 1 || kvol < 1 || m < 1 || cout < 1 || cout > kMaxCout)
    return (int)cudaErrorInvalidValue;
  if ((ln_scale == nullptr) != (ln_bias == nullptr)) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kRows - 1) / kRows, 1);
  return dispatch<true>(grid, static_cast<cudaStream_t>(stream), feats, inv, w, bias,
                        ln_scale, ln_bias, residual, mask, out, n, cin, kvol, m, cout,
                        relu);
}
