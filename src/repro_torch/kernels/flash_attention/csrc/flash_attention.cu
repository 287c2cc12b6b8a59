// Blockwise (flash) attention for Hopper (sm_90a) on float32 FMAs, forward only.
//
//   out[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / G, j]))) @ v[b, h / G]
//
// with cap(s) = softcap * tanh(s / softcap) when a softcap is given, and mask keeping
// j <= i (causal) and i - j < window (sliding window); masked logits are -1e30.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:96 flash_attention_pallas
// (body _kernel) where the tensor-core kernel (flash_attention_wgmma.cu) does not:
// float32 (exact, no TF32) and every head_dim, group size or alignment that kernel
// does not take; `flash_attention.py::variant` picks between them.  The LM prefill at
// bf16 takes the tensor-core kernel.
//
// What bounds it on this card.  At granite-moe-1b's prefill (B 8, 16 query heads over
// 8 kv heads, S 512, head_dim 64, bf16) the call must read q, k, v and write the
// output: about 25 MB, 8 us at 3.35 TB/s.  The causal products are 4.3 GFLOP
// (QK^T and PV over the lower triangle, 4 B Hq pairs D), 4.4 us at 989 TFLOP/s.  So
// bytes bound it; on float32 FMAs (67 TFLOP/s) the products take 64 us.
//
// What the design does about it.
//   * GQA reuse: one CTA owns (batch, kv head, block of BQ query positions) with all G
//     query heads of that kv head: 64 query rows = G x BQ (BQ = 64 / G).  Each K/V tile
//     staged into shared memory serves all G heads, as the Pallas kernel's kv BlockSpec
//     ignores the group axis.  q, k and v are each read from device memory once per
//     CTA; the output is written once.
//   * Online softmax: per-row running max m and sum l live in registers; the f32
//     accumulator (64 rows x head_dim) lives in registers, 4 rows x NJ columns a thread.
//   * kv tiles of 64 keys that the causal mask or the window leave empty are never
//     loaded (the Pallas kernel's pl.when tile skip).  Inside a tile the softcap comes
//     first, then the mask with the reference's predicates; at the flush l == 0 -> 1.
//   * Any Sq and Skv: rows past Sq are computed on zeros and not written; keys past Skv
//     are loaded as zeros and masked.  head_dim is a multiple of 8 up to 256.
//   * Thread layout: 256 threads = 16 (ty) x 16 (tx).  Thread (ty, tx) computes the
//     scores of rows 4ty..4ty+3 against keys tx + 16j and the output columns tx + 16j;
//     row statistics are reduced with shuffles across the 16 lanes of a half warp.
//     K is staged transposed and padded, so score reads are conflict free.
//   * float32 FMAs (no tensor cores: simple first), q scaled in f32 as the reference
//     does, output rounded once to the input type (round to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;            // 16 x 16
constexpr int kRows = 64;                // query rows of a CTA (G heads x BQ positions)
constexpr int kBk = 64;                  // keys of a kv tile
constexpr int kBkP = kBk + 1;            // padded row of K^T and P in shared memory
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;      // H100: shared memory a block can use
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;                         // (B, Hq, Sq, D)
  const void* k;                         // (B, Hkv, Skv, D)
  const void* v;
  void* o;                               // (B, Hq, Sq, D)
  int b, hq, hkv, sq, skv, d;
  int causal;
  int window;                            // <= 0: none
  float softcap;                         // <= 0: none
  float scale;
  int bq;                                // query positions of a CTA (kRows / G)
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

__host__ __device__ inline size_t smem_floats(int d) {
  return size_t(kRows) * (d + 1) + size_t(d) * kBkP + size_t(kBk) * d +
         size_t(kRows) * kBkP;
}

template <int NJ, bool BF16>
__global__ void __launch_bounds__(kThreads) flash_attention_fma_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.d, DP = D + 1;
  float* s_q = smem;                     // kRows x DP: scale * q, f32
  float* s_kt = s_q + kRows * DP;        // D x kBkP: K^T of the tile
  float* s_v = s_kt + D * kBkP;          // kBk x D
  float* s_p = s_v + kBk * D;            // kRows x kBkP: probabilities of the tile

  const int g = p.hq / p.hkv;
  const int bh = blockIdx.y;
  const int b = bh / p.hkv, kvh = bh - b * p.hkv;
  const int q0 = blockIdx.x * p.bq;
  const int q_last = min(q0 + p.bq, p.sq) - 1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  // q tile: row r is head kvh * G + r / BQ at position q0 + r % BQ
  for (int e = tid; e < kRows * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int gi = r / p.bq, qi = q0 + r - gi * p.bq;
    float val = 0.f;
    if (gi < g && qi < p.sq) {
      val = ld<BF16>(p.q, ((size_t(b) * p.hq + kvh * g + gi) * p.sq + qi) * D + c) *
            p.scale;
    }
    s_q[r * DP + c] = val;
  }

  int qpos[4];
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    qpos[i] = q0 + r - (r / p.bq) * p.bq;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles that hold at least one unmasked key of this CTA's rows
  int k_lo = 0, k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const size_t kv_base = (size_t(b) * p.hkv + kvh) * p.skv;

  for (int k0 = (k_lo / kBk) * kBk; k0 < k_hi; k0 += kBk) {
    __syncthreads();                     // the previous tile's reads are done
    for (int e = tid; e < kBk * D; e += kThreads) {
      const int kk = e / D, c = e - kk * D;
      const int key = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (key < p.skv) {
        const size_t off = (kv_base + key) * D + c;
        kv = ld<BF16>(p.k, off);
        vv = ld<BF16>(p.v, off);
      }
      s_kt[c * kBkP + kk] = kv;
      s_v[kk * D + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(ty * 4 + i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = s_kt[c * kBkP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float v = s[i][j];
        if (p.softcap > 0.f) v = p.softcap * tanhf(v / p.softcap);
        bool keep = key < p.skv;
        if (p.causal) keep = keep && qpos[i] >= key;
        if (p.window > 0) keep = keep && qpos[i] - key < p.window;
        s[i][j] = keep ? v : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        sum += pv;
        s_p[(ty * 4 + i) * kBkP + tx + 16 * j] = pv;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();                     // the tile's probabilities are complete

    for (int kk = 0; kk < kBk; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty * 4 + i) * kBkP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        vv[j] = c < D ? s_v[kk * D + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int gi = r / p.bq;
    if (gi >= g || qpos[i] >= p.sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    const size_t row = ((size_t(b) * p.hq + kvh * g + gi) * p.sq + qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) st<BF16>(p.o, row + c, acc[i][j] / li);
    }
  }
}

template <int NJ, bool BF16>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  // raise this instance's dynamic shared memory limit once per device, so later
  // launches (and launches captured in a CUDA graph) make no extra call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && !raised[dev]) {
    err = cudaFuncSetAttribute(flash_attention_fma_kernel<NJ, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  const dim3 grid((p.sq + p.bq - 1) / p.bq, p.b * p.hkv);
  flash_attention_fma_kernel<NJ, BF16><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(const Params& p, size_t smem, cudaStream_t stream) {
  const int nj = (p.d + 15) / 16;        // output columns a thread: tx + 16 j
  if (nj <= 1) return launch<1, BF16>(p, smem, stream);
  if (nj <= 2) return launch<2, BF16>(p, smem, stream);
  if (nj <= 4) return launch<4, BF16>(p, smem, stream);
  if (nj <= 8) return launch<8, BF16>(p, smem, stream);
  return launch<16, BF16>(p, smem, stream);
}

}  // namespace

// q (b, hq, sq, d); k, v (b, hkv, skv, d); o (b, hq, sq, d); all float32 (bf16 = 0) or
// all bfloat16 (bf16 = 1), contiguous.  hq % hkv == 0 with G = hq / hkv <= 64; d a
// multiple of 8 up to 256; window <= 0 and softcap <= 0 mean none.  Returns a
// cudaError_t (0 = launched).
extern "C" int flash_attention_fma(const void* q, const void* k, const void* v,
                                   void* o, int b, int hq, int hkv, int sq, int skv,
                                   int d, int causal, int window, float softcap,
                                   float scale, int bf16, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kRows || sq <= 0 || skv < 0 ||
      d <= 0 || d % 8 != 0 || d > 256)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, softcap, scale,
           kRows / (hq / hkv)};
  const size_t smem = sizeof(float) * smem_floats(d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<true>(p, smem, s) : dispatch<false>(p, smem, s);
}
