// Flash decoding for Hopper (sm_90a): one new token's GQA attention over a KV cache.
//
//   out[b, h] = softmax_{j < lengths[b]}(cap(scale * q[b, h] . k[b, j, h / G])) @ v[b, :, h / G]
//
// with cap(s) = softcap * tanh(s / softcap) when a softcap is given.
//
// Replaces src/repro/kernels/flash_decode/flash_decode.py:flash_decode_pallas (body
// _kernel): the LM decode step's attention, one launch per attention layer per step.
//
// What bounds it on this card.  A decode step reads the valid prefix of the cache once:
// at granite-moe-1b's decode (B 8, 8 kv heads, head_dim 64, bf16) about 64 KB of K and
// V per cached position, 35 MB at 540 positions: about 10 us at 3.35 TB/s.  The
// arithmetic (4 FLOP a cached value) is far below the tensor-core rate: bytes bound it.
//
// What the design does about it.
//   * One CTA per (batch, kv head) holds the G query heads of that kv head, so each
//     K/V tile staged into shared memory serves all of them (the Pallas kernel keeps
//     the G heads in one q block for the same reason).
//   * The CTA walks the cache in tiles of 64 positions up to lengths[b] and reads
//     nothing past it (the Pallas kernel's tile skip); the ragged last tile is masked,
//     so the wrapper pads nothing.  A sequence of length 0 reads nothing and writes
//     zeros (l == 0 -> 1 at the flush, as in the Pallas kernel).
//   * Online softmax: the running max and sum per head and the (G, head_dim) f32
//     accumulator live in shared memory; one warp reduces each head's tile.
//   * Reads of the staged tile are conflict free (K rows padded to head_dim + 1).
//   * float32 math throughout; q and the cache may differ in type (f32 or bf16 each);
//     the output takes q's type.  No split over S: at B 8 the grid is 64 CTAs, fewer
//     than the 132 SMs (simple first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBs = 64;                  // cache positions of a tile (2 a lane)
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

struct Params {
  const void* q;                         // (B, Hq, D)
  const void* k;                         // (B, S, Hkv, D)
  const void* v;
  const int* lengths;                    // (B,)
  void* o;                               // (B, Hq, D)
  int b, hq, hkv, s, d;
  float softcap;                         // <= 0: none
  float scale;
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

__host__ __device__ inline size_t smem_floats(int g, int d) {
  // q, K tile (padded), V tile, scores, accumulator, m, l, alpha
  return size_t(g) * d + size_t(kBs) * (d + 1) + size_t(kBs) * d + size_t(g) * kBs +
         size_t(g) * d + 3 * size_t(g);
}

template <bool QBF16, bool KVBF16>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.d, DP = D + 1;
  const int g = p.hq / p.hkv;
  float* s_q = smem;                     // g x D: scale * q
  float* s_k = s_q + g * D;              // kBs x DP
  float* s_v = s_k + kBs * DP;           // kBs x D
  float* s_s = s_v + kBs * D;            // g x kBs: logits, then probabilities
  float* s_acc = s_s + g * kBs;          // g x D
  float* s_m = s_acc + g * D;            // g
  float* s_l = s_m + g;                  // g
  float* s_alpha = s_l + g;              // g

  const int b = blockIdx.x / p.hkv, kvh = blockIdx.x - b * p.hkv;
  const int len = min(max(p.lengths[b], 0), p.s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < g * D; e += kThreads) {
    const int gi = e / D, c = e - gi * D;
    s_q[e] = ld<QBF16>(p.q, (size_t(b) * p.hq + kvh * g + gi) * D + c) * p.scale;
    s_acc[e] = 0.f;
  }
  for (int e = tid; e < g; e += kThreads) {
    s_m[e] = kNegInf;
    s_l[e] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += kBs) {
    __syncthreads();                     // the previous tile's reads are done
    for (int e = tid; e < kBs * D; e += kThreads) {
      const int kk = e / D, c = e - kk * D;
      const int pos = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (pos < len) {
        const size_t off = ((size_t(b) * p.s + pos) * p.hkv + kvh) * D + c;
        kv = ld<KVBF16>(p.k, off);
        vv = ld<KVBF16>(p.v, off);
      }
      s_k[kk * DP + c] = kv;
      s_v[kk * D + c] = vv;
    }
    __syncthreads();

    for (int e = tid; e < g * kBs; e += kThreads) {
      const int gi = e / kBs, kk = e - gi * kBs;
      const float* qr = s_q + gi * D;
      const float* kr = s_k + kk * DP;
      float dot = 0.f;
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
      if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
      s_s[e] = k0 + kk < len ? dot : kNegInf;
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = s_s + gi * kBs;
      const float a = row[lane], c = row[lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[gi];
      const float m_new = fmaxf(m_old, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[gi] = alpha;
        s_l[gi] = alpha * s_l[gi] + sum;
        s_m[gi] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < g * D; e += kThreads) {
      const int gi = e / D, c = e - gi * D;
      const float* pr = s_s + gi * kBs;
      float a = s_acc[e] * s_alpha[gi];
      for (int kk = 0; kk < kBs; ++kk) a = fmaf(pr[kk], s_v[kk * D + c], a);
      s_acc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * D; e += kThreads) {
    const int gi = e / D, c = e - gi * D;
    const float l = s_l[gi] == 0.f ? 1.f : s_l[gi];
    st<QBF16>(p.o, (size_t(b) * p.hq + kvh * g + gi) * D + c, s_acc[e] / l);
  }
}

template <bool QBF16, bool KVBF16>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && !raised[dev]) {
    err = cudaFuncSetAttribute(flash_decode_kernel<QBF16, KVBF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  flash_decode_kernel<QBF16, KVBF16><<<p.b * p.hkv, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q (b, hq, d); k, v (b, s, hkv, d); lengths (b,) int32; o (b, hq, d) in q's type.
// q_bf16 / kv_bf16 give the types (0 = float32, 1 = bfloat16); all contiguous.
// hq % hkv == 0; softcap <= 0 means none.  Returns a cudaError_t (0 = launched).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int b, int hq, int hkv, int s,
                            int d, float softcap, float scale, int q_bf16, int kv_bf16,
                            void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s < 0 || d <= 0) return cudaErrorInvalidValue;
  Params p{q, k, v, static_cast<const int*>(lengths), o, b, hq, hkv, s, d, softcap, scale};
  const size_t smem = sizeof(float) * smem_floats(hq / hkv, d);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  auto s_ = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_bf16 ? launch<true, true>(p, smem, s_) : launch<true, false>(p, smem, s_);
  }
  return kv_bf16 ? launch<false, true>(p, smem, s_) : launch<false, false>(p, smem, s_);
}
