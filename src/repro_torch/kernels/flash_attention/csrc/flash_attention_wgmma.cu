// Blockwise (flash) attention on Hopper's tensor cores (sm_90a), bf16, forward only.
//
//   out[b, h, i] = softmax_j(mask(cap(scale * q[b, h, i] . k[b, h / G, j]))) @ v[b, h / G]
//
// with cap(s) = softcap * tanh(s / softcap) when a softcap is given, and mask keeping
// j <= i (causal) and i - j < window (sliding window), positions of q and k both
// counted from 0; masked logits are -1e30 (finite), and at the flush l == 0 -> 1.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:96 flash_attention_pallas
// (body _kernel) for bf16 operands with head_dim a multiple of 64 up to 256, G = Hq / Hkv
// a power of two up to 16 and 16-byte aligned operands; `flash_attention.py::variant`
// picks it by type, shape and alignment.  Every other call (float32, other widths)
// keeps the float32-FMA kernel in flash_attention.cu, so float32 stays exact (no TF32).
//
// What bounds it on this card.  At granite-moe-1b's prefill (B 8, 16 query heads over
// 8 kv heads, S 512, head_dim 64) the call reads q, k, v and writes the output once:
// 25.2 MB, 7.5 us at 3.35 TB/s.  The causal products (QK^T and PV over the 131,328
// (i, j) pairs a head keeps) are 4.3 GFLOP, 4.4 us at 989 TFLOP/s.  So bytes bound it,
// with the tensor-core time close behind: the kernel has to run both products on the
// tensor cores, keep S and P out of shared and device memory, and read K/V while the
// products run.
//
// What the design does about it.
//   * One CTA owns 128 query rows of one kv head: all G query heads of that kv head at
//     BQ = 128 / G positions (G = 2 on the LM path: 64 positions of each of the two
//     heads).  Each K/V tile staged into shared memory serves all G heads, as the
//     Pallas kernel's kv BlockSpec ignores the group axis, so K and V cross from L2 into
//     shared memory once per query tile instead of G times.  (The alternative, one CTA
//     per query head with the G heads' CTAs adjacent in the grid, would share K/V only
//     through L2 and would double the TMA traffic into shared memory.)  Q is loaded once
//     by TMA (G boxes of BQ rows per 64-column block).
//   * One producer warp fills a ring of kStages shared-memory stages with
//     `cp.async.bulk.tensor` (K and V tiles of 64 keys x head_dim, 64-column boxes under
//     128-byte swizzle) and counts completion on `full` mbarriers; the consumers free a
//     stage on its `empty` mbarrier once the products that read it are done.  A 3-D
//     tensor map (D, S, B * H) zero-fills keys past Skv and query rows past Sq, so no
//     tile reads a neighbouring head.
//   * Two consumer warpgroups each own 64 rows.  S = Q K^T is
//     `wgmma.mma_async.m64n64k16.f32.bf16.bf16` with Q and K both K-major in shared
//     memory (K lies as (Skv, D): no transpose).  scale (times log2 e) is applied to S
//     in f32 after the product, so q is rounded only once, as stored.
//   * Online softmax in registers on the S fragment, in base 2 (exp2): softcap first,
//     then the mask with the reference's predicates, but only on the tiles at the
//     causal diagonal, the window's edge or the end of the keys; the other tiles run no
//     mask code.  A tile whose rows are all masked gives weights exp(0) that a later
//     alpha = 0 washes out, as in the reference (never -inf, so never NaN).
//   * P is rounded once to bf16 and packed straight from the S accumulator fragment
//     into the register A operand of O += P V (the two layouts coincide for 16-bit
//     types).  V (keys x D, D contiguous) is MN-major, so B goes in transposed
//     (imm-trans-b = 1) with the MN-major 128-byte-swizzle descriptor, as W in
//     grouped_matmul_wgmma.cu.  O stays in f32 registers and is rounded once to bf16
//     at the store; l sums the f32 weights.
//   * kv tiles that the causal mask or the window leave empty for every row of the CTA
//     are never loaded.  The grid is 1-D and the heaviest query tiles (most kv tiles
//     under the causal mask) take the lowest block indices, so they start first and the
//     causal tail is made of light tiles.
//   * head_dim 64 fits two CTAs an SM (64 KB of shared memory, at most 112 registers a
//     thread), so one CTA's softmax overlaps the other's products; wider heads run one.
//   * The tensor maps depend on the pointers, so the host encodes them per call and
//     passes them as __grid_constant__ parameters; cuTensorMapEncodeTiled is looked up
//     through the runtime's entry-point query (no -lcuda), as in grouped_matmul_wgmma.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;                        // query rows of a CTA (G heads x BQ)
constexpr int kBk = 64;                           // keys of a kv tile
constexpr int kConsumers = 2;                     // warpgroups of 64 rows each
constexpr int kConsumerWarps = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kMaxG = 16;                         // BQ = 128 / G stays a multiple of 8
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

template <int D>
struct Shape {
  static constexpr int kBlocks = D / 64;          // 64-column (128-byte) blocks of a row
  static constexpr int kStages = D <= 128 ? 3 : 2;
  static constexpr int kCtasPerSm = D == 64 ? 2 : 1;
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kBk * D * 2;  // K (or V) of one stage
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmemBytes =
      kQBytes + kStages * kStageBytes + 1024 + 8 * (2 * kStages + 1);
};

struct Params {
  __nv_bfloat16* o;                               // (B, Hq, Sq, D)
  int hq, hkv, g, sq, skv;
  int bq;                                         // query positions of a CTA (128 / G)
  int n_bh, n_qt;                                 // B * Hkv, query tiles a head
  int causal;
  int window;                                     // <= 0: none
  float qk_scale;                                 // scale * log2 e (no softcap)
  float cap_in, cap_out;                          // scale / softcap, softcap * log2 e;
                                                  // cap_out 0: no softcap
};

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
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma wait.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, this warpgroup's fragment) += A (64 x 16, K-major, shared memory) x
// B (16 x 64, K-major: N rows of K, shared memory).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16 in registers: this thread's four packed pairs) x
// B (16 x 64, transposed: N contiguous, shared memory).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, Shape<D>::kCtasPerSm)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map, Params p) {
  using S = Shape<D>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzle: every tile starts on a 1024-byte boundary
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + S::kQBytes;          // stage s: K, then V
  const uint32_t bars = kv_s + S::kStages * S::kStageBytes;  // full[s], empty[s], q
  const uint32_t q_bar = bars + 16 * S::kStages;

  // the heaviest query tiles first: block i takes query tile n_qt - 1 - i / n_bh
  const int qt = p.n_qt - 1 - static_cast<int>(blockIdx.x) / p.n_bh;
  const int bh = static_cast<int>(blockIdx.x) % p.n_bh;   // b * Hkv + kv head
  const int b = bh / p.hkv, kvh = bh - b * p.hkv;
  const int q0 = qt * p.bq;
  const int q_last = min(q0 + p.bq, p.sq) - 1;

  // kv tiles that hold at least one unmasked key of this CTA's rows
  int k_lo = 0, k_hi = p.skv;
  if (p.causal) k_hi = min(k_hi, q_last + 1);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / kBk;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBk - 1) / kBk - t_lo : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S::kStages + s), kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {   // producer
    if (lane == 0) {
      // Q: row r of a 64-column block is head r / BQ at position q0 + r % BQ
      mbar_expect_tx(q_bar, S::kQBytes);
      for (int gi = 0; gi < p.g; ++gi)
        for (int c = 0; c < S::kBlocks; ++c)
          tma_load_3d(q_s + c * (kRows * 128) + gi * p.bq * 128, &q_map, q_bar, 64 * c,
                      q0, b * p.hq + kvh * p.g + gi);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % S::kStages;
        const uint32_t full = bars + 8 * s, k_dst = kv_s + s * S::kStageBytes;
        const int k0 = (t_lo + t) * kBk;
        mbar_wait(bars + 8 * (S::kStages + s), ((t / S::kStages) & 1) ^ 1);
        mbar_expect_tx(full, S::kStageBytes);
        for (int c = 0; c < S::kBlocks; ++c) {
          tma_load_3d(k_dst + c * (kBk * 128), &k_map, full, 64 * c, k0, bh);
          tma_load_3d(k_dst + S::kTileBytes + c * (kBk * 128), &v_map, full, 64 * c, k0,
                      bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns CTA rows 64 wg .. 64 wg + 63.  Accumulator fragment:
  // warp w of the warpgroup holds rows 16 w + lane / 4 (element pairs 4 i, 4 i + 1)
  // and that + 8 (pairs 4 i + 2, 4 i + 3), columns 8 i + 2 (lane % 4) (+ 1).
  const int wg = threadIdx.x >> 7;
  const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  int head[2], qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    head[h] = r / p.bq;
    qpos[h] = q0 + r - head[h] * p.bq;
  }
  float o[S::kBlocks][32];
#pragma unroll
  for (int c = 0; c < S::kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};   // l: this thread's columns
  const uint32_t q_wg = q_s + wg * (64 * 128);
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % S::kStages;
    const int k0 = (t_lo + t) * kBk;
    const uint32_t k_src = kv_s + s * S::kStageBytes, v_src = k_src + S::kTileBytes;
    mbar_wait(bars + 8 * s, (t / S::kStages) & 1);

    // S = Q K^T: 16 head_dim columns a product, 32 bytes further along each swizzled
    // 128-byte row, the next 64-column block after four
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wgmma_ss_n64(sc, smem_desc(q_wg + (j >> 2) * (kRows * 128) + 32 * (j & 3), 16, 1024),
                   smem_desc(k_src + (j >> 2) * (kBk * 128) + 32 * (j & 3), 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(sc);

    // logits in base 2: softcap first, then the mask (edge tiles only)
    if (p.cap_out > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = p.cap_out * tanhf(sc[i] * p.cap_in);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= p.qk_scale;
    }
    const bool edge = k0 + kBk > p.skv || (p.causal && k0 + kBk - 1 > q0) ||
                      (p.window > 0 && q0 + p.bq - 1 - k0 >= p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int qp = qpos[(i >> 1) & 1];
        bool keep = key < p.skv;
        if (p.causal) keep = keep && qp >= key;
        if (p.window > 0) keep = keep && qp - key < p.window;
        if (!keep) sc[i] = kMasked;
      }
    }

    // online softmax: row max over the quad of lanes that shares a row
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * i], sc[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
    // P, rounded once to bf16, packed as the A operand of 16 keys a product:
    // keys 16 kc .. + 15 are accumulator pairs 8 kc .. 8 kc + 7
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x0 = exp2f(sc[8 * kc + 2 * e] - m[e & 1]);
        const float x1 = exp2f(sc[8 * kc + 2 * e + 1] - m[e & 1]);
        l[e & 1] += x0 + x1;
        pa[kc][e] = pack_bf16(x0, x1);
      }
#pragma unroll
    for (int c = 0; c < S::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        o[c][4 * i] *= alpha[0];
        o[c][4 * i + 1] *= alpha[0];
        o[c][4 * i + 2] *= alpha[1];
        o[c][4 * i + 3] *= alpha[1];
      }

    // O += P V: V's 16 keys a product are 2 KB further down each 64-column block
    // (MN-major: SBO 1 KB between groups of 8 keys, LBO one block)
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int c = 0; c < S::kBlocks; ++c)
        wgmma_rs_n64(o[c], pa[kc],
                     smem_desc(v_src + c * (kBk * 128) + 2048 * kc, kBk * 128, 1024));
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int c = 0; c < S::kBlocks; ++c) fence_acc(o[c]);
    if (lane == 0) mbar_arrive(bars + 8 * (S::kStages + s));   // the stage is free
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qpos[h] >= p.sq) continue;
    __nv_bfloat16* row =
        p.o + ((size_t(b) * p.hq + kvh * p.g + head[h]) * p.sq + qpos[h]) * D;
#pragma unroll
    for (int c = 0; c < S::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * c + 8 * i + 2 * (lane & 3)) =
            __floats2bfloat162_rn(o[c][4 * i + 2 * h] * inv[h],
                                  o[c][4 * i + 2 * h + 1] * inv[h]);
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

// A 3-D bf16 map over (D, rows, heads) with 128-byte swizzle and zero fill out of
// bounds; boxes of 64 columns x box_rows rows of one head.
bool encode(CUtensorMap* map, const void* ptr, int d, int rows, int heads, int box_rows) {
  const cuuint64_t dims[3] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads)};
  const cuuint64_t strides[2] = {cuuint64_t(d) * 2, cuuint64_t(rows) * d * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, int b, const Params& p,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  // an empty K/V is never read (no kv tile): its maps point at q so that they encode
  const int skv = p.skv > 0 ? p.skv : 1;
  if (!encode(&q_map, q, D, p.sq, b * p.hq, p.bq) ||
      !encode(&k_map, p.skv > 0 ? k : q, D, skv, b * p.hkv, kBk) ||
      !encode(&v_map, p.skv > 0 ? v : q, D, skv, b * p.hkv, kBk))
    return -2;
  // above 48 KB of dynamic shared memory: raise this instance's limit once per
  // device, so later launches (and launches captured in a CUDA graph) make no call
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Shape<D>::kSmemBytes);
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  flash_attention_wgmma_kernel<D><<<p.n_qt * p.n_bh, kThreads, Shape<D>::kSmemBytes,
                                    stream>>>(q_map, k_map, v_map, p);
  return cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d); k, v (b, hkv, skv, d); o (b, hq, sq, d); all bfloat16, contiguous,
// 16-byte aligned.  d is 64, 128, 192 or 256; G = hq / hkv a power of two up to 16;
// window <= 0 and softcap <= 0 mean none.  Returns a cudaError_t (0 = launched); -1
// when libcuda has no cuTensorMapEncodeTiled, -2 when it refuses a tensor map.
extern "C" int flash_attention_wgmma(const void* q, const void* k, const void* v, void* o,
                                     int b, int hq, int hkv, int sq, int skv, int d,
                                     int causal, int window, float softcap, float scale,
                                     void* stream) {
  const int g = hkv > 0 ? hq / hkv : 0;
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || g < 1 || g > kMaxG || (g & (g - 1)) != 0 ||
      sq <= 0 || skv < 0 || (d != 64 && d != 128 && d != 192 && d != 256) ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15) != 0)
    return cudaErrorInvalidValue;
  const int bq = kRows / g;
  const long long ctas = (long long)((sq + bq - 1) / bq) * b * hkv;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return -1;
  Params p{static_cast<__nv_bfloat16*>(o), hq, hkv, g, sq, skv, bq, b * hkv,
           (sq + bq - 1) / bq, causal, window, scale * kLog2e,
           softcap > 0.f ? scale / softcap : 0.f, softcap > 0.f ? softcap * kLog2e : 0.f};
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, b, p, s);
    case 128: return launch<128>(q, k, v, b, p, s);
    case 192: return launch<192>(q, k, v, b, p, s);
    default: return launch<256>(q, k, v, b, p, s);
  }
}
