// Temporal layer fusion on Hopper's tensor cores (sm_90a): a chain of dense layers per
// row tile, float32 in split-float TF32.
//
//   h_0 = x;  h_{i+1} = act_i(h_i @ W_i + b_i);  out = h_L   (act = ReLU, none on the
//   last layer unless final_act)
//
// Replaces src/repro/kernels/fused_mlp/fused_mlp.py:fused_mlp_pallas (body _kernel), as
// csrc/fused_mlp.cu does; that FMA kernel keeps the operands this one does not take
// (not 16-byte aligned).  One launch per fusion group of the paper's planner (PointAcc
// section 4.2.4); only the group's last activation is written to device memory.  Three
// routes (fused_mlp.py `plan_mlp` picks one from shapes, type, alignment and the SM
// count):
//
//   tc         fused_mlp_tc_kernel<R, false, BF16>: the group's weights and biases
//              resident in shared memory, a persistent grid walking row tiles of R
//              rows.  Every PointNet++(s) group takes it.
//   tc_stream  fused_mlp_tc_kernel<R, true, BF16>: weights over the budget
//              (PointNet's 128->1024) stream through a ring of cp.async stages.
//   few_rows   fused_mlp_few_rows_kernel<BF16>: one layer, at most 16 rows (PointNet's
//              head at 8 rows): 32-column tiles, K split over a cluster of up to 8 CTAs.
//
// What bounds it on this card.  The PointNet++(s) groups are narrow (3..192 channels)
// and long (4096..131072 rows): the x read and the output write (34 MB for sa1) bound
// them by bytes at 3.35 TB/s once the products run on the tensor cores; with float32
// FMAs at 67 TFLOP/s they were bound by operations.  PointNet's head at 8 rows reads a
// 2 MB weight for 16 KB of output: bytes, and only if many SMs read it.
//
// What the design does about it.
//   * Tensor cores at float32 accuracy: an operand x is split into hi = tf32_rna(x) and
//     lo = tf32_rna(x - hi), and a product takes lo*hi + hi*lo + hi*hi with
//     mma.sync.m16n8k8 TF32 (HMMA), as csrc/spconv_tc.cu does.  The tensor cores'
//     float32 accumulation does not round to nearest, so each K chunk of 32 gathers its
//     products in a fresh fragment that joins the accumulator by a float32 add.  bf16
//     x and W are exact in TF32: layer 0 takes one product, later layers (h in float32)
//     two, a_lo*W + a_hi*W.
//   * Resident weights (tc).  Each CTA copies every layer's W and b into shared memory
//     once (cp.async; bf16 converted by plain loads), in mma fragment order: for k8
//     block kb, n8 tile nb and lane (g, t) the pair W[8kb + t][8nb + g],
//     W[8kb + t + 4][8nb + g], zero past K and N: a B fragment is one 8-byte load,
//     split in registers (float32) or used as is (bf16).  Splitting W once into
//     (hi, hi, lo, lo) in shared memory was as fast or slower at every PointNet++(s)
//     group and needs twice the memory (scripts/fused_mlp_ablation.py, w_smem).  Then
//     the CTA
//     walks row tiles blockIdx.x, blockIdx.x + gridDim.x, ...: the next tile's x comes
//     in with cp.async into the second x buffer while this one computes.
//   * x tile staging.  A tile of x is one contiguous span of R x C0 elements, copied
//     with 16-byte cp.async into one of two buffers (rows past n_rows as zeros) while
//     the tile before computes: row by row into a padded stride (round8(C0) + 4
//     floats, C0 + 8 bf16: layer 0's A reads hit 32 banks) where C0 fills whole
//     16-byte vectors, else (C0 = 3, 67) flat with stride C0.  Layer 0 reads it,
//     columns past C0 masked to zero, and splits at read.
//   * Activations stay in shared memory: each layer reads one buffer and writes the
//     other (ping-pong), as (hi, lo) pairs split once when written, with columns c
//     and c + 4 of each k8 block side by side: a thread's A fragment for a k8 step is
//     one 16-byte load a row and no conversion (rows of round16(C) + 8 pairs, so a
//     quarter warp's loads hit distinct banks).  Padded columns hold real zeros (zero
//     W columns and bias).  The last layer writes from registers:
//     two columns a store (8 bytes float32, 4 bf16) where C_L is even, masked rows.
//     The rounding is two integer operations, the same bits as cvt.rna.tf32.f32.
//   * Warps: R = 64 is 2 row slices of 32 rows (two m16 blocks) x 4 column groups, R =
//     32 and 16 one slice x 8 groups; a column pass is 128 columns (16 n8 tiles), tile
//     nb of a pass to group nb % groups.  The warp's tile count is a template
//     argument (no branch in the k8 loop), and one m16 block's A fragments are live at
//     a time, its products issued product by product over the tiles: a first build
//     that kept both blocks' A and predicated each tile spent most of its issue slots
//     copying A into the HMMA's register quad and branching (its SASS), and ran no
//     faster without its HMMAs (scripts/fused_mlp_ablation.py, no_mma).
//   * Streamed weights (tc_stream): the step sequence (layer, 128-column pass, 32-row K
//     chunk) runs through a ring of kStages cp.async stages of W (row major, stride
//     136, split in registers), prefetched across pass and layer boundaries; the x tile
//     is staged once, activations ping-pong as above.  A single-layer group whose row
//     tiles do not fill the card splits its passes over blockIdx.y.
//   * Few rows: a CTA owns 32 output columns and K / cs rows of W; its 256 threads read
//     W with 16-byte loads (8 bf16), 32 rows in flight, and take float32 FMAs on x's
//     slice in shared memory.  Partial sums meet by warp shuffles, then over the warps,
//     then over the cluster's ranks through distributed shared memory, always in the
//     same order (deterministic); bias and ReLU are applied once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;             // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 16;
constexpr int kChunk = 32;                // K of a fresh fragment, and of a ring stage
constexpr int kPassTiles = 16;            // n8 tiles of a column pass (128 columns)
constexpr int kRingStride = 8 * kPassTiles + 8;  // elements of a ring stage's row
constexpr int kStages = 3;                // ring stages (tc_stream)
constexpr int kFewCols = 32;              // few_rows: output columns a CTA
constexpr int kFewRows = 16;              // few_rows: most rows
constexpr int kMaxSplit = 8;              // the portable cluster size
constexpr size_t kMaxSmem = 232448;       // H100: shared memory a block can use
constexpr size_t kDefaultSmem = 48 * 1024;  // usable without the attribute
constexpr int kMaxDevices = 64;

struct Chain {
  const void* x;                          // (n_rows, widths[0])
  void* out;                              // (n_rows, widths[n_layers])
  const void* w[kMaxLayers];              // W_l (widths[l], widths[l + 1]), row major
  const void* b[kMaxLayers];              // b_l (widths[l + 1],)
  int widths[kMaxLayers + 1];
  int n_layers, n_rows, final_act;
  int tiles;                              // row tiles of R rows
  int col_splits;                         // tc_stream, one layer: CTAs sharing its passes
  // shared memory layout in 4-byte words (layout())
  int off_w[kMaxLayers], off_b[kMaxLayers];  // resident W (fragment order) and b
  int off_x, x_words;                     // staged x tiles (2 resident, 1 streamed)
  int xs_stride;                          // elements a staged x row (C0: flat)
  int off_act[2], act_stride[2];          // ping-pong activation buffers (pairs a row)
  int off_ring;                           // tc_stream: the W ring
};

struct Few {
  const void* x;                          // (n_rows, k)
  void* out;                              // (n_rows, n)
  const void* w;                          // (k, n)
  const void* b;                          // (n,)
  int n_rows, k, n, cs, ks, relu;         // cs CTAs a cluster, ks rows of W each
};

__host__ __device__ constexpr int round8(int v) { return (v + 7) & ~7; }
__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// float32 -> the nearest TF32 value, ties away from zero, as cvt.rna.tf32.f32 rounds a
// finite value, in two integer operations (ref.py's tf32_rna is the same rule).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x -> (hi, lo), both TF32 bit patterns, hi + lo = x to about 22 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past src_bytes (0..16) are written as zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool BF16>
__device__ __forceinline__ float gload(const void* p, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else {
    return __ldg(static_cast<const float*>(p) + i);
  }
}

// Four consecutive elements from device memory (i a multiple of 4): one 16-byte load of
// float32, one 8-byte load of bf16.
template <bool BF16>
__device__ __forceinline__ float4 gload4(const void* p, size_t i) {
  if constexpr (BF16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + i));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  } else {
    return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p) + i));
  }
}

// The warps of a CTA of R rows: kRS row slices of kMB m16 blocks x kCG column groups;
// a warp owns kNB n8 tiles of each 128-column pass (tiles cg, cg + kCG, ...).
template <int R>
struct Geo {
  static constexpr int kMB = R >= 32 ? 2 : 1;
  static constexpr int kRS = R / (16 * kMB);
  static constexpr int kCG = kWarps / kRS;
  static constexpr int kNB = kPassTiles / kCG;
  static_assert(kRS * kCG == kWarps && kNB * kCG == kPassTiles, "warp grid");
};

// Where column c of an activation row lies among its (hi, lo) pairs: columns c and
// c + 4 of each k8 block side by side, so one 16-byte load gives a thread both
// columns of its A fragment in that row.
__host__ __device__ constexpr int perm(int c) {
  return (c & ~7) + 2 * (c & 3) + ((c >> 2) & 1);
}

// A layer's input in an activation buffer of (hi, lo) pairs, split once by whoever
// wrote it; `stride` pairs a row.  get2(r, kt) gives columns kt and kt + 4 of row r
// (kt = 8 kb + t, t < 4).
struct APair {
  const float2* p;
  int stride;
  __device__ __forceinline__ void get2(int r, int kt, uint32_t& h0, uint32_t& l0,
                                       uint32_t& h1, uint32_t& l1) const {
    const float4 q = *reinterpret_cast<const float4*>(p + r * stride + (kt & ~7) +
                                                      2 * (kt & 7));
    h0 = __float_as_uint(q.x);
    l0 = __float_as_uint(q.y);
    h1 = __float_as_uint(q.z);
    l1 = __float_as_uint(q.w);
  }
};

// Layer 0's input, the staged x tile (stride xs_stride), split at read (bf16: exact
// in TF32, lo = 0); columns >= kvalid read as 0.
template <bool BF16>
struct AStaged {
  const void* p;
  int stride, kvalid;
  __device__ __forceinline__ void get(int r, int k, uint32_t& hi, uint32_t& lo) const {
    float v;
    if constexpr (BF16) {
      v = __bfloat162float(static_cast<const __nv_bfloat16*>(p)[r * stride + k]);
    } else {
      v = static_cast<const float*>(p)[r * stride + k];
    }
    v = k < kvalid ? v : 0.f;
    if constexpr (BF16) {
      hi = __float_as_uint(v);
      lo = 0u;
    } else {
      split(v, hi, lo);
    }
  }
  __device__ __forceinline__ void get2(int r, int kt, uint32_t& h0, uint32_t& l0,
                                       uint32_t& h1, uint32_t& l1) const {
    get(r, kt, h0, l0);
    get(r, kt + 4, h1, l1);
  }
};

// B fragments of a resident layer (fragment order, see the top of the file).
template <bool BF16>
struct BFrag {
  const float* w;
  int nt;                                 // n8 tiles of the layer
  __device__ __forceinline__ void get(int kb, int nb, int lane, uint32_t (&hi)[2],
                                      uint32_t (&lo)[2]) const {
    const int f = (kb * nt + nb) * 32 + lane;
    const float2 q = reinterpret_cast<const float2*>(w)[f];
    if constexpr (BF16) {
      hi[0] = __float_as_uint(q.x);
      hi[1] = __float_as_uint(q.y);
      lo[0] = lo[1] = 0u;
    } else {
      split(q.x, hi[0], lo[0]);
      split(q.y, hi[1], lo[1]);
    }
  }
};

// B fragments of one ring stage: kChunk rows of W (from k8 block kb0) x the 128
// columns of a pass (from n8 tile nb0), row major with stride kRingStride.
template <bool BF16>
struct BRing {
  const void* s;
  int kb0, nb0;
  __device__ __forceinline__ void get(int kb, int nb, int lane, uint32_t (&hi)[2],
                                      uint32_t (&lo)[2]) const {
    const int r = (kb - kb0) * 8 + (lane & 3), c = (nb - nb0) * 8 + (lane >> 2);
    float v0, v1;
    if constexpr (BF16) {
      const __nv_bfloat16* e = static_cast<const __nv_bfloat16*>(s);
      v0 = __bfloat162float(e[r * kRingStride + c]);
      v1 = __bfloat162float(e[(r + 4) * kRingStride + c]);
      hi[0] = __float_as_uint(v0);
      hi[1] = __float_as_uint(v1);
      lo[0] = lo[1] = 0u;
    } else {
      const float* e = static_cast<const float*>(s);
      v0 = e[r * kRingStride + c];
      v1 = e[(r + 4) * kRingStride + c];
      split(v0, hi[0], lo[0]);
      split(v1, hi[1], lo[1]);
    }
  }
};

// part += A[the warp's rows][k8 blocks kb0 .. kb1) @ W[..][the warp's NV tiles of the
// pass: nbase, nbase + kCG, ...].  NPROD: 3 (float32: lo*hi + hi*lo + hi*hi), 2 (bf16
// W, float32 A: a_lo*b + a_hi*b) or 1 (both exact in TF32).  The B fragments of a k8
// step are loaded first; then one m16 block's A at a time, its products issued
// product by product over the tiles.
template <int R, int NPROD, int NV, class A, class B>
__device__ __forceinline__ void mma_chunk(float (&part)[Geo<R>::kMB][Geo<R>::kNB][4],
                                          const A& a, int arow, const B& b, int kb0,
                                          int kb1, int nbase, int lane) {
  using G = Geo<R>;
  const int g = lane >> 2, t = lane & 3;
  auto step = [&](int kb) {
    uint32_t bhi[NV][2], blo[NV][2];
#pragma unroll
    for (int j = 0; j < NV; ++j) b.get(kb, nbase + j * G::kCG, lane, bhi[j], blo[j]);
#pragma unroll
    for (int mb = 0; mb < G::kMB; ++mb) {
      const int r = arow + mb * 16 + g;
      uint32_t ahi[4], alo[4];
      a.get2(r, kb * 8 + t, ahi[0], alo[0], ahi[2], alo[2]);
      a.get2(r + 8, kb * 8 + t, ahi[1], alo[1], ahi[3], alo[3]);
      if constexpr (NPROD >= 2) {
#pragma unroll
        for (int j = 0; j < NV; ++j) mma_tf32(part[mb][j], alo, bhi[j][0], bhi[j][1]);
      }
      if constexpr (NPROD == 3) {
#pragma unroll
        for (int j = 0; j < NV; ++j) mma_tf32(part[mb][j], ahi, blo[j][0], blo[j][1]);
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) mma_tf32(part[mb][j], ahi, bhi[j][0], bhi[j][1]);
    }
  };
  if (kb1 - kb0 == kChunk / 8) {
#pragma unroll
    for (int i = 0; i < kChunk / 8; ++i) step(kb0 + i);
  } else {
    for (int kb = kb0; kb < kb1; ++kb) step(kb);
  }
}

// mma_chunk for the warp's nv (1..kNB) tiles of the pass: the count a compile-time
// constant, so that the k8 loop holds no branch.
template <int R, int NPROD, class A, class B>
__device__ __forceinline__ void mma_tiles(int nv, float (&part)[Geo<R>::kMB][Geo<R>::kNB][4],
                                          const A& a, int arow, const B& b, int kb0,
                                          int kb1, int nbase, int lane) {
  constexpr int kNB = Geo<R>::kNB;
  if (nv <= 1) {
    mma_chunk<R, NPROD, 1>(part, a, arow, b, kb0, kb1, nbase, lane);
  } else if constexpr (kNB == 2) {
    mma_chunk<R, NPROD, 2>(part, a, arow, b, kb0, kb1, nbase, lane);
  } else if (nv == 2) {
    mma_chunk<R, NPROD, 2>(part, a, arow, b, kb0, kb1, nbase, lane);
  } else if (nv == 3) {
    mma_chunk<R, NPROD, 3 <= kNB ? 3 : kNB>(part, a, arow, b, kb0, kb1, nbase, lane);
  } else {
    mma_chunk<R, NPROD, kNB>(part, a, arow, b, kb0, kb1, nbase, lane);
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&f)[Geo<R>::kMB][Geo<R>::kNB][4]) {
#pragma unroll
  for (int mb = 0; mb < Geo<R>::kMB; ++mb)
#pragma unroll
    for (int j = 0; j < Geo<R>::kNB; ++j) f[mb][j][0] = f[mb][j][1] = f[mb][j][2] = f[mb][j][3] = 0.f;
}

template <int R>
__device__ __forceinline__ void add(float (&acc)[Geo<R>::kMB][Geo<R>::kNB][4],
                                    const float (&part)[Geo<R>::kMB][Geo<R>::kNB][4]) {
#pragma unroll
  for (int mb = 0; mb < Geo<R>::kMB; ++mb)
#pragma unroll
    for (int j = 0; j < Geo<R>::kNB; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mb][j][q] += part[mb][j][q];
}

template <bool BF16>
__device__ __forceinline__ void store2(void* out, size_t i, float v0, float v1, bool pair,
                                       bool second) {
  if constexpr (BF16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + i;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
    } else {
      o[0] = __float2bfloat16(v0);
      if (second) o[1] = __float2bfloat16(v1);
    }
  } else {
    float* o = static_cast<float*>(out) + i;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (second) o[1] = v1;
    }
  }
}

// acc + bias (+ReLU) of the warp's tiles -> the next activation buffer as (hi, lo)
// pairs (o != null, padded columns included) or -> out (rows < rows, columns < n).
// bias(c) gives the bias of column c (0 past n).
template <int R, bool BF16, class Bias>
__device__ __forceinline__ void flush(const float (&acc)[Geo<R>::kMB][Geo<R>::kNB][4],
                                      const Bias& bias, int n, bool relu, float2* o,
                                      int ostride, void* out, int row0, int rows, int arow,
                                      int nbase, int nt, int lane) {
  using G = Geo<R>;
  const int g = lane >> 2, t = lane & 3;
  const bool even = (n & 1) == 0;
#pragma unroll
  for (int j = 0; j < G::kNB; ++j) {
    const int nb = nbase + j * G::kCG;
    if (nb >= nt) continue;
    const int c = nb * 8 + 2 * t;
    const float b0 = bias(c), b1 = bias(c + 1);
#pragma unroll
    for (int mb = 0; mb < G::kMB; ++mb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = arow + mb * 16 + g + 8 * h;
        float v0 = acc[mb][j][2 * h] + b0, v1 = acc[mb][j][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        if (o != nullptr) {
          uint32_t h0, l0, h1, l1;
          split(v0, h0, l0);
          split(v1, h1, l1);
          o[r * ostride + perm(c)] = make_float2(__uint_as_float(h0), __uint_as_float(l0));
          o[r * ostride + perm(c + 1)] = make_float2(__uint_as_float(h1), __uint_as_float(l1));
        } else if (r < rows && c < n) {
          store2<BF16>(out, size_t(row0 + r) * n + c, v0, v1, even, c + 1 < n);
        }
      }
    }
  }
}

struct BiasSmem {
  const float* b;
  __device__ __forceinline__ float operator()(int c) const { return b[c]; }
};

template <bool BF16>
struct BiasGlobal {
  const void* b;
  int n;
  __device__ __forceinline__ float operator()(int c) const {
    return c < n ? gload<BF16>(b, c) : 0.f;
  }
};

// The x rows row0 .. row0 + R - 1 -> an x buffer with 16-byte cp.async (zeros past
// n_rows): row by row into the padded stride where C0 fills whole 16-byte vectors,
// else the span of R x C0 elements (a multiple of 8) flat.
template <int R, bool BF16>
__device__ __forceinline__ void load_x(const Chain& ch, void* xs, int row0) {
  constexpr int E = BF16 ? 8 : 4;         // elements a 16-byte vector
  constexpr int kEsz = BF16 ? 2 : 4;
  const int c0 = ch.widths[0];
  const char* xg = static_cast<const char*>(ch.x);
  char* dst = static_cast<char*>(xs);
  if (ch.xs_stride != c0) {
    const int vpr = c0 / E;
    for (int e = threadIdx.x; e < R * vpr; e += kThreads) {
      const int r = e / vpr, v = e - r * vpr;
      const bool ok = row0 + r < ch.n_rows;
      cp_async16(dst + size_t(r * ch.xs_stride + v * E) * kEsz,
                 ok ? xg + (size_t(row0 + r) * c0 + v * E) * kEsz : xg, ok ? 16 : 0);
    }
  } else {
    const long valid = long(min(R, ch.n_rows - row0)) * c0;
    for (int v = threadIdx.x; v < R * c0 / E; v += kThreads) {
      const long rem = valid - long(v) * E;
      const int bytes = rem <= 0 ? 0 : rem >= E ? 16 : int(rem) * kEsz;
      cp_async16(dst + size_t(v) * 16,
                 bytes > 0 ? xg + (size_t(row0) * c0 + size_t(v) * E) * kEsz : xg, bytes);
    }
  }
}

// One layer of a row tile, resident route: every 128-column pass, K in chunks of 32.
template <int R, int NPROD, bool BF16, class A>
__device__ __forceinline__ void resident_layer(const A& a, const BFrag<BF16>& bw,
                                               const float* bias, int k, int n, bool relu,
                                               float2* o, int ostride, void* out, int row0,
                                               int rows, int arow, int cgi, int lane) {
  using G = Geo<R>;
  const int kt = round8(k) / 8, nt = round8(n) / 8;
  for (int p = 0; p < nt; p += kPassTiles) {
    const int nbase = p + cgi;
    if (nbase >= nt) continue;            // none of the pass's tiles is this warp's
    const int nv = min(G::kNB, (nt - nbase + G::kCG - 1) / G::kCG);
    float acc[G::kMB][G::kNB][4];
    zero<R>(acc);
    for (int kb = 0; kb < kt; kb += kChunk / 8) {
      float part[G::kMB][G::kNB][4];
      zero<R>(part);
      mma_tiles<R, NPROD>(nv, part, a, arow, bw, kb, min(kt, kb + kChunk / 8), nbase, lane);
      add<R>(acc, part);
    }
    flush<R, BF16>(acc, BiasSmem{bias}, n, relu, o, ostride, out, row0, rows, arow, nbase,
                   nt, lane);
  }
}

template <int R, bool BF16>
__device__ __forceinline__ void resident(const Chain& ch, float* sm) {
  using G = Geo<R>;
  constexpr int Q = 2;                    // words a fragment pair
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int arow = (warp / G::kCG) * G::kMB * 16, cgi = warp % G::kCG;
  auto xbuf = [&](int i) { return static_cast<void*>(sm + ch.off_x + i * ch.x_words); };

  // 1. every layer's W (fragment order) and b, then the first x tile
  for (int l = 0; l < ch.n_layers; ++l) {
    const int k = ch.widths[l], n = ch.widths[l + 1];
    const int nt = round8(n) / 8, pairs = round8(k) / 8 * nt * 32;
    float* wl = sm + ch.off_w[l];
    float* bl = sm + ch.off_b[l];
    for (int f = tid; f < pairs; f += kThreads) {
      const int ln = f & 31, nb = (f >> 5) % nt, kb = (f >> 5) / nt;
      const int c = nb * 8 + (ln >> 2), k0 = kb * 8 + (ln & 3), k1 = k0 + 4;
      if constexpr (BF16) {
        wl[Q * f] = k0 < k && c < n ? gload<true>(ch.w[l], size_t(k0) * n + c) : 0.f;
        wl[Q * f + 1] = k1 < k && c < n ? gload<true>(ch.w[l], size_t(k1) * n + c) : 0.f;
      } else {
        const float* w = static_cast<const float*>(ch.w[l]);
        const bool ok0 = k0 < k && c < n, ok1 = k1 < k && c < n;
        cp_async4(wl + Q * f, ok0 ? w + size_t(k0) * n + c : w, ok0 ? 4 : 0);
        cp_async4(wl + Q * f + 1, ok1 ? w + size_t(k1) * n + c : w, ok1 ? 4 : 0);
      }
    }
    for (int c = tid; c < nt * 8; c += kThreads) {
      if constexpr (BF16) {
        bl[c] = c < n ? gload<true>(ch.b[l], c) : 0.f;
      } else {
        const float* b = static_cast<const float*>(ch.b[l]);
        cp_async4(bl + c, c < n ? b + c : b, c < n ? 4 : 0);
      }
    }
  }
  if (int(blockIdx.x) < ch.tiles) load_x<R, BF16>(ch, xbuf(0), blockIdx.x * R);
  cp_async_commit();
  // 2. row tiles blockIdx.x, blockIdx.x + gridDim.x, ...; x of the next in flight
  int it = 0;
  for (int tile = blockIdx.x; tile < ch.tiles; tile += gridDim.x, ++it) {
    cp_async_wait<0>();
    __syncthreads();                      // this tile's x is in; the last tile is done
    if (tile + int(gridDim.x) < ch.tiles)
      load_x<R, BF16>(ch, xbuf((it + 1) & 1), (tile + gridDim.x) * R);
    cp_async_commit();
    const int row0 = tile * R, rows = min(R, ch.n_rows - row0);
    for (int l = 0; l < ch.n_layers; ++l) {
      if (l > 0) __syncthreads();         // layer l - 1's output is complete
      const int k = ch.widths[l], n = ch.widths[l + 1];
      const bool last = l == ch.n_layers - 1;
      const bool relu = !last || ch.final_act;
      const BFrag<BF16> bw{sm + ch.off_w[l], round8(n) / 8};
      float2* o = last ? nullptr : reinterpret_cast<float2*>(sm + ch.off_act[l & 1]);
      const int ostride = last ? 0 : ch.act_stride[l & 1];
      const float* bias = sm + ch.off_b[l];
      if (l == 0) {                       // x split at read; bf16: exact in TF32
        const AStaged<BF16> a{xbuf(it & 1), ch.xs_stride, k};
        resident_layer<R, BF16 ? 1 : 3>(a, bw, bias, k, n, relu, o, ostride, ch.out, row0,
                                         rows, arow, cgi, lane);
      } else {
        const APair a{reinterpret_cast<const float2*>(sm + ch.off_act[(l + 1) & 1]),
                      ch.act_stride[(l + 1) & 1]};
        resident_layer<R, BF16 ? 2 : 3>(a, bw, bias, k, n, relu, o, ostride, ch.out, row0,
                                         rows, arow, cgi, lane);
      }
    }
  }
  cp_async_wait<0>();
}

// The streamed route's position: layer l, pass q (128 columns), K chunk c.
struct Cursor {
  int l, q, c;
};

template <int R, bool BF16>
__device__ __forceinline__ void streamed(const Chain& ch, float* sm) {
  using G = Geo<R>;
  constexpr int kStageWords = kChunk * kRingStride * (BF16 ? 2 : 4) / 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int arow = (warp / G::kCG) * G::kMB * 16, cgi = warp % G::kCG;
  const int last_l = ch.n_layers - 1;
  const int row0 = blockIdx.x * R, rows = min(R, ch.n_rows - row0);
  void* xs = sm + ch.off_x;
  float* ring = sm + ch.off_ring;
  auto n_pass = [&](int l) { return (round8(ch.widths[l + 1]) / 8 + kPassTiles - 1) / kPassTiles; };
  auto first_pass = [&](int l) { return l == last_l ? int(blockIdx.y) : 0; };
  auto pass_step = [&](int l) { return l == last_l ? ch.col_splits : 1; };
  auto chunks = [&](int l) { return (ch.widths[l] + kChunk - 1) / kChunk; };
  auto advance = [&](Cursor& u) {
    if (++u.c < chunks(u.l)) return;
    u.c = 0;
    u.q += pass_step(u.l);
    if (u.q < n_pass(u.l)) return;
    ++u.l;
    u.q = u.l <= last_l ? first_pass(u.l) : 0;
  };
  int total = 0;
  for (int l = 0; l <= last_l; ++l) {
    const int mine = first_pass(l) < n_pass(l)
                         ? (n_pass(l) - first_pass(l) + pass_step(l) - 1) / pass_step(l) : 0;
    total += mine * chunks(l);
  }

  // W rows k0 .. k0 + 31 (zeros past K, and up to the next multiple of 8) x the
  // pass's 128 columns (zeros past N) -> ring stage s
  auto load = [&](const Cursor& u, int s) {
    const int k = ch.widths[u.l], n = ch.widths[u.l + 1];
    const int k0 = u.c * kChunk, n0 = u.q * kPassTiles * 8;
    const int kr = min(kChunk, k - k0), kr8 = round8(kr);
    char* dst = reinterpret_cast<char*>(ring + s * kStageWords);
    constexpr int kEsz = BF16 ? 2 : 4;
    const char* w = static_cast<const char*>(ch.w[u.l]);
    const int vec = BF16 ? (n % 8 == 0 ? 8 : 2) : (n % 4 == 0 ? 4 : 1);  // elements a copy
    const int per_row = kPassTiles * 8 / vec;
    for (int e = tid; e < kr8 * per_row; e += kThreads) {
      const int r = e / per_row, c = (e - r * per_row) * vec;
      const bool ok = r < kr && n0 + c < n;
      const char* src = ok ? w + (size_t(k0 + r) * n + n0 + c) * kEsz : w;
      void* d = dst + size_t(r * kRingStride + c) * kEsz;
      if (vec * kEsz == 16) {
        cp_async16(d, src, ok ? 16 : 0);
      } else {
        cp_async4(d, src, ok ? 4 : 0);
      }
    }
  };

  load_x<R, BF16>(ch, xs, row0);          // joins the first ring group
  Cursor ld{0, first_pass(0), 0}, cu = ld;
  int issued = 0;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (issued < total) {
      load(ld, issued % kStages);
      advance(ld);
      ++issued;
    }
    cp_async_commit();
  }
  float acc[G::kMB][G::kNB][4];
  zero<R>(acc);
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // stage s is in; stage s - 1 is consumed
    if (issued < total) {
      load(ld, issued % kStages);
      advance(ld);
      ++issued;
    }
    cp_async_commit();
    const int k = ch.widths[cu.l], n = ch.widths[cu.l + 1];
    const int kt = round8(k) / 8, nt = round8(n) / 8;
    const int nbase = cu.q * kPassTiles + cgi;
    const int kb0 = cu.c * (kChunk / 8), kb1 = min(kt, kb0 + kChunk / 8);
    if (cu.c == 0) zero<R>(acc);
    if (nbase < nt) {
      const BRing<BF16> bw{ring + (s % kStages) * kStageWords, kb0, cu.q * kPassTiles};
      float part[G::kMB][G::kNB][4];
      zero<R>(part);
      const int nv = min(G::kNB, (nt - nbase + G::kCG - 1) / G::kCG);
      if (cu.l == 0) {
        const AStaged<BF16> a{xs, ch.xs_stride, k};
        mma_tiles<R, BF16 ? 1 : 3>(nv, part, a, arow, bw, kb0, kb1, nbase, lane);
      } else {
        const APair a{reinterpret_cast<const float2*>(sm + ch.off_act[(cu.l - 1) & 1]),
                      ch.act_stride[(cu.l - 1) & 1]};
        mma_tiles<R, BF16 ? 2 : 3>(nv, part, a, arow, bw, kb0, kb1, nbase, lane);
      }
      add<R>(acc, part);
      if (cu.c == chunks(cu.l) - 1) {
        const bool last = cu.l == last_l;
        flush<R, BF16>(acc, BiasGlobal<BF16>{ch.b[cu.l], n}, n, !last || ch.final_act,
                       last ? nullptr : reinterpret_cast<float2*>(sm + ch.off_act[cu.l & 1]),
                       last ? 0 : ch.act_stride[cu.l & 1], ch.out, row0, rows, arow, nbase,
                       nt, lane);
      }
    }
    advance(cu);
  }
  cp_async_wait<0>();
}

template <int R, bool STREAM, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
    fused_mlp_tc_kernel(const __grid_constant__ Chain ch) {
  extern __shared__ __align__(16) float smem[];
  if constexpr (STREAM) {
    streamed<R, BF16>(ch, smem);
  } else {
    resident<R, BF16>(ch, smem);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_few_rows_kernel(const __grid_constant__ Few p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                   // kFewRows x ks: x's K slice
  float* red = xs + round4(kFewRows * p.ks);          // kWarps x kFewRows x kFewCols
  float* part = red + kWarps * kFewRows * kFewCols;   // kFewRows x kFewCols: this rank's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.y;                        // = the rank in the (1, cs, 1) cluster
  const int n0 = blockIdx.x * kFewCols;
  const int k_lo = min(p.k, rank * p.ks), k_hi = min(p.k, k_lo + p.ks);
  const int nk = k_hi - k_lo;
  for (int e = tid; e < p.n_rows * nk; e += kThreads) {
    const int r = e / nk, kk = e - r * nk;
    xs[r * p.ks + kk] = gload<BF16>(p.x, size_t(r) * p.k + k_lo + kk);
  }
  __syncthreads();

  // thread: 4 columns (cv) of the tile, rows k_lo + kl, k_lo + kl + 32, ... of W
  constexpr int kUnroll = 4;              // rows of W in flight a thread
  const int cv = tid & 7, kl = tid >> 3;
  const int col = n0 + 4 * cv;
  float acc[kFewRows][4];
#pragma unroll
  for (int r = 0; r < kFewRows; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  if (col < p.n) {                        // n % 4 == 0: whole 4-column vectors
    for (int k = kl; k < nk; k += 32 * kUnroll) {
      float4 wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + 32 * u;
        wv[u] = kk < nk ? gload4<BF16>(p.w, size_t(k_lo + kk) * p.n + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = k + 32 * u;
#pragma unroll
        for (int r = 0; r < kFewRows; ++r) {
          if (r < p.n_rows) {
            const float a = kk < nk ? xs[r * p.ks + kk] : 0.f;
            acc[r][0] = fmaf(a, wv[u].x, acc[r][0]);
            acc[r][1] = fmaf(a, wv[u].y, acc[r][1]);
            acc[r][2] = fmaf(a, wv[u].z, acc[r][2]);
            acc[r][3] = fmaf(a, wv[u].w, acc[r][3]);
          }
        }
      }
    }
  }
  // the warp's four k lanes of each column vector (lanes cv, cv + 8, cv + 16, cv + 24)
#pragma unroll
  for (int r = 0; r < kFewRows; ++r) {
    if (r >= p.n_rows) break;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = acc[r][i];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[r][i] = v;
    }
    if (lane < 8)
      *reinterpret_cast<float4*>(red + (warp * kFewRows + r) * kFewCols + 4 * lane) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int e = tid; e < p.n_rows * kFewCols; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) s += red[w8 * kFewRows * kFewCols + e];
    part[e] = s;
  }

  // the ranks' partial tiles, summed in rank order; rank q writes vectors q, q + cs, ...
  cg::cluster_group cluster = cg::this_cluster();
  if (p.cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  for (int e = rank + p.cs * tid; e < p.n_rows * (kFewCols / 4); e += p.cs * kThreads) {
    const int r = e / (kFewCols / 4), c = 4 * (e - r * (kFewCols / 4));
    if (n0 + c >= p.n) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int pr = 0; pr < p.cs; ++pr) {
      const float* src = p.cs > 1 ? cluster.map_shared_rank(part, pr) : part;
      const float4 v = *reinterpret_cast<const float4*>(src + r * kFewCols + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const float4 b = gload4<BF16>(p.b, n0 + c);
    float v[4] = {s.x + b.x, s.y + b.y, s.z + b.z, s.w + b.w};
    if (p.relu) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
    }
    const size_t o = size_t(r) * p.n + n0 + c;
    if constexpr (BF16) {
      __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) + o);
      d[0] = __floats2bfloat162_rn(v[0], v[1]);
      d[1] = __floats2bfloat162_rn(v[2], v[3]);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if (p.cs > 1) cluster.sync();           // the peers have read this rank's tile
}

// Shared memory of a tc / tc_stream launch; fills ch's offsets.  fused_mlp.py
// `tc_smem` computes the same bytes.
size_t layout(Chain& ch, int rows, bool stream, bool bf16) {
  int words = 0;
  const int n_layers = ch.n_layers;
  if (!stream) {
    for (int l = 0; l < n_layers; ++l) {
      const int n8 = round8(ch.widths[l + 1]);
      ch.off_w[l] = words;
      words += round8(ch.widths[l]) * n8;
      ch.off_b[l] = words;
      words += n8;
    }
  }
  // x: rows padded to round8(C0) + 4 floats (C0 + 8 bf16) where C0 fills whole
  // 16-byte vectors, so layer 0's A reads hit 32 banks; else flat (stride C0); 8
  // words past each buffer for layer 0's masked reads
  const int c0 = ch.widths[0], esz = bf16 ? 2 : 4;
  ch.xs_stride = c0 % (16 / esz) != 0 ? c0 : bf16 ? c0 + 8 : round8(c0) + 4;
  ch.x_words = round4((rows * ch.xs_stride * esz + 3) / 4 + 8);
  ch.off_x = words;
  words += (stream ? 1 : 2) * ch.x_words;
  // buffer j holds the input of every layer l >= 1 with (l - 1) & 1 == j; a row is
  // round16(C) + 8 pairs, so that the 16-byte loads of a quarter warp (rows g, g + 1)
  // hit distinct banks
  for (int j = 0; j < 2; ++j) {
    int stride = 0;
    for (int l = 1; l < n_layers; ++l) {
      const int ps = ((ch.widths[l] + 15) & ~15) + 8;
      if (((l + 1) & 1) == j && ps > stride) stride = ps;
    }
    ch.act_stride[j] = stride;
    ch.off_act[j] = words;
    words += 2 * rows * stride;
  }
  ch.off_ring = words;
  if (stream) words += kStages * kChunk * kRingStride * esz / 4;
  return size_t(words) * 4;
}

size_t few_smem(int ks) {
  return 4 * size_t(round4(kFewRows * ks) + kWarps * kFewRows * kFewCols + kFewRows * kFewCols);
}

template <class Kernel, class P>
cudaError_t launch(Kernel kernel, bool* raised, const P& p, dim3 grid, int cluster_y,
                   size_t smem, cudaStream_t st) {
  // The dynamic shared memory this instance may use, per device: raised (once, to the
  // card's maximum) the first time a launch needs more than the 48 KB default, so
  // later launches, and launches captured in a CUDA graph, make no extra call.
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultSmem && !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster_y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_y > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int R, bool STREAM, bool BF16>
cudaError_t launch_tc(const Chain& ch, dim3 grid, size_t smem, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  return launch(fused_mlp_tc_kernel<R, STREAM, BF16>, raised, ch, grid, 1, smem, st);
}

template <bool STREAM, bool BF16>
cudaError_t dispatch_rows(const Chain& ch, int rows, dim3 grid, size_t smem,
                          cudaStream_t st) {
  switch (rows) {
    case 64: return launch_tc<64, STREAM, BF16>(ch, grid, smem, st);
    case 32: return launch_tc<32, STREAM, BF16>(ch, grid, smem, st);
    default: return launch_tc<16, STREAM, BF16>(ch, grid, smem, st);
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

// x (n_rows, widths[0]); w[i] (widths[i], widths[i+1]); b[i] (widths[i+1],); out
// (n_rows, widths[n_layers]); all float32 (bf16 = 0) or all bfloat16 (bf16 = 1),
// contiguous, 16-byte aligned.  The launch comes from fused_mlp.py (plan_mlp): stream
// 0 (W resident) or 1 (streamed); rows_per_cta 64, 32 or 16; ctas persistent CTAs (resident, at most the row tiles);
// col_splits CTAs sharing a single-layer group's passes (streamed; 1 otherwise);
// smem_bytes the plan's shared memory, which must equal this file's layout.  Returns
// a cudaError_t (0 = launched).
extern "C" int fused_mlp_tc(const void* x, void* out, const void* const* w,
                            const void* const* b, const int* widths, int n_layers,
                            int n_rows, int stream, int rows_per_cta, int ctas,
                            int col_splits, int bf16, int final_act, int smem_bytes,
                            void* cuda_stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_rows <= 0 ||
      (rows_per_cta != 64 && rows_per_cta != 32 && rows_per_cta != 16) || ctas < 1 ||
      col_splits < 1 || (!stream && col_splits != 1))
    return cudaErrorInvalidValue;
  Chain ch = {};
  ch.x = x;
  ch.out = out;
  ch.n_layers = n_layers;
  ch.n_rows = n_rows;
  ch.final_act = final_act;
  ch.col_splits = col_splits;
  ch.tiles = (n_rows + rows_per_cta - 1) / rows_per_cta;
  if (misaligned(x) || misaligned(out)) return cudaErrorMisalignedAddress;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] < 1) return cudaErrorInvalidValue;
    ch.widths[i] = widths[i];
  }
  for (int i = 0; i < n_layers; ++i) {
    ch.w[i] = w[i];
    ch.b[i] = b[i];
    if (misaligned(w[i]) || misaligned(b[i])) return cudaErrorMisalignedAddress;
    if (bf16 && stream && widths[i + 1] % 2 != 0) return cudaErrorInvalidValue;
  }
  const size_t smem = layout(ch, rows_per_cta, stream != 0, bf16 != 0);
  if (smem > kMaxSmem || smem != size_t(smem_bytes)) return cudaErrorInvalidValue;
  const int pass_tiles = (round8(widths[n_layers]) / 8 + kPassTiles - 1) / kPassTiles;
  if (stream ? col_splits > pass_tiles : ctas > ch.tiles) return cudaErrorInvalidValue;
  const dim3 grid = stream ? dim3(ch.tiles, col_splits, 1) : dim3(ctas, 1, 1);
  auto st = static_cast<cudaStream_t>(cuda_stream);
  if (stream)
    return bf16 ? dispatch_rows<true, true>(ch, rows_per_cta, grid, smem, st)
                : dispatch_rows<true, false>(ch, rows_per_cta, grid, smem, st);
  return bf16 ? dispatch_rows<false, true>(ch, rows_per_cta, grid, smem, st)
              : dispatch_rows<false, false>(ch, rows_per_cta, grid, smem, st);
}

// One layer at few rows: x (n_rows, k), w (k, n), b (n,), out (n_rows, n); float32 or
// bfloat16 (bf16 = 1), contiguous, 16-byte aligned; n_rows <= 16, n % 4 == 0.  The
// grid is ceil(n / 32) x cs CTAs, clusters of cs (1..8) along y, each rank taking
// ceil(k / cs) rows of w; smem_bytes must equal few_smem.  Returns a cudaError_t.
extern "C" int fused_mlp_few_rows(const void* x, void* out, const void* w, const void* b,
                                  int n_rows, int k, int n, int cs, int bf16, int final_act,
                                  int smem_bytes, void* stream) {
  if (n_rows < 1 || n_rows > kFewRows || k < 1 || n < 4 || n % 4 != 0 || cs < 1 ||
      cs > kMaxSplit)
    return cudaErrorInvalidValue;
  if (misaligned(x) || misaligned(out) || misaligned(w) || misaligned(b))
    return cudaErrorMisalignedAddress;
  const Few p{x, out, w, b, n_rows, k, n, cs, (k + cs - 1) / cs, final_act};
  const size_t smem = few_smem(p.ks);
  if (smem > kMaxSmem || smem != size_t(smem_bytes)) return cudaErrorInvalidValue;
  const dim3 grid((n + kFewCols - 1) / kFewCols, cs, 1);
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    static bool raised[kMaxDevices] = {};
    return launch(fused_mlp_few_rows_kernel<true>, raised, p, grid, cs, smem, s);
  }
  static bool raised[kMaxDevices] = {};
  return launch(fused_mlp_few_rows_kernel<false>, raised, p, grid, cs, smem, s);
}
