// Flash decoding for Hopper (sm_90a): one new token's GQA attention over a KV cache.
//
//   out[b, h] = softmax_{j < len_b}(cap(scale * q[b, h] . k[b, j, h / G])) @ v[b, :, h / G]
//
// with len_b = clamp(lengths[b], 0, S), cap(s) = softcap * tanh(s / softcap) when a
// softcap is given, and zeros where len_b = 0.
//
// Replaces src/repro/kernels/flash_decode/flash_decode.py:flash_decode_pallas (body
// _kernel): the LM decode step's attention, one launch per attention layer per step.
//
// What bounds it on this card.  The call reads the valid prefix of the cache once and
// does about 4 FLOP a cached value, far below the card's 295 FLOP a byte: bytes bound
// it.  At granite-moe-1b's decode (B 8, 8 kv heads, head_dim 64, bf16, 513-544 of 1024
// slots valid) that is about 8.9 MB, 2.6 us at 3.35 TB/s.  Tensor cores do not help:
// G = 2 query rows per kv head are far below wgmma's 64.  The design puts as many
// bytes in flight as the card holds and moves each valid byte once.
//
// Split over S.  The grid is (B * Hkv * ceil(G / GT), n_split): a CTA holds GT query
// heads of one kv head and one chunk of its cache.  The host picks n_split from
// shapes and the SM count only (flash_decode.py plan_splits: the smallest power of
// two <= 8 that gives at least 2 x n_SM CTAs, capped at ceil(S / 64); 8 at the main
// path, 512 CTAs).  Each CTA reads len_b on the device and takes the chunk
// [i c, min(len_b, (i + 1) c)), c = ceil(len_b / n_split) rounded up to the
// positions one warp's load covers, so chunks balance by the real length, nothing at
// or past len_b is read, and the launch does not depend on the values in `lengths`
// (a CUDA graph can replay it with new lengths).
//
// Loads.  A lane group of GS lanes (a power of two <= 32) covers one cached row: lane
// l of the group loads vectors l, l + GS, ... of VEC bytes (16 at the main path: a
// 128-byte bf16 row is 8 lanes x 16 bytes, a warp covers 4 positions a load).  VEC is
// the widest of 16, 8, 4 (2 for bf16 at an odd head_dim) that divides the row and the
// operands' alignment; rows that are no multiple of 16 bytes take narrower loads in
// this same kernel.  A round issues K and V of kLoads / NV positions a group (every
// load of the chunk at the main path: 68 positions, 16 groups x 5) before any math,
// read-only (ld.global.nc) into registers.  Registers rather than a cp.async ring:
// the chunk is one round, so nothing is left to overlap, and the data goes from the
// load straight into the FMAs; launch bounds hold it to 96 registers (chip_smoke.py
// prints ptxas's count), so five 128-thread CTAs share an SM by registers: 660 CTA
// slots on 132 SMs for the main path's 512.
//
// Math, float32 throughout.  q (scaled) stays in registers; each group dots its K row
// with the GT heads and reduces over its GS lanes by shuffles; an online softmax per
// head runs over the round, and P V accumulates in registers (GT x the lane's dims).
// At the end of the chunk the groups' partials (m, l, acc) merge once through shared
// memory into the CTA's partial.
//
// Combine.  The n_split CTAs of one (b, kv head, head group) form a thread-block
// cluster (1, n_split, 1), n_split <= 8, the portable size.  Each CTA arrives on the
// cluster barrier as it starts and waits on it only once its chunk is done, so rank
// 0's shared memory is live before anyone writes to it.  Each then stores its
// partial (m, l, acc) into its slot of rank 0's shared memory through distributed
// shared memory; cluster.sync() releases the slots, the peers exit, and rank 0
// merges the n_split partials by log-sum-exp from its own memory (no remote reads)
// and writes the output.  An empty chunk leaves m = -1e30, l = 0, acc = 0: its weight
// is 0 beside a non-empty one, and where every chunk is empty l == 0 -> 1 gives zeros,
// as the Pallas kernel's flush does.  One launch a call; no workspace.
//
// q and the cache may differ in type (f32 or bf16 each); the output takes q's type.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W; cache read from device
// memory): 0.0119 ms a call at the main path against SDPA's 0.0094, the earlier
// one-CTA-per-kv-head kernel's 0.1545 and the 0.0026 bound; 0.0208 / 0.0157 / 0.0126
// at n_split 1 / 2 / 4.  The same launch with every length 0 takes 0.0068 ms (launch,
// the lengths read, the merges, the cluster barrier): fixed latency, not bytes, sets
// the floor at this size.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kLoads = 5;                // vector loads of K (and of V) a lane a round
constexpr int kMaxSplit = 8;             // the portable cluster size
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
  int g;                                 // Hq / Hkv
  int n_hg;                              // head groups of GT heads a kv head
  int gs;                                // lanes of a row group
  int n_split;                           // CTAs (and cluster size) a kv head
  float softcap;                         // <= 0: none
  float scale;
  int q_bf16;
};

// VEC bytes of K or V as 32-bit words (a 2-byte load fills the low half of one).
template <typename KV, int VEC>
struct Vec {
  static constexpr int kElems = VEC / int(sizeof(KV));
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;

  __device__ __forceinline__ static void load(const char* p, uint32_t (&w)[kWords]) {
    if constexpr (VEC == 16) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = t.x;
      w[1] = t.y;
      w[2] = t.z;
      w[3] = t.w;
    } else if constexpr (VEC == 8) {
      const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = t.x;
      w[1] = t.y;
    } else if constexpr (VEC == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  __device__ __forceinline__ static float elem(const uint32_t (&w)[kWords], int t) {
    if constexpr (std::is_same<KV, float>::value) {
      return __uint_as_float(w[t]);
    } else if constexpr (VEC == 2) {
      return __uint_as_float(w[0] << 16);
    } else {
      const uint32_t x = w[t >> 1];
      return __uint_as_float((t & 1) ? (x & 0xffff0000u) : (x << 16));
    }
  }
};

__device__ __forceinline__ float ld_q(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_o(void* p, size_t i, float v, int bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// Shared memory of one CTA in floats: the partial (acc, m, l) of each lane group and,
// on the cluster's rank 0, one slot for each CTA of the cluster.
__host__ __device__ inline size_t smem_floats(int gs, int gt, int d, int n_split) {
  return size_t(kThreads / gs + (n_split > 1 ? n_split : 0)) * gt * (d + 2);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// At most 96 registers where GT <= 2: five CTAs share an SM, and the card holds the
// main path's 64 clusters of 8 CTAs in one wave (at four CTAs an SM it did not).
template <typename KV, int VEC, int NV, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 2 ? 5 : 2)
    flash_decode_kernel(const __grid_constant__ Params p) {
  using V = Vec<KV, VEC>;
  constexpr int E = V::kElems, W = V::kWords, R = kLoads / NV;
  extern __shared__ float smem[];
  const int D = p.d, gs = p.gs, ng = kThreads / gs;
  const int tid = threadIdx.x, grp = tid / gs, lig = tid - grp * gs;
  const int slot = GT * (D + 2);         // a partial: acc (GT x D), m (GT), l (GT)
  float* s_acc = smem;                   // ng x GT x D: the groups' accumulators
  float* s_m = s_acc + ng * GT * D;      // ng x GT
  float* s_l = s_m + ng * GT;            // ng x GT
  float* c_part = s_l + ng * GT;         // rank 0: n_split slots, one a CTA
  // every CTA of the cluster arrives once it has started, and waits for the
  // others only before it writes into rank 0's shared memory
  if (p.n_split > 1) cluster_arrive_relaxed();

  int x = blockIdx.x;
  const int hg = x % p.n_hg;
  x /= p.n_hg;
  const int kvh = x % p.hkv, b = x / p.hkv;
  const int h0 = kvh * p.g + hg * GT;    // the CTA's first query head
  const int nh = min(GT, p.g - hg * GT);
  const int len = min(max(p.lengths[b], 0), p.s);
  const int align = 32 / gs;             // positions a warp's load covers
  int c = (len + p.n_split - 1) / p.n_split;
  c = (c + align - 1) / align * align;
  const int start = min(len, int(blockIdx.y) * c), end = min(len, start + c);

  // lane vector j covers dims (j * gs + lig) * E + t, t < E
  bool col[NV];
  float q[GT][NV][E], acc[GT][NV][E], m[GT], l[GT];
#pragma unroll
  for (int j = 0; j < NV; ++j) col[j] = (j * gs + lig) * E < D;
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int t = 0; t < E; ++t) {
        const int d = (j * gs + lig) * E + t;
        q[h][j][t] = h < nh && col[j]
                         ? ld_q(p.q, (size_t(b) * p.hq + h0 + h) * D + d, p.q_bf16) * p.scale
                         : 0.f;
        acc[h][j][t] = 0.f;
      }
    }
  }

  const size_t row_bytes = size_t(p.hkv) * D * sizeof(KV);   // between positions
  const size_t head_off = (size_t(b) * p.s * p.hkv + kvh) * D * sizeof(KV);
  const char* kb = static_cast<const char*>(p.k) + head_off;
  const char* vb = static_cast<const char*>(p.v) + head_off;

  for (int base = start; base < end; base += ng * R) {
    uint32_t kw[R][NV][W], vw[R][NV][W];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int pos = base + r * ng + grp;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (pos < end && col[j]) {
          const size_t off = pos * row_bytes + size_t(j * gs + lig) * VEC;
          V::load(kb + off, kw[r][j]);
          V::load(vb + off, vw[r][j]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) kw[r][j][w] = vw[r][j][w] = 0u;
        }
      }
    }

    float sc[R][GT];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int t = 0; t < E; ++t) dot = fmaf(q[h][j][t], V::elem(kw[r][j], t), dot);
        for (int off = gs >> 1; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (p.softcap > 0.f) dot = p.softcap * tanhf(dot / p.softcap);
        sc[r][h] = base + r * ng + grp < end ? dot : kNegInf;
      }
    }

#pragma unroll
    for (int h = 0; h < GT; ++h) {
      float mx = m[h];
#pragma unroll
      for (int r = 0; r < R; ++r) mx = fmaxf(mx, sc[r][h]);
      const float alpha = expf(m[h] - mx);
      m[h] = mx;
      l[h] *= alpha;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int t = 0; t < E; ++t) acc[h][j][t] *= alpha;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pr = base + r * ng + grp < end ? expf(sc[r][h] - mx) : 0.f;
        l[h] += pr;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int t = 0; t < E; ++t) acc[h][j][t] = fmaf(pr, V::elem(vw[r][j], t), acc[h][j][t]);
      }
    }
  }

  // the groups' partials -> the CTA's, through shared memory
#pragma unroll
  for (int h = 0; h < GT; ++h) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!col[j]) continue;
#pragma unroll
      for (int t = 0; t < E; ++t) s_acc[(grp * GT + h) * D + (j * gs + lig) * E + t] = acc[h][j][t];
    }
    if (lig == 0) {
      s_m[grp * GT + h] = m[h];
      s_l[grp * GT + h] = l[h];
    }
  }
  __syncthreads();

  // each CTA writes its partial into slot `rank` of rank 0's shared memory
  cg::cluster_group cluster = cg::this_cluster();
  float* dst = nullptr;
  if (p.n_split > 1) {
    cluster_wait();                      // rank 0 has started: its memory is live
    dst = cluster.map_shared_rank(c_part, 0) + blockIdx.y * slot;
  }
  for (int i = tid; i < GT * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float mx = kNegInf;
#pragma unroll 4
    for (int gi = 0; gi < ng; ++gi) mx = fmaxf(mx, s_m[gi * GT + h]);
    float a = 0.f, ls = 0.f;
#pragma unroll 4
    for (int gi = 0; gi < ng; ++gi) {
      const float w = expf(s_m[gi * GT + h] - mx);
      a = fmaf(w, s_acc[(gi * GT + h) * D + d], a);
      ls = fmaf(w, s_l[gi * GT + h], ls);
    }
    if (p.n_split == 1) {
      if (h < nh)
        st_o(p.o, (size_t(b) * p.hq + h0 + h) * D + d, a / (ls == 0.f ? 1.f : ls), p.q_bf16);
    } else {
      dst[i] = a;
      if (d == 0) {
        dst[GT * D + h] = mx;
        dst[GT * D + GT + h] = ls;
      }
    }
  }
  if (p.n_split == 1) return;

  // the cluster's partials -> the output, merged by rank 0 from its own memory
  cluster.sync();                        // release the slots to rank 0
  if (blockIdx.y != 0) return;
  for (int i = tid; i < nh * D; i += kThreads) {
    const int h = i / D;
    float mr[kMaxSplit];
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      mr[r] = r < p.n_split ? c_part[r * slot + GT * D + h] : kNegInf;
      mx = fmaxf(mx, mr[r]);
    }
    float a = 0.f, ls = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) {
      if (r < p.n_split) {
        const float w = expf(mr[r] - mx);
        a = fmaf(w, c_part[r * slot + i], a);
        ls = fmaf(w, c_part[r * slot + GT * D + GT + h], ls);
      }
    }
    st_o(p.o, (size_t(b) * p.hq + h0) * D + i, a / (ls == 0.f ? 1.f : ls), p.q_bf16);
  }
}

// How a call launches: grid x, dynamic shared memory and stream.
struct Launch {
  int grid_x;
  size_t smem;
  cudaStream_t stream;
};

template <typename KV, int VEC, int NV, int GT>
cudaError_t launch(const Params& p, const Launch& l) {
  static bool raised[kMaxDevices] = {};
  auto kernel = flash_decode_kernel<KV, VEC, NV, GT>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (l.smem > kDefaultSmem && !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.grid_x, p.n_split, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.n_split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename KV, int VEC, int NV>
cudaError_t by_heads(const Params& p, int gt, const Launch& l) {
  switch (gt) {
    case 1: return launch<KV, VEC, NV, 1>(p, l);
    case 2: return launch<KV, VEC, NV, 2>(p, l);
    case 4: return launch<KV, VEC, NV, 4>(p, l);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV, int VEC>
cudaError_t by_loads(const Params& p, int nv, int gt, const Launch& l) {
  switch (nv) {
    case 1: return by_heads<KV, VEC, 1>(p, gt, l);
    case 2: return by_heads<KV, VEC, 2>(p, gt, l);
    case 4: return by_heads<KV, VEC, 4>(p, gt, l);
    default: return cudaErrorInvalidValue;
  }
}

template <typename KV>
cudaError_t by_width(const Params& p, int vec, int nv, int gt, const Launch& l) {
  switch (vec) {
    case 16: return by_loads<KV, 16>(p, nv, gt, l);
    case 8: return by_loads<KV, 8>(p, nv, gt, l);
    case 4: return by_loads<KV, 4>(p, nv, gt, l);
    case 2:
      if constexpr (sizeof(KV) == 2) return by_loads<KV, 2>(p, nv, gt, l);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* lengths,
                     void* o, int b, int hq, int hkv, int s, int d, float softcap,
                     float scale, int q_bf16, int kv_bf16, int vec, int nv, int gt, int gs,
                     int n_split, cudaStream_t stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s < 0 || d <= 0) return cudaErrorInvalidValue;
  const int es = kv_bf16 ? 2 : 4;
  if (vec < es || (d * es) % vec != 0 || gs < 1 || gs > 32 || (gs & (gs - 1)) != 0 ||
      gs * nv * vec < d * es || n_split < 1 || n_split > kMaxSplit)
    return cudaErrorInvalidValue;
  const int g = hq / hkv;
  const int n_hg = (g + gt - 1) / gt;
  Params p{q, k, v, static_cast<const int*>(lengths), o, b, hq, hkv, s, d, g, n_hg, gs,
           n_split, softcap, scale, q_bf16};
  const Launch l{b * hkv * n_hg, sizeof(float) * smem_floats(gs, gt, d, n_split), stream};
  if (l.smem > kMaxSmem) return cudaErrorInvalidValue;
  return kv_bf16 ? by_width<__nv_bfloat16>(p, vec, nv, gt, l)
                 : by_width<float>(p, vec, nv, gt, l);
}

}  // namespace

// q (b, hq, d); k, v (b, s, hkv, d); lengths (b,) int32; o (b, hq, d) in q's type.
// q_bf16 / kv_bf16 give the types (0 = float32, 1 = bfloat16); all contiguous, k and v
// aligned to vec bytes.  The launch plan comes from flash_decode.py (plan_launch): vec
// bytes a K/V load (16, 8, 4; 2 for bf16), nv loads a lane covers of one row, gt query
// heads a CTA (1, 2, 4), gs lanes a row (a power of two <= 32; gs * nv * vec covers
// the row), n_split CTAs a kv head (1..8, one cluster).  hq % hkv == 0; softcap <= 0
// means none.  Returns a cudaError_t (0 = launched).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* lengths, void* o, int b, int hq, int hkv, int s,
                            int d, float softcap, float scale, int q_bf16, int kv_bf16,
                            int vec, int nv, int gt, int gs, int n_split, void* stream) {
  return dispatch(q, k, v, lengths, o, b, hq, hkv, s, d, softcap, scale, q_bf16, kv_bf16,
                  vec, nv, gt, gs, n_split, static_cast<cudaStream_t>(stream));
}
