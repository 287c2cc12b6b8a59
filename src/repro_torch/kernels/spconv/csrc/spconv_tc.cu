// Fetch-on-demand sparse convolution on Hopper's tensor cores (sm_90a), float32 in
// split-float TF32.
//
//   out[j, :] = epilogue( sum_k  feats[inv[k, j], :] @ W[k] ),  inv[k, j] = -1 -> no term
//
// One template, two C entry points, as in spconv.cu (the FMA kernel, which keeps the
// shapes this one does not take):
//
//   spconv_fod_tc        replaces src/repro/kernels/spconv/spconv.py:spconv_fod_pallas:
//                        the sum alone; blockIdx.y walks Cout in tiles of CN columns.
//   spconv_fod_fused_tc  replaces src/repro/kernels/spconv/spconv.py:
//                        spconv_fod_fused_pallas: the sum, then at flush +bias ->
//                        layernorm (eps 1e-6, over the true Cout) -> +residual -> ReLU
//                        -> *mask, then one write.  Cout <= 256: one CTA tile owns
//                        the whole row, because the layernorm needs it.
//
// Takes float32 with Cin % 4 == 0 and Cout % 4 == 0 (rows of whole 16-byte vectors)
// and 16-byte-aligned features and weights (spconv.py `variant`); other shapes go to
// spconv.cu.
//
// What bounds it on this card.  Operations: a full-width MinkUNet forward holds about
// 69 GFLOP of real multiply-adds (2 * nnz(inv) * Cin * Cout) against a few tens of MB
// that must move.  Split-float TF32 takes three tensor-core products for each float32
// product, so the bound is 3 x FLOPs / 494.7 TFLOP/s (dense TF32), about 0.42 ms a
// forward, against 1.03 ms for float32 FMAs at 67 TFLOP/s.
//
// What the design does about it.
//   * Tensor cores at float32 accuracy: every operand x is split into
//     hi = tf32_rna(x) and lo = tf32_rna(x - hi) (round to nearest: truncation would
//     bias lo), and a product takes lo*hi + hi*lo + hi*hi with mma.sync.m16n8k8 TF32
//     (HMMA), CUTLASS's "fast float32" scheme.  One TF32 product keeps about three
//     decimal digits and fails the 1e-4 check; three keep about float32's.  Operands
//     are split in registers a fragment; the three products of a k8 step are issued
//     product by product over the warp's column tiles, so no HMMA waits on the one
//     before.  The tensor cores' float32 accumulation does not round to nearest, so a
//     stage's products gather in a fresh fragment that joins the accumulator by a
//     rounded float32 add: the error stays that of float32 sums in another order.
//   * A CTA computes 64 output rows x CN columns (CN 32..256), 8 warps as 4 row groups
//     of 16 x 2 column halves.  A warp skips an offset that none of its 16 rows has
//     (the m16 MMA's granularity); a CTA skips an offset that none of its 64 rows has,
//     loads and all.
//   * Fetch on demand through a cp.async pipeline (2..6 stages by CN) over the
//     sequence (live offset, chunk of 32 input channels): the gathered rows arrive
//     with 16-byte cp.async straight into shared memory (zero-filled for -1 and for
//     channels past Cin), beside the matching W[k] slice, while the tensor cores work
//     on the stages before.  The gathered matrix never exists in device memory.
//     Shared rows are padded (36 and CN + 8 floats) so fragment reads hit 32 banks.
//   * The card fills at every level, whatever the live rows.  The main path pads
//     every level to the bucket (M = 65536), so the host cannot tell a level with 782
//     live row tiles from one with 9; the device does.  The launch is persistent: G
//     clusters of n_split CTAs (the host's plan_conv, from shapes and the SM count
//     only: two waves of two CTAs an SM, clusters of 8 for 256-column tiles and of 4
//     for narrower ones), cluster c owning row tiles c, c + G, ....  Its ranks first
//     scan those tiles' maps: a tile without an input is written at once as
//     epilogue(0) by the rank that scanned it (one bias and layernorm row for all its
//     rows, 16-byte residual loads and stores); the live ones form one list, the same
//     on every rank.  The cluster then takes its live tiles in rounds: with R left, a
//     round takes g = min(n_split, R) of them, one to each of g groups of contiguous
//     ranks.  A rank alone on its tile runs every offset and flushes by itself; a
//     group of s ranks splits the tile's offsets (rank q: q, q + s, ...), and the
//     partial tiles meet in distributed shared memory: rank q sums its column slice
//     over the group in rank order (16-byte loads), the layernorm's row sums (mean,
//     then the centred variance) are exchanged the same way, and each rank writes its
//     own columns, reading bias, residual and mask only for them.  A rank with no live
//     offset joins with zeros.  So many live tiles run one a CTA with no exchange, and
//     a level with few (9 at MinkUNet's coarsest) spreads each over a cluster of 8.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;                 // output rows a CTA
constexpr int kThreads = 256;             // 8 warps: 4 row groups x 2 column halves
constexpr int kChunk = 32;                // input channels a pipeline stage
constexpr int kAStride = kChunk + 4;      // floats a gathered row in shared memory
constexpr int kWPad = 8;                  // extra floats a weight row in shared memory
constexpr int kMaxCout = 256;
constexpr int kMaxSplit = 8;              // the portable cluster size
constexpr int kMaxClusterTiles = 256;     // row tiles a cluster may own
constexpr int kMaxKvol = 512;             // kernel offsets (spconv.py MAX_KVOL)
constexpr float kLnEps = 1e-6f;           // repro nn.layernorm eps
constexpr size_t kMaxSmem = 232448;
constexpr int kMaxDevices = 64;

template <int CN>
struct Cfg {
  static constexpr int kStages = CN == 32 ? 6 : CN == 64 ? 4 : CN == 128 ? 3 : 2;
  static constexpr int kWStride = CN + kWPad;
  static constexpr int kStageFloats = kRows * kAStride + kChunk * kWStride;
  static constexpr int kOutStride = CN + 4;      // the partial tile, aliasing the stages
  static constexpr int kWarpCols = CN / 2;
  static constexpr int kNT = kWarpCols / 8;      // n8 column tiles a warp
  static constexpr int kGN = kNT < 4 ? kNT : 4;  // column tiles a pass (registers)
  static_assert(kRows * kOutStride <= kStages * kStageFloats, "partial tile too large");
};

// Dynamic shared memory in 4-byte words: the stages, two 64-row statistics, for
// each of the kvol offsets 64 indices, two row-half ballots and a list slot, and two
// lists of kMaxClusterTiles row tiles (this rank's live ones, the cluster's).
template <int CN>
__host__ __device__ constexpr size_t smem_words(int kvol) {
  return size_t(Cfg<CN>::kStages) * Cfg<CN>::kStageFloats + 2 * kRows +
         size_t(kvol) * (kRows + 3) + 2 * kMaxClusterTiles;
}

// kMaxKvol offsets fit at every column tile (spconv.py `variant` takes no more).
static_assert(4 * smem_words<32>(kMaxKvol) <= kMaxSmem - 1024, "smem at CN 32");
static_assert(4 * smem_words<64>(kMaxKvol) <= kMaxSmem - 1024, "smem at CN 64");
static_assert(4 * smem_words<128>(kMaxKvol) <= kMaxSmem - 1024, "smem at CN 128");
static_assert(4 * smem_words<256>(kMaxKvol) <= kMaxSmem - 1024, "smem at CN 256");

struct Params {
  const float* feats;                     // (n, cin)
  const int* inv;                         // (kvol, m)
  const float* w;                         // (kvol, cin, cout)
  const float* bias;                      // (cout,) or null
  const float* ln_scale;                  // (cout,) or null, with ln_bias
  const float* ln_bias;
  const float* residual;                  // (m, cout) or null
  const float* mask;                      // (m,) or null
  float* out;                             // (m, cout)
  int n, cin, kvol, m, cout, relu;
  int n_split;                            // CTAs a cluster
  int clusters;                           // G: cluster c owns row tiles c, c + G, ...
  int* stats;                             // null, or 4 counters (see the entry points)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
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

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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

// One k8 step of NT column tiles: A's fragment and each tile's B fragment split in
// registers, then the three products issued product by product over the tiles
// (small terms first), so consecutive HMMAs write different accumulators.
template <int NT, int WS>
__device__ __forceinline__ void mma_k8(float (&acc)[NT][4], const float* sa,
                                       const float* sw, int kk, int g, int t, int cols) {
  uint32_t ahi[4], alo[4], bhi[NT][2], blo[NT][2];
  split(sa[g * kAStride + kk + t], ahi[0], alo[0]);
  split(sa[(g + 8) * kAStride + kk + t], ahi[1], alo[1]);
  split(sa[g * kAStride + kk + t + 4], ahi[2], alo[2]);
  split(sa[(g + 8) * kAStride + kk + t + 4], ahi[3], alo[3]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    split(sw[(kk + t) * WS + nt * 8 + g], bhi[nt][0], blo[nt][0]);
    split(sw[(kk + t + 4) * WS + nt * 8 + g], bhi[nt][1], blo[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt * 8 < cols) mma_tf32(acc[nt], alo, bhi[nt][0], bhi[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt * 8 < cols) mma_tf32(acc[nt], ahi, blo[nt][0], blo[nt][1]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    if (nt * 8 < cols) mma_tf32(acc[nt], ahi, bhi[nt][0], bhi[nt][1]);
}

// One stage (kc <= 32 input channels) into the warp's accumulator, kGN column tiles a
// pass, each pass into a fresh fragment added to the accumulator in float32.
template <int CN>
__device__ __forceinline__ void mma_stage(float (&acc)[Cfg<CN>::kNT][4], const float* sa,
                                          const float* sw, int kc, int g, int t,
                                          int cols) {
  using C = Cfg<CN>;
  constexpr int GN = C::kGN;
#pragma unroll
  for (int h = 0; h < C::kNT / GN; ++h) {
    if (h * GN * 8 >= cols) break;
    float part[GN][4];
#pragma unroll
    for (int i = 0; i < GN; ++i) part[i][0] = part[i][1] = part[i][2] = part[i][3] = 0.f;
    if (kc == kChunk) {
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 8)
        mma_k8<GN, C::kWStride>(part, sa, sw + h * GN * 8, kk, g, t, cols - h * GN * 8);
    } else {
      for (int kk = 0; kk < kc; kk += 8)
        mma_k8<GN, C::kWStride>(part, sa, sw + h * GN * 8, kk, g, t, cols - h * GN * 8);
    }
#pragma unroll
    for (int i = 0; i < GN; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[h * GN + i][q] += part[i][q];
  }
}

// The epilogue of one value of row r, column n0 + c, after bias and layernorm.
template <bool FUSED>
__device__ __forceinline__ float finish(const Params& p, float x, float res, float mk) {
  if constexpr (FUSED) {
    x += res;
    if (p.relu) x = fmaxf(x, 0.f);
    if (p.mask != nullptr) x *= mk;
  }
  return x;
}

// A whole row tile written by one CTA: rows row0 .. row0 + 63 (those < m), columns
// n0 .. n0 + ncols - 1, from its partial tile (s_out) or, for a tile without an
// input (s_out null; all threads of the CTA call it then, and s_row holds CN
// floats of free shared memory), from zeros.  A warp owns 8 rows, taken 4 at a
// time with every global load of the 4 issued first; the layernorm's row sums are
// warp sums.
template <int CN, bool FUSED>
__device__ void flush_solo(const Params& p, const float* s_out, float* s_row, int row0,
                           int n0, int ncols, int warp, int lane) {
  using C = Cfg<CN>;
  constexpr int NJ = CN / 32;
  constexpr int RW = kRows / (kThreads / 32);
  constexpr int RB = 4;                   // rows in flight a warp
  const bool ln = FUSED && p.ln_scale != nullptr;
  if (s_out == nullptr) {
    // no input: every row's sum is 0, so bias and layernorm give one row for all,
    // which warp 0 puts in s_row; then 16-byte residual loads and output stores
    if (warp == 0) {
      float v[NJ];
      float s = 0.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = lane + 32 * jj;
        v[jj] = FUSED && c < ncols && p.bias != nullptr ? __ldg(p.bias + n0 + c) : 0.f;
        s += v[jj];
      }
      if (ln) {
        const float mu = warp_sum(s) / float(p.cout);
        float q = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float d = v[jj] - mu;
          q += lane + 32 * jj < ncols ? d * d : 0.f;
        }
        const float rstd = rsqrtf(warp_sum(q) / float(p.cout) + kLnEps);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = lane + 32 * jj;
          if (c < ncols)
            v[jj] = (v[jj] - mu) * rstd * __ldg(p.ln_scale + n0 + c) + __ldg(p.ln_bias + n0 + c);
        }
      }
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s_row[lane + 32 * jj] = v[jj];
    }
    __syncthreads();
    const int nq = ncols / 4;
    const int rows = min(kRows, p.m - row0);
    for (int e = threadIdx.x; e < rows * nq; e += kThreads) {
      const int r = row0 + e / nq, c = 4 * (e % nq);
      const float4 v = *reinterpret_cast<const float4*>(s_row + c);
      float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
      float mk = 1.f;
      if constexpr (FUSED) {
        if (p.residual != nullptr)
          res = __ldg(reinterpret_cast<const float4*>(p.residual + size_t(r) * p.cout + n0 + c));
        if (p.mask != nullptr) mk = __ldg(p.mask + r);
      }
      *reinterpret_cast<float4*>(p.out + size_t(r) * p.cout + n0 + c) =
          make_float4(finish<FUSED>(p, v.x, res.x, mk), finish<FUSED>(p, v.y, res.y, mk),
                      finish<FUSED>(p, v.z, res.z, mk), finish<FUSED>(p, v.w, res.w, mk));
    }
    return;
  }
#pragma unroll 1
  for (int i0 = 0; i0 < RW; i0 += RB) {
    float v[RB][NJ], res[RB][NJ], mk[RB];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int rl = warp * RW + i0 + b, r = row0 + rl;
      mk[b] = FUSED && p.mask != nullptr && r < p.m ? __ldg(p.mask + r) : 1.f;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = lane + 32 * jj;
        const bool in = c < ncols;
        res[b][jj] = FUSED && in && r < p.m && p.residual != nullptr
                         ? __ldg(p.residual + size_t(r) * p.cout + n0 + c) : 0.f;
        float x = in ? s_out[rl * C::kOutStride + c] : 0.f;
        if (FUSED && in && p.bias != nullptr) x += __ldg(p.bias + n0 + c);
        v[b][jj] = x;
      }
    }
    if (ln) {
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        float s = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) s += v[b][jj];  // zero past ncols
        const float mu = warp_sum(s) / float(p.cout);
        float q = 0.f;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const float d = v[b][jj] - mu;
          q += lane + 32 * jj < ncols ? d * d : 0.f;
        }
        const float rstd = rsqrtf(warp_sum(q) / float(p.cout) + kLnEps);
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int c = lane + 32 * jj;
          if (c < ncols)
            v[b][jj] = (v[b][jj] - mu) * rstd * __ldg(p.ln_scale + n0 + c) +
                       __ldg(p.ln_bias + n0 + c);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = row0 + warp * RW + i0 + b;
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        const int c = lane + 32 * jj;
        if (r < p.m && c < ncols)
          p.out[size_t(r) * p.cout + n0 + c] = finish<FUSED>(p, v[b][jj], res[b][jj], mk[b]);
      }
    }
  }
}

// A row tile split over the s ranks first .. first + s - 1 of the cluster (this CTA
// is rank first + q): each partial tile lies in its rank's s_out; rank q owns columns
// [q * S, min(ncols, (q + 1) * S)), S a multiple of 4.  Every rank of the cluster
// calls this in the same round (the barriers are the cluster's).
template <int CN, bool FUSED>
__device__ void flush_group(const Params& p, float* s_out, float* s_stat, int row0,
                            int n0, int ncols, int first, int s, int q, int warp,
                            int lane) {
  using C = Cfg<CN>;
  constexpr int RW = kRows / (kThreads / 32);
  cg::cluster_group cluster = cg::this_cluster();
  const int S = ((ncols + s - 1) / s + 3) & ~3;
  const int c_lo = min(ncols, q * S), c_hi = min(ncols, c_lo + S);
  const int nq = (c_hi - c_lo) / 4;       // 16-byte column groups of the slice
  cluster.sync();                         // every partial tile is in place
  const float* peer[kMaxSplit];
#pragma unroll
  for (int pr = 0; pr < kMaxSplit; ++pr)
    peer[pr] = cluster.map_shared_rank(s_out, first + min(pr, s - 1));
  for (int e = threadIdx.x; e < kRows * nq; e += kThreads) {
    const int r = e / nq, c = c_lo + 4 * (e - r * nq);
    float4 part[kMaxSplit];
#pragma unroll
    for (int pr = 0; pr < kMaxSplit; ++pr)  // all loads in flight, then the sums
      if (pr < s) part[pr] = *reinterpret_cast<const float4*>(peer[pr] + r * C::kOutStride + c);
    float4 x = part[0];
#pragma unroll
    for (int pr = 1; pr < kMaxSplit; ++pr)
      if (pr < s) {
        x.x += part[pr].x;
        x.y += part[pr].y;
        x.z += part[pr].z;
        x.w += part[pr].w;
      }
    if constexpr (FUSED) {
      if (p.bias != nullptr) {
        const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + n0 + c));
        x.x += b.x;
        x.y += b.y;
        x.z += b.z;
        x.w += b.w;
      }
    }
    // only this rank reads its own slice: the sum goes back in place
    *reinterpret_cast<float4*>(s_out + r * C::kOutStride + c) = x;
  }
  __syncthreads();
  float mu[RW], rstd[RW];
  const bool ln = FUSED && p.ln_scale != nullptr;
  if (ln) {
    // mean, then the centred variance, over the true Cout: the ranks' partial row
    // sums meet in shared memory and are summed in rank order
    const float* pst[kMaxSplit];
#pragma unroll
    for (int pr = 0; pr < kMaxSplit; ++pr)
      pst[pr] = cluster.map_shared_rank(s_stat, first + min(pr, s - 1));
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp * RW + i;
      float a = 0.f;
      for (int c = c_lo + lane; c < c_hi; c += 32) a += s_out[r * C::kOutStride + c];
      a = warp_sum(a);
      if (lane == 0) s_stat[r] = a;
    }
    cluster.sync();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp * RW + i;
      float a = 0.f;
#pragma unroll
      for (int pr = 0; pr < kMaxSplit; ++pr)
        if (pr < s) a += pst[pr][r];
      mu[i] = a / float(p.cout);
      float d2 = 0.f;
      for (int c = c_lo + lane; c < c_hi; c += 32) {
        const float d = s_out[r * C::kOutStride + c] - mu[i];
        d2 += d * d;
      }
      d2 = warp_sum(d2);
      if (lane == 0) s_stat[kRows + r] = d2;
    }
    cluster.sync();
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = warp * RW + i;
      float a = 0.f;
#pragma unroll
      for (int pr = 0; pr < kMaxSplit; ++pr)
        if (pr < s) a += pst[pr][kRows + r];
      rstd[i] = rsqrtf(a / float(p.cout) + kLnEps);
    }
  } else {
    cluster.sync();                       // the peers are done with this s_out
  }
  constexpr int NJ = CN / 32;             // columns a lane at most (a group of one)
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int rl = warp * RW + i, r = row0 + rl;
    const float mk = FUSED && p.mask != nullptr && r < p.m ? __ldg(p.mask + r) : 1.f;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = c_lo + lane + 32 * jj;
      if (r >= p.m || c >= c_hi) continue;
      float x = s_out[rl * C::kOutStride + c];
      float res = 0.f;
      if constexpr (FUSED) {
        if (ln)
          x = (x - mu[i]) * rstd[i] * __ldg(p.ln_scale + n0 + c) + __ldg(p.ln_bias + n0 + c);
        if (p.residual != nullptr) res = __ldg(p.residual + size_t(r) * p.cout + n0 + c);
      }
      p.out[size_t(r) * p.cout + n0 + c] = finish<FUSED>(p, x, res, mk);
    }
  }
}

template <int CN, bool FUSED>
__global__ void __launch_bounds__(kThreads, 2)
    spconv_fod_tc_kernel(const __grid_constant__ Params p) {
  using C = Cfg<CN>;
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_nlive, s_nmine, s_noff;  // s_nmine is read by the peers
  float* s_pipe = smem;                                    // kStages x stage
  float* s_stat = s_pipe + C::kStages * C::kStageFloats;  // 2 x 64 row statistics
  int* s_idx = reinterpret_cast<int*>(s_stat + 2 * kRows);  // kvol x 64
  unsigned* s_half = reinterpret_cast<unsigned*>(s_idx + p.kvol * kRows);  // kvol x 2
  int* s_list = reinterpret_cast<int*>(s_half + 2 * p.kvol);  // live offsets
  int* s_mine = s_list + p.kvol;          // live row tiles this rank scanned
  int* s_tiles = s_mine + kMaxClusterTiles;  // the cluster's live row tiles

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ns = p.n_split;
  const int rank = blockIdx.x % ns;       // = the CTA's rank in its (ns, 1, 1) cluster
  const int cl = blockIdx.x / ns;
  const int n0 = blockIdx.y * CN;
  const int ncols = min(CN, p.cout - n0);  // a multiple of 4
  const int tiles = (p.m + kRows - 1) / kRows;
  const int my_tiles = (tiles - cl + p.clusters - 1) / p.clusters;  // tile cl + i * G

  // 1. Scan: rank r takes the cluster's tiles i = r, r + ns, ...; a tile without an
  // input is written now (epilogue(0)); the live ones are listed.
  if (tid == 0) s_nmine = 0;
  __syncthreads();
  for (int i = rank; i < my_tiles; i += ns) {
    const int row0 = (cl + i * p.clusters) * kRows;
    bool any = false;
    for (int e = tid; e < p.kvol * kRows; e += kThreads) {
      const int r = row0 + (e % kRows);
      if (r < p.m) {
        const int idx = __ldg(p.inv + size_t(e / kRows) * p.m + r);
        any |= idx >= 0 && idx < p.n;
      }
    }
    if (__syncthreads_or(any)) {
      if (tid == 0) s_mine[s_nmine++] = i;
    } else {
      flush_solo<CN, FUSED>(p, nullptr, s_pipe, row0, n0, ncols, warp, lane);
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (ns > 1) {
    cluster.sync();                       // every rank's list is in place
  } else {
    __syncthreads();
  }
  if (tid == 0) {                         // the cluster's list, peers in rank order
    int n_live = 0;
    for (int pr = 0; pr < ns; ++pr) {
      const int* lst = ns > 1 ? cluster.map_shared_rank(s_mine, pr) : s_mine;
      const int cnt = ns > 1 ? *cluster.map_shared_rank(&s_nmine, pr) : s_nmine;
      for (int i = 0; i < cnt; ++i) s_tiles[n_live++] = lst[i];
    }
    s_nlive = n_live;
  }
  __syncthreads();
  const int n_live = s_nlive;

  const int wm = warp & 3, wn = warp >> 2;  // row group, column half
  const int g = lane >> 2, t = lane & 3;    // the mma fragments' group and thread
  const int wcols = ncols - wn * C::kWarpCols;  // columns of this warp's half in Cout
  const int n_chunks = (p.cin + kChunk - 1) / kChunk;

  // 2. Rounds over the live tiles: g_r = min(ns, left) tiles, one a group of ranks.
  int rounds = 0, stages_run = 0;         // for p.stats
  for (int done = 0; done < n_live;) {
    const int gr = min(ns, n_live - done);
    const int grp = rank * gr / ns;       // groups of contiguous ranks
    const int first = (grp * ns + gr - 1) / gr;
    const int s = (grp * ns + ns + gr - 1) / gr - first;
    const int q = rank - first;
    const int row0 = (cl + s_tiles[done + grp] * p.clusters) * kRows;
    // this rank's offsets k = q + j * s: their 64-row slices of inv, which row halves
    // hold an input, and the live ones listed in order
    const int n_mine = q < p.kvol ? (p.kvol - 1 - q) / s + 1 : 0;
    for (int j0 = 0; j0 < n_mine; j0 += kThreads / kRows) {
      const int j = j0 + tid / kRows, r = tid % kRows;
      int idx = -1;
      if (j < n_mine && row0 + r < p.m) {
        idx = __ldg(p.inv + size_t(q + j * s) * p.m + row0 + r);
        if (idx >= p.n) idx = -1;
      }
      const unsigned live = __ballot_sync(0xffffffffu, idx >= 0);
      if (j < n_mine) {
        s_idx[j * kRows + r] = idx;
        if (lane == 0) s_half[2 * j + (r >> 5)] = live;
      }
    }
    __syncthreads();
    if (warp == 0) {
      int count = 0;
      for (int j0 = 0; j0 < n_mine; j0 += 32) {
        const int j = j0 + lane;
        const bool live = j < n_mine && (s_half[2 * j] | s_half[2 * j + 1]) != 0u;
        const unsigned b = __ballot_sync(0xffffffffu, live);
        if (live) s_list[count + __popc(b & ((1u << lane) - 1u))] = j;
        count += __popc(b);
      }
      if (lane == 0) s_noff = count;
    }
    __syncthreads();
    const int n_steps = s_noff * n_chunks;
    ++rounds;
    stages_run += n_steps;

    auto load = [&](int st, int buf) {
      const int j = s_list[st / n_chunks];
      const int c0 = (st % n_chunks) * kChunk;
      const int kc = min(kChunk, p.cin - c0);
      const int kc8 = (kc + 7) & ~7;
      float* sa = s_pipe + buf * C::kStageFloats;
      float* sw = sa + kRows * kAStride;
      const int segs = kc8 / 4;           // 16-byte vectors a gathered row
      for (int e = tid; e < kRows * segs; e += kThreads) {
        const int r = e / segs, v = e - r * segs;
        const int src = s_idx[j * kRows + r];
        const bool ok = src >= 0 && 4 * v < kc;
        cp_async16(sa + r * kAStride + 4 * v,
                   ok ? p.feats + size_t(src) * p.cin + c0 + 4 * v : p.feats, ok ? 16 : 0);
      }
      const float* wk = p.w + (size_t(q + j * s) * p.cin + c0) * p.cout + n0;
      constexpr int wsegs = CN / 4;
      for (int e = tid; e < kc8 * wsegs; e += kThreads) {
        const int c = e / wsegs, v = e - c * wsegs;
        const bool ok = c < kc && 4 * v < ncols;
        cp_async16(sw + c * C::kWStride + 4 * v,
                   ok ? wk + size_t(c) * p.cout + 4 * v : p.w, ok ? 16 : 0);
      }
    };

    float acc[C::kNT][4];
#pragma unroll
    for (int i = 0; i < C::kNT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
    for (int st = 0; st < C::kStages - 1; ++st) {
      if (st < n_steps) load(st, st);
      cp_async_commit();
    }
    for (int st = 0; st < n_steps; ++st) {
      cp_async_wait<C::kStages - 2>();
      __syncthreads();                    // stage st landed; stage st - 1 is consumed
      const int nx = st + C::kStages - 1;
      if (nx < n_steps) load(nx, nx % C::kStages);
      cp_async_commit();
      const int kc = min(kChunk, p.cin - (st % n_chunks) * kChunk);
      const float* sw = s_pipe + (st % C::kStages) * C::kStageFloats + kRows * kAStride;
      const int j = s_list[st / n_chunks];
      const unsigned half = s_half[2 * j + (wm >> 1)] >> ((wm & 1) * 16);
      if ((half & 0xffffu) == 0u || wcols <= 0) continue;  // none of the warp's rows
      const float* sa = s_pipe + (st % C::kStages) * C::kStageFloats + wm * 16 * kAStride;
      mma_stage<CN>(acc, sa, sw + wn * C::kWarpCols, kc, g, t, wcols);
    }
    cp_async_wait<0>();
    __syncthreads();                      // the stages are free: the partial tile aliases them

    float* s_out = s_pipe;
    {
      const int r = wm * 16 + g;
#pragma unroll
      for (int nt = 0; nt < C::kNT; ++nt) {
        const int col = wn * C::kWarpCols + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(s_out + r * C::kOutStride + col) =
            make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(s_out + (r + 8) * C::kOutStride + col) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
    }
    if (gr == ns) {                       // every rank alone on its tile
      __syncthreads();
      flush_solo<CN, FUSED>(p, s_out, nullptr, row0, n0, ncols, warp, lane);
      __syncthreads();                    // s_out is read before the next round's loads
    } else {
      flush_group<CN, FUSED>(p, s_out, s_stat, row0, n0, ncols, first, s, q, warp, lane);
    }
    done += gr;
  }
  if (p.stats != nullptr && tid == 0) {
    if (stages_run > 0) atomicAdd(p.stats, 1);
    atomicAdd(p.stats + 1, stages_run);
    atomicMax(p.stats + 2, stages_run);
    atomicMax(p.stats + 3, rounds);
  }
  // peers may still read this CTA's lists, statistics or partial tile
  if (ns > 1) cluster.sync();
}

int pick_cn(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256;
}

template <int CN, bool FUSED>
cudaError_t launch(const Params& p, int cout_tiles, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  auto kernel = spconv_fod_tc_kernel<CN, FUSED>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem - 1024));
    if (err != cudaSuccess) return err;
    raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.clusters * p.n_split, cout_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 4 * smem_words<CN>(p.kvol);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool FUSED>
int dispatch(const Params& p, int cn, cudaStream_t st) {
  const int tiles = (p.m + kRows - 1) / kRows;
  if (p.n < 0 || p.cin < 4 || p.cin % 4 != 0 || p.kvol < 1 || p.kvol > kMaxKvol ||
      p.m < 1 || p.cout < 4 || p.cout % 4 != 0 || p.n_split < 1 || p.n_split > kMaxSplit || cn != pick_cn(p.cout) ||
      (FUSED && p.cout > kMaxCout) || p.clusters < 1 || p.clusters > tiles ||
      (tiles + p.clusters - 1) / p.clusters > kMaxClusterTiles)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(p.feats) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.w) % 16 != 0 ||
      (FUSED && p.bias != nullptr && reinterpret_cast<uintptr_t>(p.bias) % 16 != 0) ||
      (FUSED && p.residual != nullptr && reinterpret_cast<uintptr_t>(p.residual) % 16 != 0) ||
      reinterpret_cast<uintptr_t>(p.out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int cout_tiles = (p.cout + cn - 1) / cn;
  cudaError_t err;
  switch (cn) {
    case 32: err = launch<32, FUSED>(p, cout_tiles, st); break;
    case 64: err = launch<64, FUSED>(p, cout_tiles, st); break;
    case 128: err = launch<128, FUSED>(p, cout_tiles, st); break;
    default: err = launch<256, FUSED>(p, cout_tiles, st); break;
  }
  return (int)err;
}

}  // namespace

// feats (n, cin), inv (kvol, m) int32, w (kvol, cin, cout), out (m, cout); float32
// unless noted, contiguous, on the device, feats and w 16-byte aligned, cin and cout
// multiples of 4, kvol <= kMaxKvol.  The launch plan comes from spconv.py
// (plan_conv): cn columns a CTA (32, 64, 128, 256 by cout), clusters of n_split CTAs
// (1..8), `clusters` of them (at most the row tiles, each cluster at most
// kMaxClusterTiles of them).  stats, if not null, is 4 int32 counters that each CTA
// adds to at its end: CTAs that ran a pipeline stage, stages run (all CTAs), the
// most stages of one CTA, the most rounds of one cluster.  Returns a cudaError_t
// (0 = launched).
extern "C" int spconv_fod_tc(const float* feats, const int* inv, const float* w,
                             float* out, int n, int cin, int kvol, int m, int cout,
                             int n_split, int clusters, int cn, int* stats,
                             void* stream) {
  const Params p{feats, inv, w, nullptr, nullptr, nullptr, nullptr, nullptr, out,
                 n, cin, kvol, m, cout, 0, n_split, clusters, stats};
  return dispatch<false>(p, cn, static_cast<cudaStream_t>(stream));
}

// As spconv_fod_tc, plus the epilogue operands: bias, ln_scale, ln_bias (cout,),
// residual (m, cout), mask (m,) float; each may be null (= skipped), ln_scale and
// ln_bias together; bias, residual and out 16-byte aligned.  cout <= 256.
extern "C" int spconv_fod_fused_tc(const float* feats, const int* inv, const float* w,
                                   const float* bias, const float* ln_scale,
                                   const float* ln_bias, const float* residual,
                                   const float* mask, float* out, int n, int cin,
                                   int kvol, int m, int cout, int relu, int n_split,
                                   int clusters, int cn, int* stats, void* stream) {
  if ((ln_scale == nullptr) != (ln_bias == nullptr)) return (int)cudaErrorInvalidValue;
  const Params p{feats, inv, w, bias, ln_scale, ln_bias, residual, mask, out,
                 n, cin, kvol, m, cout, relu, n_split, clusters, stats};
  return dispatch<true>(p, cn, static_cast<cudaStream_t>(stream));
}
