// One-token decode attention for Hopper (sm_90a): one new query a sequence
// against the layer's KV cache, read where it lies; GQA, sliding window,
// tanh logit soft-cap; f32 or bf16 cache, f32 math and output.
//
// Replaces no Pallas kernel: the reference computes this function with jnp
// inside its jitted decode step (src/repro/models/attention.py:149
// decode_attention and :182 decode_cross_attention, compiled by
// jax.jit(make_decode_step(cfg)), src/repro/launch/serve.py:76), where XLA
// may fuse the cache's f32 conversion into the products.  Same function:
// score = (q . k) / sqrt(D) in f32, then cap * tanh(score / cap), rows
// outside [max(0, pos - window + 1), pos] left out (or every row, for
// whisper's cross-attention, which attends its zero rows too), an f32
// softmax and the f32 sum of P V.  The scale is a product with 1 / sqrt(D),
// the exponentials are ex2.approx (__expf) and the cap's tanh is computed
// from one exponential: each within a few 1e-7 to 1e-6 of the division,
// expf and tanhf, which were slower at every serve shape.
//
// Bound.  A call reads the visible K and V rows once: at gemma2-27b's
// global layer (B = 2, 16 kv heads, 8,208 rows, D = 128, bf16) 134.5 MB,
// 40 us at 3.35 TB/s, against G = 2 query heads a kv head, ~2 FLOP a byte:
// bytes bound every decode shape.  What the design does about it:
//
// - One block a (b, kv head, head chunk, split) serves every query head of
//   its chunk, so each K / V row is read once for the chunk (GQA by
//   index).  A group of more query heads than a block takes (8 on the
//   splitk routes, 16 on mma_bf16 at D <= 128) is cut into equal chunks,
//   one block a chunk, each reading the rows again; the wrapper picks them
//   (kernels/decode_attention.py head_chunks).
// - The splits of a (b, kv head, chunk) are one thread block cluster: the
//   number of splits (1..8) is fixed at launch from the shape and the
//   clusters that fit the card (the wrapper's rule, from
//   decode_attention_clusters), never from pos, so a CUDA graph's capture
//   serves every position.  Each block reads pos on the device, takes its
//   share of the visible rows (a whole number of row_align rows, so later
//   splits may be empty and write an empty partial: max -inf, sum 0), and
//   leaves its partial in its own shared memory; then each block of the
//   cluster reads every split's max and sum and its slice of every split's
//   partial output through distributed shared memory, combines them in
//   split order, and writes that slice.  One launch a call, no scratch in
//   device memory, no float atomics: the same bits on every run.
//
// Three routes, fixed by the wrapper before the launch (route(dtype,
// group, D)); the query has the cache's dtype:
//
// - mma_bf16 (bf16, D a multiple of 16; decode_attention_mma_kernel): the
//   tensor cores.  One producer warp keeps a ring of kMmaStages stages of
//   kMmaRows K and V rows filled by TMA (a 4-D map over the cache's (D, kv
//   heads, T, B) strides, boxes of 64 columns, 128-byte swizzle, passed as
//   __grid_constant__ so a captured graph keeps it), completion counted on
//   an mbarrier a stage; kMmaWarps consumer warps take 16-row m-tiles of
//   each stage.  The keys sit on M and the chunk's query heads on N (8 or
//   16, padded with zero heads): S^T = K q^T by mma.sync m16n8k16 from
//   ldmatrix fragments of K and q^T fragments kept in registers (at D =
//   256 read from shared memory), so a 16-row tile costs D / 16 products
//   a head block, where heads on M would pad G <= 8 heads to 16 rows.
//   bf16 x bf16 products are exact, so only the order of the f32 sums
//   differs from the plain version.
//   Scale, cap, mask and the online softmax stay in f32 registers (a
//   head's max over the tile by three xor shuffles).  P is f32 in the
//   reference, and one bf16 rounding would move the output by ~1e-3 of
//   |V|: it enters o^T += V^T P^T as a hi and a lo bf16 half (two
//   products against the same V^T fragment from ldmatrix.trans), each
//   moved from the C layout of S^T to the B layout of P^T by movmatrix.
//   The row sums stay f32.
// - splitk_bf16 (bf16 at other D; decode_attention_kernel): the CUDA
//   cores.  Each row is read in 16-byte vectors, TPR lanes a row (TPR =
//   D / 8 rounded up to a power of two, at least 4), 32 / TPR rows a warp
//   at a time, U rows a lane stream for K and for V, the next U loaded
//   before this U's arithmetic; the dot product is reduced over the TPR
//   lanes of its row by xor shuffles, and each row group of a warp keeps
//   its own online softmax, combined at the end over the warp's row groups
//   (shuffles) and the block's warps (shared memory).
// - splitk_f32 (f32 caches, the smoke configs): the same with one row a
//   stream at a time.
//
// C interface (loaded with ctypes): decode_attention(...) returns the
// cudaError_t of the launch, 0 on success.  Each launch adds one to a
// device counter of its route (one thread of block (0, 0, 0)), so the
// launches of a CUDA graph's replays are counted too;
// decode_attention_launches(route) copies it to the host (a synchronous
// copy: call it outside a capture).  decode_attention_clusters(route, D,
// heads, splits) is cudaOccupancyMaxActiveClusters of the instance a
// launch at that shape would use: how many clusters of `splits` blocks
// the card keeps resident at once; decode_attention_rows_in_flight(route,
// D, heads) the K / V rows one of its blocks keeps in flight.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace cg = cooperative_groups;

#ifndef DECODE_MMA_ROWS
#define DECODE_MMA_ROWS 64
#endif
#ifndef DECODE_MMA_STAGES
#define DECODE_MMA_STAGES 2
#endif
#ifndef DECODE_MMA_WARPS
#define DECODE_MMA_WARPS 4
#endif

namespace {

constexpr int kWarps = 4;       // splitk: 8 were slower at most serve shapes
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxGroup = 8;    // splitk: query heads a block
constexpr int kMaxHeadDim = 256;
// mma_bf16: K / V rows a ring stage, stages, consumer warps (tune.py
// --decode times other choices)
constexpr int kMmaRows = DECODE_MMA_ROWS;
constexpr int kMmaStages = DECODE_MMA_STAGES;
constexpr int kMmaWarps = DECODE_MMA_WARPS;
constexpr int kMmaThreads = (kMmaWarps + 1) * 32;   // + the producer warp
static_assert(kMmaRows % 16 == 0 && kMmaRows <= 256, "rows: 16..256");
static_assert(kMmaStages >= 2, "at least two stages");

enum Route { kF32, kBf16, kMma, kRoutes };
__device__ unsigned long long g_launches[kRoutes];

struct Params {
  const void* q;
  const void* k;
  const void* v;
  float* out;
  const long long* pos;
  int T, Hq, Hkv, G, D;
  int chunks, Gb;                 // a group's chunks, query heads a chunk
  long long q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int window, all_rows, splits, row_align;
  float cap, sqrt_d;
};

// 8 consecutive elements of a row, as loaded: 16 bytes of bf16, 32 of f32.
template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  uint32_t w[8];
  __device__ __forceinline__ void load(const float* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = 0;
  }
  __device__ __forceinline__ float at(int i) const {
    return __uint_as_float(w[i]);
  }
};

template <>
struct Vec8<__nv_bfloat16> {
  uint32_t w[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = 0;
  }
  // element 2j is the low half of word j (little-endian): bf16 -> f32 is
  // the 16 bits moved to the top
  __device__ __forceinline__ float at(int i) const {
    const uint32_t x = w[i >> 1];
    return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// exp(a - m) for a partial whose max is a, -inf for an empty one.
// (ex2.approx: within 2 + 1.16 |a - m| units in the last place, a few
// 1e-6 of a probability: the order of the sums moves the output as much)
__device__ __forceinline__ float rescale(float a, float m) {
  return a == -INFINITY ? 0.f : __expf(a - m);
}

// cap * tanh(d * inv_cap) as (1 - t) / (1 + t) with t = exp(-2 |x|): a
// few 1e-7 of cap off tanhf, at a tenth of its instructions
__device__ __forceinline__ float cap_score(float d, float cap, float inv_cap) {
  const float x = d * inv_cap;
  const float t = __expf(-2.f * fabsf(x));
  return cap * copysignf(__fdividef(1.f - t, 1.f + t), x);
}

// This block's rows [r0, r1) of the visible rows [lo, hi], read from pos on
// the device; r1 <= r0 for an empty split.
__device__ __forceinline__ void split_rows(const Params& p, int split,
                                           int& r0, int& r1) {
  int lo = 0, hi = p.T - 1;
  if (!p.all_rows) {
    const long long pos = *p.pos;
    hi = static_cast<int>(min(pos, static_cast<long long>(p.T - 1)));
    if (p.window > 0)
      lo = static_cast<int>(max(0ll, pos - p.window + 1));
  }
  const int n = hi - lo + 1;
  const int per = ((n + p.splits - 1) / p.splits + p.row_align - 1) /
                  p.row_align * p.row_align;
  r0 = lo + split * per;
  r1 = min(r0 + per, hi + 1);
}

// The block's partial (max, sum, G x D output) from its W warps' partials,
// combined in warp order; the caller has synchronised after their writes.
template <int W, int GM, int DM>
__device__ __forceinline__ void combine_warps(
    const float (*warp_acc)[GM][DM], const float (*warp_m)[GM],
    const float (*warp_l)[GM], float (*part_acc)[DM], float* part_m,
    float* part_l, int G, int D) {
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, warp_m[w][g]);
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float f = rescale(warp_m[w][g], mx);
      a += warp_acc[w][g][d] * f;
      s += warp_l[w][g] * f;
    }
    part_acc[g][d] = a;
    if (d == 0) {
      part_m[g] = mx;
      part_l[g] = s;
    }
  }
}

// The chunk's G x D outputs at `out` from the partials of its splits, the
// blocks of one cluster: each block reads every split's max and sum
// (distributed shared memory) and weighs the splits in split order, then
// combines its own slice of the outputs from every split's partial.
template <int GM, int DM>
__device__ __forceinline__ void store_combined(
    float (*part_acc)[DM], float* part_m, float* part_l, float* out, int G,
    int D, int splits) {
  if (splits == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += blockDim.x)
      out[i] = part_acc[i / D][i % D] / part_l[i / D];
    return;
  }
  __shared__ float weight[kMaxSplits][GM], total[GM];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float pm[kMaxSplits], pl[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      pm[r] = r < splits ? *cluster.map_shared_rank(&part_m[g], r)
                         : -INFINITY;
      pl[r] = r < splits ? *cluster.map_shared_rank(&part_l[g], r) : 0.f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) mx = fmaxf(mx, pm[r]);
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      weight[r][g] = rescale(pm[r], mx);
      sum += pl[r] * weight[r][g];
    }
    total[g] = sum;
  }
  __syncthreads();
  const int slice = (G * D + splits - 1) / splits;
  const int first = static_cast<int>(cluster.block_rank()) * slice;
  const int last = min(first + slice, G * D);
  for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < splits)
        a += *cluster.map_shared_rank(&part_acc[g][d], r) * weight[r][g];
    out[i] = a / total[g];
  }
  cluster.sync();   // the partials stay until every block has read them
}

// ------------------------------------------------------ splitk routes

template <typename T, int TPR, int GM>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const Params p) {
  constexpr int RPW = 32 / TPR;                    // rows a warp reads at once
  constexpr int U = sizeof(T) == 4 ? 1 : (GM == kMaxGroup ? 2 : 4);
  constexpr int RB = kWarps * RPW * U;             // rows a block iteration
  constexpr int DM = TPR * 8;                      // head dim bound
  __shared__ float warp_acc[kWarps][GM][DM];
  __shared__ float warp_m[kWarps][GM], warp_l[kWarps][GM];
  __shared__ float part_acc[GM][DM];
  __shared__ float part_m[GM], part_l[GM];

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.chunks;
  const int g0 = blockIdx.y % p.chunks * p.Gb;     // the chunk's first head
  const int h0 = kvh * p.G + g0;                   // ... among all q heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane / TPR, c = lane % TPR;
  const int G = min(p.Gb, p.G - g0), D = p.D;      // this block's heads
  const bool live = c * 8 < D;                     // lanes past D only reduce
  if (threadIdx.x == 0 && split == 0 && blockIdx.y == 0 && b == 0)
    atomicAdd(&g_launches[sizeof(T) == 4 ? kF32 : kBf16], 1ull);

  int r0, r1;
  split_rows(p, split, r0, r1);

  float q[GM][8];
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb;
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[g][e] = (g < G && live)
                    ? to_float(qp[(h0 + g) * p.q_sh + c * 8 + e])
                    : 0.f;

  float m[GM], l[GM], acc[GM][8];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  const float scale = 1.f / p.sqrt_d;
  const float inv_cap = p.cap != 0.f ? 1.f / p.cap : 0.f;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh + c * 8;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh + c * 8;
  // K and V of the U rows of this lane's stream at ``base``: the next
  // iteration's are loaded before this one's arithmetic, so two sets are
  // in flight while a warp waits
  Vec8<T> kr[U], vr[U];
  auto load = [&](int base) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = base + (u * kWarps + warp) * RPW + rg;
      if (row < r1 && live) {
        kr[u].load(kb + row * p.k_st);
        vr[u].load(vb + row * p.v_st);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
  };
  if (r0 < r1) load(r0);
  for (int base = r0; base < r1; base += RB) {
    Vec8<T> kc[U], vc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kr[u];
      vc[u] = vr[u];
    }
    if (base + RB < r1) load(base + RB);
    float s[U][GM];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + (u * kWarps + warp) * RPW + rg < r1;
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d = fmaf(q[g][e], kc[u].at(e), d);
#pragma unroll
        for (int off = 1; off < TPR; off <<= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        d = d * scale;
        if (p.cap != 0.f) d = cap_score(d, p.cap, inv_cap);
        s[u][g] = ok ? d : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      if (mx == -INFINITY) continue;              // no row of this stream yet
      const float corr = rescale(m[g], mx);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu = rescale(s[u][g], mx);
        l[g] += pu;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pu, vc[u].at(e), acc[g][e]);
      }
      m[g] = mx;
    }
  }

  // the warp's row groups, lane rg = 0 keeping the sum
#pragma unroll
  for (int off = TPR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float fa = rescale(m[g], mn), fb = rescale(mo, mn);
      l[g] = l[g] * fa + lo_ * fb;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * fa + ao * fb;
      }
      m[g] = mn;
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (live)
#pragma unroll
        for (int e = 0; e < 8; ++e) warp_acc[warp][g][c * 8 + e] = acc[g][e];
      if (c == 0) {
        warp_m[warp][g] = m[g];
        warp_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  combine_warps<kWarps, GM, DM>(warp_acc, warp_m, warp_l, part_acc, part_m,
                                part_l, G, D);
  store_combined<GM, DM>(part_acc, part_m, part_l,
                         p.out + (static_cast<long long>(b) * p.Hq + h0) * D,
                         G, D, p.splits);
}

// ------------------------------------------------------- mma_bf16 route

// Shared memory of the mma_bf16 kernel at head dim bound DM and GM = 8 NB
// query heads: the ring (stage s: K then V, each DM / 64 boxes of kMmaRows
// rows x 128 bytes, 128-byte swizzled), reused after the last stage for the
// warps' and the block's partials; at DM = 256 the chunk's q (16 rows, zero
// past its heads, rows padded by 8 elements), whose fragments would not fit
// the registers beside the output's; then a full and an empty mbarrier a
// stage.  The base is aligned to 1024 bytes at run time (the swizzle's
// atom), hence the slack.
template <int DM, int NB>
struct MmaSmem {
  static constexpr int GM = 8 * NB;
  static constexpr bool kQShared = DM > 128;
  static constexpr int kTile = DM / 64 * kMmaRows * 128;     // K or V a stage
  static constexpr int kRing = kMmaStages * 2 * kTile;
  static constexpr int kWarpAcc = kMmaWarps * GM * DM * 4;
  static constexpr int kPartAcc = kWarpAcc + 2 * kMmaWarps * GM * 4;
  static constexpr int kStats = kPartAcc + GM * DM * 4;     // part_m, part_l
  static constexpr int kCombine = kStats + 2 * GM * 4;
  static constexpr int kArea = kRing > kCombine ? kRing : kCombine;
  static constexpr int kQLd = DM + 8;
  static constexpr int kQ = kQShared ? 16 * kQLd * 2 : 0;
  static constexpr int kBytes = 1024 + kArea + kQ + 2 * kMmaStages * 8;
};

// A 16-byte chunk (8 bf16 at column c, a multiple of 8) of row r of a
// K or V stage: box c / 64, the swizzle's chunk (c / 8 % 8) ^ (r % 8).
__device__ __forceinline__ const tc::bf16* swizzled(const unsigned char* tile,
                                                    int r, int c) {
  return reinterpret_cast<const tc::bf16*>(
      tile + (c >> 6) * (kMmaRows * 128) + r * 128 +
      ((((c >> 3) & 7) ^ (r & 7)) << 4));
}

// Fragment layouts (tensor_core.cuh; g = lane / 4, t = lane % 4): of the
// 16-key m-tile's S^T (keys x the 8 heads of head block j) lane (g, t)
// holds s[j][0..3] = S^T[g][2t, 2t+1], S^T[g+8][2t, 2t+1]; of o^T (D x
// heads) o[j][kk][0..3] = o^T[16kk + g][8j + 2t, +1], o^T[16kk + g + 8][..].
template <int DM, int NB>
__global__ void __launch_bounds__(kMmaThreads)
    decode_attention_mma_kernel(const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const Params p) {
  using Smem = MmaSmem<DM, NB>;
  constexpr int GM = 8 * NB, KD = DM / 16, R = kMmaRows, ST = kMmaStages;
  constexpr int W = kMmaWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  tc::bf16* sq = reinterpret_cast<tc::bf16*>(base + Smem::kArea);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Smem::kArea + Smem::kQ);
  uint64_t* empty = full + ST;

  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / p.chunks;
  const int g0 = blockIdx.y % p.chunks * p.Gb;     // the chunk's first head
  const int h0 = kvh * p.G + g0;                   // ... among all q heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = min(p.Gb, p.G - g0), D = p.D;      // this block's heads
  if (threadIdx.x == 0 && split == 0 && blockIdx.y == 0 && b == 0)
    atomicAdd(&g_launches[kMma], 1ull);

  int r0, r1;
  split_rows(p, split, r0, r1);
  const int tiles = r0 < r1 ? (r1 - r0 + R - 1) / R : 0;

  const uint16_t* qp = static_cast<const uint16_t*>(p.q) + b * p.q_sb;
  if constexpr (Smem::kQShared) {
    uint16_t* sq16 = reinterpret_cast<uint16_t*>(sq);
    for (int i = threadIdx.x; i < 16 * D; i += blockDim.x) {
      const int head = i / D, d = i % D;
      sq16[head * Smem::kQLd + d] =
          head < G ? qp[(h0 + head) * p.q_sh + d] : uint16_t{0};
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  float m[NB][2], l[NB][2], o[NB][KD][4];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[j][c] = -INFINITY;
      l[j][c] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][kk][e] = 0.f;

  if (warp == W) {
    // the producer: stage s of tile i once every consumer warp has
    // released its previous tile (a fresh barrier passes parity 1)
    if (lane == 0) {
      const int boxes = (D + 63) / 64;
      const uint32_t bytes = 2 * boxes * R * 128;
      for (int i = 0; i < tiles; ++i) {
        const int s = i % ST;
        hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], bytes);
        unsigned char* kt = base + s * 2 * Smem::kTile;
        for (int j = 0; j < boxes; ++j) {
          hopper::tma_load_4d(kt + j * R * 128, &mk, &full[s], 64 * j, kvh,
                              r0 + i * R, b);
          hopper::tma_load_4d(kt + Smem::kTile + j * R * 128, &mv, &full[s],
                              64 * j, kvh, r0 + i * R, b);
        }
      }
    }
  } else {
    // q^T as the B operand of S^T = K q^T: b0 = q[8j + g][16kk + 2t, +1],
    // b1 = the same 8 columns on; zero past the chunk's heads (at DM = 256
    // read from shared memory at each use instead)
    constexpr int QK = Smem::kQShared ? 1 : KD;
    uint32_t qf[NB][QK][2];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int kk = 0; kk < QK; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int head = 8 * j + g, d = 16 * kk + 2 * t + 8 * h;
          const uint16_t* e = qp + (h0 + head) * p.q_sh + d;
          qf[j][kk][h] = !Smem::kQShared && head < G && 16 * kk < D
                             ? static_cast<uint32_t>(e[0]) |
                                   static_cast<uint32_t>(e[1]) << 16
                             : 0u;
        }
    const float scale = 1.f / p.sqrt_d;
    const float inv_cap = p.cap != 0.f ? 1.f / p.cap : 0.f;

    for (int i = 0; i < tiles; ++i) {
      const int s = i % ST;
      hopper::mbar_wait(&full[s], (i / ST) & 1);
      const unsigned char* kt = base + s * 2 * Smem::kTile;
      const unsigned char* vt = kt + Smem::kTile;
      for (int mt = warp; mt < R / 16; mt += W) {
        const int row = r0 + i * R + 16 * mt;       // the m-tile's first row
        if (row >= r1) break;
        float sc[NB][4];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (16 * kk >= D) break;
          uint32_t a[4];
          tc::ldmatrix_x4(a, swizzled(kt, 16 * mt + (lane & 15),
                                      16 * kk + (lane >> 4) * 8));
          if constexpr (Smem::kQShared) {
            uint32_t qb[4];                    // heads 0-7, then 8-15
            tc::load_b_nmajor(qb, sq, Smem::kQLd, 0, 16 * kk, lane);
            tc::mma_bf16(sc[0], a, qb[0], qb[1]);
          } else {
#pragma unroll
            for (int j = 0; j < NB; ++j)
              tc::mma_bf16(sc[j], a, qf[j][kk][0], qf[j][kk][1]);
          }
        }
        // scale, cap and mask, then each head's max over the 16 keys (its
        // values sit in the lanes of one t), the running max and sum, and
        // the weights p = exp(s - max)
        const bool ok[2] = {row + g < r1, row + g + 8 < r1};
        uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[j][e] * scale;
            if (p.cap != 0.f) x = cap_score(x, p.cap, inv_cap);
            sc[j][e] = ok[e >> 1] ? x : -INFINITY;
          }
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float mx = fmaxf(sc[j][c], sc[j][c + 2]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
            const float mn = fmaxf(m[j][c], mx);
            const float corr = rescale(m[j][c], mn);
            m[j][c] = mn;
            l[j][c] *= corr;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
              o[j][kk][c] *= corr;
              o[j][kk][c + 2] *= corr;
            }
            sc[j][c] = rescale(sc[j][c], mn);
            sc[j][c + 2] = rescale(sc[j][c + 2], mn);
            l[j][c] += sc[j][c] + sc[j][c + 2];
          }
          // P^T as the B operand of o^T += V^T P^T, hi + lo bf16: the
          // packed rows of S^T's fragment transposed (movmatrix) are
          // b0 = P[8j + g][keys 2t, +1], b1 = the keys 8 on
          uint32_t hi0, lo0, hi1, lo1;
          tc::pack_split_bf16(sc[j][0], sc[j][1], hi0, lo0);
          tc::pack_split_bf16(sc[j][2], sc[j][3], hi1, lo1);
          bh[j][0] = tc::movmatrix_trans(hi0);
          bh[j][1] = tc::movmatrix_trans(hi1);
          bl[j][0] = tc::movmatrix_trans(lo0);
          bl[j][1] = tc::movmatrix_trans(lo1);
        }
        // V^T fragments of the m-tile's keys: a[m][k] = V[key k][16kk + m]
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (16 * kk >= D) break;
          uint32_t a[4];
          tc::ldmatrix_x4_trans(
              a, swizzled(vt, 16 * mt + (lane & 7) + ((lane >> 4) << 3),
                          16 * kk + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            tc::mma_bf16(o[j][kk], a, bh[j][0], bh[j][1]);
            tc::mma_bf16(o[j][kk], a, bl[j][0], bl[j][1]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    // a head's sum over the lanes of its t (its max is theirs already)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          l[j][c] += __shfl_xor_sync(0xffffffffu, l[j][c], off);
  }

  // the ring is spent (every stage issued was waited for): its bytes hold
  // the warps' partials, then the block's
  float (*warp_acc)[GM][DM] = reinterpret_cast<float (*)[GM][DM]>(base);
  float (*warp_m)[GM] = reinterpret_cast<float (*)[GM]>(base + Smem::kWarpAcc);
  float (*warp_l)[GM] = warp_m + W;
  float (*part_acc)[DM] =
      reinterpret_cast<float (*)[DM]>(base + Smem::kPartAcc);
  float* part_m = reinterpret_cast<float*>(base + Smem::kStats);
  float* part_l = part_m + GM;
  __syncthreads();
  if (warp < W) {
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int head = 8 * j + 2 * t + c;
        if (g == 0) {
          warp_m[warp][head] = m[j][c];
          warp_l[warp][head] = l[j][c];
        }
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (16 * kk >= D) break;
          warp_acc[warp][head][16 * kk + g] = o[j][kk][c];
          warp_acc[warp][head][16 * kk + g + 8] = o[j][kk][c + 2];
        }
      }
  }
  __syncthreads();
  combine_warps<W, GM, DM>(warp_acc, warp_m, warp_l, part_acc, part_m,
                           part_l, G, D);
  store_combined<GM, DM>(part_acc, part_m, part_l,
                         p.out + (static_cast<long long>(b) * p.Hq + h0) * D,
                         G, D, p.splits);
}

// The TMA map of a bf16 cache (B, T, kv heads, D) with these element
// strides, as (D, kv heads, T, B) innermost first: boxes of 64 columns x 1
// head x kMmaRows rows x 1, 128-byte swizzle, zeros outside.
bool cache_map(CUtensorMap* map, const void* ptr, int B, int T, int Hkv,
               int D, long long sb, long long st, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)T,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kMmaRows, 1};
  return hopper::tensor_map_bf16(map, ptr, 4, dims, strides, box);
}

// ------------------------------------------------------------- dispatch

// The kernel instance of a route at head dim D and `heads` query heads a
// block, with its block size and dynamic shared memory; fn null if the
// route takes no such shape.
struct Instance {
  const void* fn;
  int threads, smem;
  int rows;            // K / V rows a block keeps in flight
};

// A splitk block keeps two sets of U rows a lane stream in flight.
template <typename T, int TPR, int GM>
Instance splitk_of() {
  constexpr int U = sizeof(T) == 4 ? 1 : (GM == kMaxGroup ? 2 : 4);
  return {(const void*)decode_attention_kernel<T, TPR, GM>, kWarps * 32, 0,
          2 * kWarps * (32 / TPR) * U};
}

template <typename T, int TPR>
Instance splitk_by_group(int heads) {
  if (heads <= 1) return splitk_of<T, TPR, 1>();
  if (heads <= 2) return splitk_of<T, TPR, 2>();
  if (heads <= 4) return splitk_of<T, TPR, 4>();
  if (heads <= kMaxGroup) return splitk_of<T, TPR, 8>();
  return {nullptr, 0, 0, 0};
}

template <typename T>
Instance splitk_instance(int D, int heads) {
  const int vecs = D / 8;
  if (vecs <= 4) return splitk_by_group<T, 4>(heads);
  if (vecs <= 8) return splitk_by_group<T, 8>(heads);
  if (vecs <= 16) return splitk_by_group<T, 16>(heads);
  return splitk_by_group<T, 32>(heads);
}

template <int DM, int NB>
Instance mma_of() {
  return {(const void*)decode_attention_mma_kernel<DM, NB>, kMmaThreads,
          MmaSmem<DM, NB>::kBytes, kMmaRows * kMmaStages};
}

// mma_bf16 takes D a multiple of 16, up to 16 heads at D <= 128 and 8
// above (two head blocks at D = 256 would not fit the registers)
Instance mma_instance(int D, int heads) {
  if (D % 16 || heads > (D <= 128 ? 16 : 8)) return {nullptr, 0, 0, 0};
  if (D <= 64) return heads <= 8 ? mma_of<64, 1>() : mma_of<64, 2>();
  if (D <= 128) return heads <= 8 ? mma_of<128, 1>() : mma_of<128, 2>();
  return mma_of<256, 1>();
}

Instance instance(int route, int D, int heads) {
  if (D < 8 || D > kMaxHeadDim || D % 8 || heads < 1)
    return {nullptr, 0, 0, 0};
  switch (route) {
    case kF32: return splitk_instance<float>(D, heads);
    case kBf16: return splitk_instance<__nv_bfloat16>(D, heads);
    case kMma: return mma_instance(D, heads);
    default: return {nullptr, 0, 0, 0};
  }
}

// A launch configuration of `in` on a grid of clusters of `splits` blocks
// along x (attr: storage for its one attribute).
cudaError_t configure(const Instance& in, dim3 grid, int splits,
                      cudaStream_t stream, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (in.smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        in.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, in.smem);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(in.threads);
  cfg->dynamicSmemBytes = in.smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = splits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// route: 0 splitk_f32, 1 splitk_bf16, 2 mma_bf16; the query heads of a kv
// head in `chunks` equal chunks, one block each.
extern "C" int decode_attention(
    const void* q, const void* k, const void* v, float* out,
    const long long* pos, int B, int T, int Hq, int Hkv, int D,
    long long q_sb, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int window, float cap, int all_rows, int splits, int row_align,
    int chunks, int route, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq < 1 || Hq % Hkv || splits < 1 ||
      splits > kMaxSplits || row_align < 1 || (!all_rows && !pos) ||
      chunks < 1 || chunks > Hq / Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, Gb = (G + chunks - 1) / chunks;
  const Instance in = instance(route, D, Gb);
  if (in.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, out, pos, T, Hq, Hkv, G, D, chunks, Gb,
           q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           window, all_rows, splits, row_align, cap,
           sqrtf(static_cast<float>(D))};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(in, dim3(splits, Hkv * chunks, B), splits,
                static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (route == kMma) {
    CUtensorMap mk, mv;
    if (!cache_map(&mk, k, B, T, Hkv, D, k_sb, k_st, k_sh) ||
        !cache_map(&mv, v, B, T, Hkv, D, v_sb, v_st, v_sh))
      return static_cast<int>(cudaErrorInvalidValue);
    void* args[] = {&mk, &mv, &p};
    err = cudaLaunchKernelExC(&cfg, in.fn, args);
  } else {
    void* args[] = {&p};
    err = cudaLaunchKernelExC(&cfg, in.fn, args);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// Clusters of `splits` blocks of the route's instance at (D, heads a block)
// that the card keeps resident at once; -1 if the route takes no such
// shape or the query fails.
extern "C" int decode_attention_clusters(int route, int D, int heads,
                                         int splits) {
  const Instance in = instance(route, D, heads);
  if (in.fn == nullptr || splits < 1 || splits > kMaxSplits) return -1;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  if (configure(in, dim3(splits), splits, nullptr, &cfg, &attr) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, in.fn, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

// K / V rows a block of the route's instance at (D, heads a block) keeps in
// flight (the ring's on mma_bf16); -1 if the route takes no such shape.
extern "C" int decode_attention_rows_in_flight(int route, int D, int heads) {
  const Instance in = instance(route, D, heads);
  return in.fn == nullptr ? -1 : in.rows;
}

extern "C" unsigned long long decode_attention_launches(int route) {
  if (route < 0 || route >= kRoutes) return ~0ull;
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n),
                           route * sizeof(n)) != cudaSuccess)
    return ~0ull;
  return n;
}
