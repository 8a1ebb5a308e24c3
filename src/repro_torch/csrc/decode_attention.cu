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
// - One block a (b, kv head, split) serves every query head of its group,
//   so each K / V row is read once for the whole group (GQA by index).  A
//   group of more than 8 query heads (command-r-plus-104b: 12) is cut into
//   equal chunks of at most 8, one block a chunk: each chunk reads the
//   rows again, and a block keeps at most 8 heads' q and output in
//   registers.
// - Each row is read in 16-byte vectors, TPR lanes a row (TPR = D / 8
//   rounded up to a power of two, at least 4), 32 / TPR rows a warp at a
//   time, U rows a lane stream for K and for V, the next U loaded before
//   this U's arithmetic (two sets in flight a lane).  A lane keeps its
//   8 elements of q for each query head in registers, the dot product is
//   reduced over the TPR lanes of its row by xor shuffles, and each row
//   group of a warp keeps its own online softmax (max, sum, 8 elements of
//   the f32 output a head), combined at the end over the warp's row groups
//   (shuffles), the block's warps (shared memory) and the splits, always in
//   the same order: the result is the same bits on every run.
// - The splits of a (b, kv head, chunk) are one thread block cluster: the number
//   of splits (1..8) is fixed at launch from B x kv heads, the group, the
//   SM count and the static row bound (min(T, window)), never from pos, so a CUDA
//   graph's capture serves every position.  Each block reads pos on the
//   device, takes its share of the visible rows (a whole number of
//   row_align rows, so later splits may be empty and write an empty
//   partial: max -inf, sum 0), and leaves its partial in its own shared
//   memory; then each block of the cluster reads every split's max and sum
//   and its slice of every split's partial output through distributed
//   shared memory, combines them in split order, and writes that slice.
//   One launch a call, no scratch in device memory, no float atomics.
//
// Two routes, fixed by the cache's dtype before the launch: f32 caches
// (splitk_f32, the smoke configs; one row a stream at a time) and bf16
// caches (splitk_bf16, the full-width models); the query has the cache's
// dtype.
//
// C interface (loaded with ctypes): decode_attention(...) returns the
// cudaError_t of the launch, 0 on success.  Each launch adds one to a
// device counter of its route (one thread of block (0, 0, 0)), so the
// launches of a CUDA graph's replays are counted too;
// decode_attention_launches(route) copies it to the host (a synchronous
// copy: call it outside a capture).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;       // 8 were slower at most serve shapes
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxGroup = 8;    // query heads a block
constexpr int kMaxHeadDim = 256;

enum Route { kF32, kBf16, kRoutes };
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

template <typename T, int TPR, int GM>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const Params p) {
  constexpr int kThreads = kWarps * 32;
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

  // the visible rows [lo, hi] and this split's share [r0, r1)
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
  const int r0 = lo + split * per;
  const int r1 = min(r0 + per, hi + 1);

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

  // the block's warps, in order
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, warp_m[w][g]);
    float a = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
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

  float* out = p.out + (static_cast<long long>(b) * p.Hq + h0) * D;
  if (p.splits == 1) {
    __syncthreads();
    for (int i = threadIdx.x; i < G * D; i += kThreads)
      out[i] = part_acc[i / D][i % D] / part_l[i / D];
    return;
  }
  // the cluster's splits, in split order: each block reads every split's
  // max and sum (distributed shared memory) and weighs the splits, then
  // combines its own slice of the G x D outputs from every split's partial
  __shared__ float weight[kMaxSplits][GM], total[GM];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float pm[kMaxSplits], pl[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      pm[r] = r < p.splits ? *cluster.map_shared_rank(&part_m[g], r)
                           : -INFINITY;
      pl[r] = r < p.splits ? *cluster.map_shared_rank(&part_l[g], r) : 0.f;
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
  const int slice = (G * D + p.splits - 1) / p.splits;
  const int first = static_cast<int>(cluster.block_rank()) * slice;
  const int last = min(first + slice, G * D);
  for (int i = first + threadIdx.x; i < last; i += kThreads) {
    const int g = i / D, d = i % D;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < p.splits)
        a += *cluster.map_shared_rank(&part_acc[g][d], r) * weight[r][g];
    out[i] = a / total[g];
  }
  cluster.sync();   // the partials stay until every block has read them
}

template <typename T, int TPR, int GM>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.Hkv * p.chunks, B);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<T, TPR, GM>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int TPR>
cudaError_t by_group(const Params& p, int B, cudaStream_t s) {
  if (p.Gb <= 1) return launch<T, TPR, 1>(p, B, s);
  if (p.Gb <= 2) return launch<T, TPR, 2>(p, B, s);
  if (p.Gb <= 4) return launch<T, TPR, 4>(p, B, s);
  return launch<T, TPR, 8>(p, B, s);
}

template <typename T>
cudaError_t by_head_dim(const Params& p, int B, cudaStream_t s) {
  const int vecs = p.D / 8;
  if (vecs <= 4) return by_group<T, 4>(p, B, s);
  if (vecs <= 8) return by_group<T, 8>(p, B, s);
  if (vecs <= 16) return by_group<T, 16>(p, B, s);
  return by_group<T, 32>(p, B, s);
}

}  // namespace

extern "C" int decode_attention(
    const void* q, const void* k, const void* v, float* out,
    const long long* pos, int B, int T, int Hq, int Hkv, int D,
    long long q_sb, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    int window, float cap, int all_rows, int splits, int row_align,
    int dtype, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || Hq < 1 || Hq % Hkv || D < 8 || D > kMaxHeadDim || D % 8 || splits < 1 ||
      splits > kMaxSplits || row_align < 1 || (!all_rows && !pos))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = Hq / Hkv, chunks = (G + kMaxGroup - 1) / kMaxGroup;
  Params p{q, k, v, out, pos, T, Hq, Hkv, G, D,
           chunks, (G + chunks - 1) / chunks,
           q_sb, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           window, all_rows, splits, row_align, cap, sqrtf(static_cast<float>(D))};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? by_head_dim<__nv_bfloat16>(p, B, s)
                                     : by_head_dim<float>(p, B, s);
  return static_cast<int>(err);
}

extern "C" unsigned long long decode_attention_launches(int route) {
  if (route < 0 || route >= kRoutes) return ~0ull;
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n),
                           route * sizeof(n)) != cudaSuccess)
    return ~0ull;
  return n;
}
