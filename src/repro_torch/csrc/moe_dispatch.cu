// The MoE block's routing and dispatch for Hopper (sm_90a): the router's
// softmax, top-k, slot positions and aux loss in one launch, the token ->
// expert buffer, and the gate-weighted combine back.
//
// Replaces no Pallas kernel: the reference computes the whole block with
// jnp inside its jitted serve steps (src/repro/models/moe.py:44-112 under
// jax.jit in src/repro/launch/serve.py:75-76), where XLA fuses the routing
// glue.  The port's plain route (repro_torch/models/moe.py) runs it as some
// thirty eager ops a layer: the router's softmax, a sorting top-k, the
// gates' renormalisation, the aux loss's means and one-hot, an int64
// one-hot (g, n, e) scanned along n, a repeat_interleave of x, a
// scatter_add into a padded buffer that the experts' einsum then copies
// into e-major, and a gather, a where and an f32 upcast before the
// combine's einsum.  The router's f32 product and the experts' products
// stay torch products.
//
// What bounds them: latency and bytes.  The route reads the logits (g, sg,
// e) f32 and writes idx, gates, pos, keep and the inverse map, ~0.7 MB at
// granite's prefill (~0.2 us at 3.35 TB/s): its time is the chain of
// dependent steps (softmax, k rounds of argmax, the slots' ranks, the
// scan across tiles), so the design spreads it over many SMs.  The
// dispatch reads the tokens' rows and writes the (e, g, cap, d) buffer
// (63 MB at granite's prefill); the combine reads the kept rows of the
// experts' output and writes y.  None does more than a few operations a
// byte.
//
// What the design does:
//
// - moe_route_kernel: a block a tile of kRouteTokens tokens of one group,
//   a warp a token.  Tile ids come from a ticket taken when the block
//   starts, so a block waits only on tiles whose blocks already run.  The
//   warp computes the token's softmax as torch's CUDA softmax does for a
//   row of e <= 1024 (each lane takes experts lane + 32 i, the max and
//   the sum of expf(x - max) over its experts in i order, then xor
//   butterflies, then an IEEE division), so the probabilities are the
//   plain version's bits; then k rounds of warp argmax (ties to the lower
//   expert, as lax.top_k), the gates renormalised by their sum in rank
//   order.  The tile's slots (token order, top-1 before top-2) are ranked
//   among themselves by __match_any_sync and a shared scan of the warps'
//   per-expert counts, as moe_slots_kernel does.  The counts of the
//   group's earlier tiles come from a single-pass chained scan
//   (decoupled look-back): each tile publishes its per-expert counts as
//   one word an expert (status << 30 | count: 1 aggregate, 2 inclusive
//   prefix), and reads back a window of earlier tiles' words at once, a
//   thread a word, down to the first inclusive prefix of each expert.
//   pos = prefix + rank is the reference's cumsum(one_hot) - 1 at the
//   slot's expert (integers, no atomics on values that order matters
//   for).  A group's last tile fills the map's empty slots with -1.  The
//   aux loss's per-tile partials (an expert's probability sum in f64 in
//   token order, its top-1 count) are summed in tile order by the last
//   block to finish (a done ticket, as sumsq_kernel), which also returns
//   the tickets and every word to 0: a launch leaves the scratch as it
//   found it.  The same inputs give the same bits on every call.
// - moe_dispatch_kernel: a warp a buffer row, the token row copied in
//   16-byte vectors (where d, the strides and the pointers allow; one
//   element a lane otherwise), or zeros.  Each lane loads up to kCopy
//   vectors before it stores them, and the stores stream (st.global.cs):
//   together they take granite's prefill (3-KB rows) from 0.028 to 0.023
//   ms on an H100 SXM at 700 W, where either alone is no faster.  It writes either layout: the buffer's
//   storage order is the map's (e-major (e, g, cap) from moe_route, so
//   the experts' einsums batch it without a copy; group-major (g, e, cap)
//   from moe_slots).  -DMOE_DISPATCH_FORCE_PLAIN_COPY builds the copy
//   before that (one load a store, default stores), timed in turns.
// - moe_slots_kernel: a block a group, the slots of the router's idx
//   ranked tile by tile in one block (the route before moe_route_kernel).
// - moe_combine_kernel: a warp a token: for each of its k slots in order,
//   keep * gate * float(out_buf[g, expert, pos, :]) summed in f32 (an FMA a
//   term), rounded once to y's dtype.  out_buf is read by its strides (the
//   experts' einsum returns it e-major), so no copy precedes the launch.
//
// C interface (loaded with ctypes): moe_route, moe_slots, moe_dispatch and
// moe_combine return the cudaError_t of the launch, 0 on success.  Each
// kernel adds one to a device counter of its instance from one thread a
// launch, so a CUDA graph's replays are counted too; moe_dispatch_launches
// copies it to the host (a synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxExperts = 256;    // shared-memory counts: e at most
constexpr int kSlotsThreads = 1024; // moe_slots_kernel: threads a block, most
constexpr int kMaxWarps = kSlotsThreads / 32;
constexpr int kRowWarps = 8;        // dispatch / combine: rows a block
constexpr int kChunk = 4;           // combine: vectors a lane sums at once
#ifdef MOE_DISPATCH_FORCE_PLAIN_COPY
constexpr int kCopy = 1;            // dispatch: vectors a lane loads at once
#else
constexpr int kCopy = 8;
#endif
constexpr int kMaxDevices = 64;

// moe_route_kernel: tokens a tile (a warp each), the look-back window's
// words at most, the count bits of a published word
constexpr int kRouteTokens = 16;
constexpr int kRouteThreads = kRouteTokens * 32;
constexpr int kWindowWords = 4096;
constexpr unsigned kCountBits = 30;
constexpr unsigned kCountMask = (1u << kCountBits) - 1u;
constexpr unsigned kAggregate = 1u << kCountBits;
constexpr unsigned kInclusive = 2u << kCountBits;
constexpr int kRouteHeader = 16;    // scratch bytes: tile ticket, done ticket
constexpr int kBatch = 8;           // the last block's loads in flight

// instances: slots one (idx int64); dispatch, combine f32, bf16; route one
// (f32 logits)
__device__ unsigned long long g_slots_launches[1];
__device__ unsigned long long g_dispatch_launches[2];
__device__ unsigned long long g_combine_launches[2];
__device__ unsigned long long g_route_launches[1];

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// V elements of T: one 16-byte vector when V * sizeof(T) == 16, else one
template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// The scratch of a moe_route launch over `tiles` tiles of e experts: its
// state, the two tickets and a word an expert a tile (all zero between
// launches: every launch leaves them so), and apart from it the aux
// loss's partials (written before they are read; kept apart, so that no
// launch's partials lie where a later launch's words must be zero).
struct RouteScratch {
  unsigned* ticket;   // [0] tile ids, [1] tiles done
  unsigned* words;    // tiles x e
  double* psum;       // tiles x e
  int* pcount;        // tiles x e
};

__host__ __device__ inline long long route_state_bytes(long long tiles,
                                                       int e) {
  return kRouteHeader + 4 * tiles * e;
}

__host__ __device__ inline long long route_partial_bytes(long long tiles,
                                                         int e) {
  return 12 * tiles * e;
}

__host__ __device__ inline RouteScratch route_scratch(void* state,
                                                      void* partials,
                                                      long long tiles, int e) {
  RouteScratch s;
  s.ticket = static_cast<unsigned*>(state);
  s.words = reinterpret_cast<unsigned*>(static_cast<char*>(state) +
                                        kRouteHeader);
  s.psum = static_cast<double*>(partials);
  s.pcount = reinterpret_cast<int*>(s.psum + tiles * e);
  return s;
}

// Shared memory of a moe_route block: per-expert doubles and ints, the
// tile's probabilities, the counts / look-back window, then per-slot data.
struct RouteSmem {
  double* red;      // 2 x kRouteThreads: the last block's runs of partials
  double* term;     // e: the last block's me * ce an expert
  int* carry;       // e: the tile's slots an expert
  int* top1;        // e: the tile's top-1 slots an expert
  int* excl;        // e: the group's slots an expert before the tile
  int* done;        // e: 1 once excl is whole
  float* probs;     // kRouteTokens x e
  unsigned* win;    // max(warps x e counts, the look-back window's words)
  float* sgate;     // kRouteTokens x k: the picked probabilities
  int* lpos;        // kRouteTokens x k: each slot's rank in the tile
  uint8_t* sid;     // kRouteTokens x k: each slot's expert
};

__host__ __device__ inline int route_window(int e) {
  const int w = kWindowWords / e;
  return w < 1 ? 1 : (w > 32 ? 32 : w);
}

__host__ __device__ inline int route_win_words(int e) {
  const int a = kRouteTokens * e, b = route_window(e) * e;
  return a > b ? a : b;
}

// runs of tiles a thread of the last block sums an expert's partials over
__host__ __device__ inline int route_parts(int e) {
  const int p = kRouteThreads / e;
  return p < 1 ? 1 : (p > 32 ? 32 : p);
}

__host__ __device__ inline int route_smem_bytes(int e, int k) {
  return 8 * 2 * kRouteThreads + 8 * e + 4 * 4 * e + 4 * kRouteTokens * e +
         4 * route_win_words(e) +
         (4 + 4 + 1) * kRouteTokens * k;
}

__device__ inline RouteSmem route_smem(unsigned char* p, int e, int k) {
  RouteSmem s;
  s.red = reinterpret_cast<double*>(p);
  s.term = s.red + 2 * kRouteThreads;
  p += 8 * 2 * kRouteThreads + 8 * e;
  s.carry = reinterpret_cast<int*>(p);
  s.top1 = s.carry + e;
  s.excl = s.top1 + e;
  s.done = s.excl + e;
  s.probs = reinterpret_cast<float*>(s.done + e);
  s.win = reinterpret_cast<unsigned*>(s.probs + kRouteTokens * e);
  s.sgate = reinterpret_cast<float*>(s.win + route_win_words(e));
  s.lpos = reinterpret_cast<int*>(s.sgate + kRouteTokens * k);
  s.sid = reinterpret_cast<uint8_t*>(s.lpos + kRouteTokens * k);
  return s;
}

// One token's softmax and top k by the warp (lane `lane`): the
// probabilities into probs (e floats), the picked experts and
// probabilities into sid / sgate (k each, rank order), and idx and the
// renormalised gates of the token (k each) into global memory.
__device__ __forceinline__ void route_token(const float* __restrict__ row,
                                            int e, int k, int lane,
                                            float* probs, uint8_t* sid,
                                            float* sgate,
                                            long long* __restrict__ idx,
                                            float* __restrict__ gates) {
  constexpr int kIters = kMaxExperts / 32;
  const int iters = (e + 31) / 32;
  float v[kIters];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int x = lane + 32 * i;
    v[i] = (i < iters && x < e) ? row[x] : -INFINITY;
    m = m > v[i] ? m : v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, m, off);
    m = m < o ? o : m;
  }
  // each lane's exps summed in i order from 0, then the xor butterfly:
  // torch's warp softmax (an absent expert's exp is 0, which adds exactly)
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int x = lane + 32 * i;
    if (i < iters && x < e) {
      v[i] = expf(__fsub_rn(v[i], m));
      sum = __fadd_rn(sum, v[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int x = lane + 32 * i;
    if (i < iters && x < e) {
      v[i] = __fdiv_rn(v[i], sum);
      probs[x] = v[i];
    } else {
      v[i] = -INFINITY;    // never picked
    }
  }
  // k rounds of argmax: the larger probability, then the lower expert
  float total = 0.0f;
  for (int j = 0; j < k; ++j) {
    float bp = -INFINITY;
    int bx = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < kIters; ++i)
      if (v[i] > bp) {
        bp = v[i];
        bx = lane + 32 * i;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float op = __shfl_xor_sync(0xffffffffu, bp, off);
      const int ox = __shfl_xor_sync(0xffffffffu, bx, off);
      if (op > bp || (op == bp && ox < bx)) {
        bp = op;
        bx = ox;
      }
    }
#pragma unroll
    for (int i = 0; i < kIters; ++i)
      if (lane + 32 * i == bx) v[i] = -INFINITY;
    total = __fadd_rn(total, bp);
    if (lane == 0) {
      sid[j] = static_cast<uint8_t>(bx);
      sgate[j] = bp;
    }
  }
  __syncwarp();
  const float denom = fmaxf(total, 1e-9f);
  for (int j = lane; j < k; j += 32) {
    idx[j] = sid[j];
    gates[j] = __fdiv_rn(sgate[j], denom);
  }
}

// logits (groups x sg x e f32, contiguous) -> idx, gates (groups x sg x k),
// pos, keep (groups x n, n = sg * k), src (e x groups x cap: the token row
// within its group of each expert slot, or -1) and aux (a scalar);
// tiles_per_group = ceil(sg / kRouteTokens), a block a tile.
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const float* __restrict__ logits, int groups, int sg,
                     int e, int k, int cap, int tiles_per_group,
                     long long* __restrict__ idx, float* __restrict__ gates,
                     int* __restrict__ pos, uint8_t* __restrict__ keep,
                     int* __restrict__ src, float* __restrict__ aux,
                     void* state, void* partials) {
  extern __shared__ __align__(16) unsigned char route_shared[];
  const int tiles = groups * tiles_per_group;
  const RouteScratch rs = route_scratch(state, partials, tiles, e);
  const RouteSmem sm = route_smem(route_shared, e, k);
  __shared__ int tile_s, last_s, ndone_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    tile_s = tiles == 1 ? 0
                        : static_cast<int>(atomicAdd(&rs.ticket[0], 1u));
    ndone_s = 0;
  }
  for (int x = tid; x < e; x += kRouteThreads) {
    sm.carry[x] = 0;
    sm.top1[x] = 0;
    sm.excl[x] = 0;
    sm.done[x] = 0;
  }
  __syncthreads();
  const int tile = tile_s;
  const int gi = tile / tiles_per_group, ti = tile % tiles_per_group;
  const int t0 = ti * kRouteTokens;
  const int ntok = sg - t0 < kRouteTokens ? sg - t0 : kRouteTokens;
  const long long first = static_cast<long long>(gi) * sg + t0;   // token

  // --- each warp a token: softmax, top k, gates ---------------------------
  if (warp < ntok) {
    const long long t = first + warp;
    route_token(logits + t * e, e, k, lane, sm.probs + warp * e,
                sm.sid + warp * k, sm.sgate + warp * k, idx + t * k,
                gates + t * k);
  }
  __syncthreads();

  // --- the tile's slots ranked: warp matches, warps' counts scanned -------
  const int n_t = ntok * k;
  const unsigned lower = (1u << lane) - 1u;
  int* counts = reinterpret_cast<int*>(sm.win);      // [warp][expert]
  for (int base = 0; base < n_t; base += kRouteThreads) {
    for (int i = tid; i < kRouteTokens * e; i += kRouteThreads) counts[i] = 0;
    __syncthreads();
    const int s = base + tid;
    const int ex = s < n_t ? sm.sid[s] : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, ex);
    const int rank = __popc(peers & lower);
    if (ex >= 0 && rank == 0) counts[warp * e + ex] = __popc(peers);
    if (ex >= 0 && s % k == 0) atomicAdd(&sm.top1[ex], 1);
    __syncthreads();
    for (int x = tid; x < e; x += kRouteThreads) {
      int run = sm.carry[x];
      for (int w = 0; w < kRouteTokens; ++w) {
        const int c = counts[w * e + x];
        counts[w * e + x] = run;
        run += c;
      }
      sm.carry[x] = run;
    }
    __syncthreads();
    if (ex >= 0) sm.lpos[s] = counts[warp * e + ex] + rank;
    __syncthreads();
  }

  // --- the chained scan: publish, look back, publish the prefix -----------
  unsigned* mine = rs.words + static_cast<long long>(tile) * e;
  if (tiles_per_group > 1)
    for (int x = tid; x < e; x += kRouteThreads)
      st_relaxed(mine + x, (ti == 0 ? kInclusive : kAggregate) |
                               static_cast<unsigned>(sm.carry[x]));
  if (ti > 0) {
    const int window = route_window(e);
    const unsigned* group = rs.words +
        static_cast<long long>(gi) * tiles_per_group * e;
    for (int hi = ti; hi > 0;) {
      const int lo = hi - window > 0 ? hi - window : 0;
      for (int p = tid; p < (hi - lo) * e; p += kRouteThreads) {
        const int x = p % e;
        if (sm.done[x]) continue;
        const unsigned* w = group + static_cast<long long>(lo + p / e) * e + x;
        unsigned v = ld_relaxed(w);
        while (v == 0u) {
          __nanosleep(32);
          v = ld_relaxed(w);
        }
        sm.win[p] = v;
      }
      __syncthreads();
      for (int x = tid; x < e; x += kRouteThreads) {
        if (sm.done[x]) continue;
        int acc = sm.excl[x];
        for (int j = hi - 1; j >= lo; --j) {
          const unsigned v = sm.win[(j - lo) * e + x];
          acc += static_cast<int>(v & kCountMask);
          if ((v & ~kCountMask) == kInclusive) {
            sm.done[x] = 1;
            atomicAdd(&ndone_s, 1);
            break;
          }
        }
        sm.excl[x] = acc;
      }
      __syncthreads();
      if (ndone_s == e) break;
      hi = lo;
    }
    for (int x = tid; x < e; x += kRouteThreads)
      st_relaxed(mine + x, kInclusive | static_cast<unsigned>(sm.excl[x] +
                                                              sm.carry[x]));
  }

  // --- slot positions, keep, the inverse map ------------------------------
  const long long slot0 = first * k;
  for (int s = tid; s < n_t; s += kRouteThreads) {
    const int ex = sm.sid[s];
    const int p = sm.excl[ex] + sm.lpos[s];
    pos[slot0 + s] = p;
    keep[slot0 + s] = p < cap;
    if (p < cap)
      src[(static_cast<long long>(ex) * groups + gi) * cap + p] =
          t0 + s / k;
  }
  if (ti == tiles_per_group - 1)      // the group's totals: -1 past them
    for (int i = tid; i < e * cap; i += kRouteThreads) {
      const int x = i / cap, c = i % cap;
      if (c >= sm.excl[x] + sm.carry[x])
        src[(static_cast<long long>(x) * groups + gi) * cap + c] = -1;
    }

  // --- the aux loss: partials a tile, summed in tile order by the last ----
  const double count = static_cast<double>(groups) * sg;
  for (int x = tid; x < e; x += kRouteThreads) {
    double s = 0.0;
    for (int w = 0; w < ntok; ++w)
      s += static_cast<double>(sm.probs[w * e + x]);
    if (tiles == 1) {   // alone: the tile's partials are the totals
      sm.term[x] = (s / count) * (static_cast<double>(sm.top1[x]) / count);
    } else {
      rs.psum[static_cast<long long>(tile) * e + x] = s;
      rs.pcount[static_cast<long long>(tile) * e + x] = sm.top1[x];
    }
  }
  if (tiles == 1) {
    __syncthreads();
    if (tid == 0) {
      double acc = 0.0;
      for (int x = 0; x < e; ++x) acc += sm.term[x];
      *aux = static_cast<float>(static_cast<double>(e) * acc);
      atomicAdd(&g_route_launches[0], 1ull);
    }
    return;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(&rs.ticket[1], 1u) == static_cast<unsigned>(tiles - 1);
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // each expert's partials in `parts` runs of tiles, a thread a run, loads
  // in batches of kBatch; the runs then summed in order: a fixed order
  const int parts = route_parts(e);
  const int per = (tiles + parts - 1) / parts;
  for (int i = tid; i < parts * e; i += kRouteThreads) {
    const int x = i % e, lo = (i / e) * per;
    const int hi = lo + per < tiles ? lo + per : tiles;
    double p = 0.0, c = 0.0;
    for (int t = lo; t < hi; t += kBatch) {
      double pv[kBatch];
      int cv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (t + u < hi) {
          const long long at = static_cast<long long>(t + u) * e + x;
          pv[u] = __ldcg(rs.psum + at);
          cv[u] = __ldcg(rs.pcount + at);
        }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (t + u < hi) {
          p += pv[u];
          c += cv[u];
        }
    }
    sm.red[i] = p;
    sm.red[kRouteThreads + i] = c;
  }
  __syncthreads();
  for (int x = tid; x < e; x += kRouteThreads) {
    double p = 0.0, c = 0.0;
    for (int j = 0; j < parts; ++j) {
      p += sm.red[j * e + x];
      c += sm.red[kRouteThreads + j * e + x];
    }
    sm.term[x] = (p / count) * (c / count);
  }
  // every block has read its window: the words return to 0
  if (tiles_per_group > 1)
    for (long long i = tid; i < static_cast<long long>(tiles) * e;
         i += kRouteThreads)
      rs.words[i] = 0u;
  __syncthreads();
  if (tid == 0) {
    double acc = 0.0;
    for (int x = 0; x < e; ++x) acc += sm.term[x];
    *aux = static_cast<float>(static_cast<double>(e) * acc);
    rs.ticket[0] = 0u;
    rs.ticket[1] = 0u;
    atomicAdd(&g_route_launches[0], 1ull);
  }
}

__global__ void moe_slots_kernel(const long long* __restrict__ idx, int n,
                                 int k, int e, int cap, int* __restrict__ pos,
                                 uint8_t* __restrict__ keep,
                                 int* __restrict__ src) {
  __shared__ int counts[kMaxWarps * kMaxExperts];   // [warp][expert]
  __shared__ int carry[kMaxExperts];                // slots so far an expert
  const int g = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, warps = blockDim.x >> 5;
  idx += static_cast<long long>(g) * n;
  pos += static_cast<long long>(g) * n;
  keep += static_cast<long long>(g) * n;
  src += static_cast<long long>(g) * e * cap;
  for (int x = tid; x < e; x += blockDim.x) carry[x] = 0;
  const unsigned lower = (1u << lane) - 1u;
  for (int base = 0; base < n; base += blockDim.x) {
    for (int i = tid; i < warps * e; i += blockDim.x) counts[i] = 0;
    __syncthreads();
    const int slot = base + tid;
    int ex = -1;
    if (slot < n) {
      const long long id = idx[slot];
      ex = (id >= 0 && id < e) ? static_cast<int>(id) : -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, ex);
    const int rank = __popc(peers & lower);
    if (ex >= 0 && rank == 0) counts[warp * e + ex] = __popc(peers);
    __syncthreads();
    for (int x = tid; x < e; x += blockDim.x) {
      int run = carry[x];
      for (int w = 0; w < warps; ++w) {
        const int c = counts[w * e + x];
        counts[w * e + x] = run;
        run += c;
      }
      carry[x] = run;
    }
    __syncthreads();
    if (slot < n) {
      // an id outside [0, e) (top-k never gives one) takes no capacity
      const int p = ex >= 0 ? counts[warp * e + ex] + rank : -1;
      const bool kept = ex >= 0 && p < cap;
      pos[slot] = p;
      keep[slot] = kept;
      if (kept) src[ex * cap + p] = slot / k;
    }
    __syncthreads();   // the next tile clears the counts
  }
  for (int i = tid; i < e * cap; i += blockDim.x)
    if (i % cap >= carry[i / cap]) src[i] = -1;
  if (g == 0 && tid == 0) atomicAdd(&g_slots_launches[0], 1ull);
}

// A store of the experts' buffer: streamed (evict first) for 16-byte
// vectors, unless built with MOE_DISPATCH_FORCE_PLAIN_COPY.
template <typename Vt>
__device__ __forceinline__ void store_row(Vt* p, const Vt& v) {
#ifndef MOE_DISPATCH_FORCE_PLAIN_COPY
  if constexpr (sizeof(Vt) == 16) {
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
    return;
  }
#endif
  *p = v;
}

// buf row r (storage order) = x[gi, src[r], :], or zeros where src[r] is
// -1, where the row's group gi = (r / cap) % groups for an e-major buffer
// (e, g, cap, d), r / (e * cap) for a group-major one (g, e, cap, d); the
// map src lies in the buffer's order.  x's rows at strides (x_g, x_s)
// elements, unit stride along d.
__device__ __forceinline__ long long row_group(long long r, int groups,
                                               int cap, int ecap,
                                               int e_major) {
  return e_major ? (r / cap) % groups : r / ecap;
}

template <typename T, int V>
__global__ void moe_dispatch_kernel(T* __restrict__ buf,
                                    const T* __restrict__ x,
                                    const int* __restrict__ src,
                                    long long rows, int groups, int cap,
                                    int ecap, int e_major, int d,
                                    long long x_g, long long x_s, int inst) {
  using Vt = Vec<T, V>;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row < rows) {
    const int s = src[row];
    Vt* dst = reinterpret_cast<Vt*>(buf + row * d);
    const int vecs = d / V;
    if (s < 0) {
      Vt z;
#pragma unroll
      for (int j = 0; j < V; ++j) z.v[j] = from_f32<T>(0.0f);
      for (int c = lane; c < vecs; c += 32) store_row(dst + c, z);
    } else {
      const long long gi = row_group(row, groups, cap, ecap, e_major);
      const Vt* from = reinterpret_cast<const Vt*>(x + gi * x_g + s * x_s);
      for (int c0 = lane; c0 < vecs; c0 += 32 * kCopy) {
        Vt v[kCopy];
#pragma unroll
        for (int j = 0; j < kCopy; ++j)
          if (c0 + 32 * j < vecs) v[j] = from[c0 + 32 * j];
#pragma unroll
        for (int j = 0; j < kCopy; ++j)
          if (c0 + 32 * j < vecs) store_row(dst + c0 + 32 * j, v[j]);
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_dispatch_launches[inst], 1ull);
}

// y[t, :] = sum over j < k of keep * gates[t, j] * out[g, idx, pos, :] (f32,
// j in order), t = g * sg + s; out's rows at strides (o_g, o_e, o_c).
template <typename T, int V>
__global__ void moe_combine_kernel(T* __restrict__ y,
                                   const T* __restrict__ out,
                                   const long long* __restrict__ idx,
                                   const int* __restrict__ pos,
                                   const uint8_t* __restrict__ keep,
                                   const float* __restrict__ gates,
                                   long long tokens, int sg, int k, int e,
                                   int cap, int d, long long o_g,
                                   long long o_e, long long o_c, int inst) {
  using Vt = Vec<T, V>;
  const long long t =
      static_cast<long long>(blockIdx.x) * kRowWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t < tokens) {
    const T* group = out + (t / sg) * o_g;
    const long long first = t * k;
    const int vecs = d / V;
    Vt* dst = reinterpret_cast<Vt*>(y + t * d);
    for (int c0 = lane; c0 < vecs; c0 += 32 * kChunk) {
      float acc[kChunk][V];
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[c][i] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const long long ex = idx[first + j];
        const int p = pos[first + j];
        if (!keep[first + j] || ex < 0 || ex >= e || p < 0 || p >= cap)
          continue;
        const float gate = gates[first + j];
        const Vt* row = reinterpret_cast<const Vt*>(group + ex * o_e +
                                                    p * o_c);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int col = c0 + c * 32;
          if (col < vecs) {
            const Vt u = row[col];
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[c][i] = __fmaf_rn(gate, to_f32(u.v[i]), acc[c][i]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int col = c0 + c * 32;
        if (col < vecs) {
          Vt u;
#pragma unroll
          for (int i = 0; i < V; ++i) u.v[i] = from_f32<T>(acc[c][i]);
          dst[col] = u;
        }
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_combine_launches[inst], 1ull);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// 16-byte vectors of T where d and every stride (elements) are multiples of
// a vector and every pointer is 16-byte aligned
template <typename T>
bool vectorised(int d, long long s0, long long s1, long long s2,
                const void* a, const void* b) {
  constexpr int kPer = 16 / sizeof(T);
  return d % kPer == 0 && s0 % kPer == 0 && s1 % kPer == 0 &&
         s2 % kPer == 0 && aligned16(a) && aligned16(b);
}

unsigned blocks_for(long long rows) {
  return static_cast<unsigned>((rows + kRowWarps - 1) / kRowWarps);
}

int device_index() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return -1;
  return dev;
}

// Raise `kernel`'s dynamic shared memory limit on this device to `bytes`
// once (a launch above 48 KB needs it); false if the call failed.
bool allow_smem(const void* kernel, int bytes, int* set) {
  const int dev = device_index();
  if (dev < 0) return false;
  if (bytes <= 48 * 1024 || set[dev] >= bytes) return true;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return false;
  set[dev] = bytes;
  return true;
}

template <typename T>
cudaError_t launch_dispatch(void* buf, const void* x, const int* src,
                            int groups, int e, int cap, int d, int e_major,
                            long long x_g, long long x_s, int inst,
                            cudaStream_t s) {
  const long long rows = static_cast<long long>(groups) * e * cap;
  T* b = static_cast<T*>(buf);
  const T* xt = static_cast<const T*>(x);
  if (vectorised<T>(d, x_g, x_s, 0, buf, x))
    moe_dispatch_kernel<T, 16 / sizeof(T)><<<blocks_for(rows),
                                             kRowWarps * 32, 0, s>>>(
        b, xt, src, rows, groups, cap, e * cap, e_major, d, x_g, x_s, inst);
  else
    moe_dispatch_kernel<T, 1><<<blocks_for(rows), kRowWarps * 32, 0, s>>>(
        b, xt, src, rows, groups, cap, e * cap, e_major, d, x_g, x_s, inst);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(void* y, const void* out, const long long* idx,
                           const int* pos, const uint8_t* keep,
                           const float* gates, int groups, int sg, int k,
                           int e, int cap, int d, long long o_g,
                           long long o_e, long long o_c, int inst,
                           cudaStream_t s) {
  const long long tokens = static_cast<long long>(groups) * sg;
  T* yt = static_cast<T*>(y);
  const T* o = static_cast<const T*>(out);
  if (vectorised<T>(d, o_g, o_e, o_c, y, out))
    moe_combine_kernel<T, 16 / sizeof(T)><<<blocks_for(tokens),
                                            kRowWarps * 32, 0, s>>>(
        yt, o, idx, pos, keep, gates, tokens, sg, k, e, cap, d, o_g, o_e,
        o_c, inst);
  else
    moe_combine_kernel<T, 1><<<blocks_for(tokens), kRowWarps * 32, 0, s>>>(
        yt, o, idx, pos, keep, gates, tokens, sg, k, e, cap, d, o_g, o_e,
        o_c, inst);
  return cudaGetLastError();
}

}  // namespace

// Bytes of moe_route's state (part 0: zero between launches) and of its
// partials (part 1) for `groups` groups of sg tokens and e experts (the
// wrapper allocates both); -1 on a bad argument.
extern "C" long long moe_route_scratch_bytes(int groups, int sg, int e,
                                             int part) {
  if (groups < 1 || sg < 1 || e < 1 || part < 0 || part > 1) return -1;
  const long long tiles = static_cast<long long>(groups) *
                          ((sg + kRouteTokens - 1) / kRouteTokens);
  return part ? route_partial_bytes(tiles, e) : route_state_bytes(tiles, e);
}

// idx (groups x sg x k int64), gates (groups x sg x k f32), pos (groups x n
// int32), keep (groups x n bytes), src (e x groups x cap int32) and aux (an
// f32 scalar) of the router's logits (groups x sg x e f32, contiguous).
// state: the part-0 bytes of moe_route_scratch_bytes, all 0 at the launch
// (as every launch leaves them) unless zero_first sets them to 0 first (a
// memset on the stream: for a state taken inside a CUDA graph capture);
// partials: the part-1 bytes, any contents.
extern "C" int moe_route(const float* logits, int groups, int sg, int e,
                         int k, int cap, long long* idx, float* gates,
                         int* pos, uint8_t* keep, int* src, float* aux,
                         void* state, long long state_bytes, void* partials,
                         long long partial_bytes, int zero_first,
                         void* stream) {
  static int smem_set[kMaxDevices] = {0};
  if (groups < 1 || sg < 1 || k < 1 || k > e || e > kMaxExperts ||
      cap < 1 || static_cast<long long>(sg) * k > kCountMask || !logits ||
      !idx || !gates || !pos || !keep || !src || !aux || !state ||
      !partials)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tpg = (sg + kRouteTokens - 1) / kRouteTokens;
  const long long tiles = static_cast<long long>(groups) * tpg;
  if (tiles > 0x7fffffffLL || state_bytes < route_state_bytes(tiles, e) ||
      partial_bytes < route_partial_bytes(tiles, e))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (zero_first) {
    const cudaError_t err =
        cudaMemsetAsync(state, 0, route_state_bytes(tiles, e), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int smem = route_smem_bytes(e, k);
  if (!allow_smem(reinterpret_cast<const void*>(moe_route_kernel), smem,
                  smem_set))
    return static_cast<int>(cudaErrorInvalidValue);
  moe_route_kernel<<<static_cast<unsigned>(tiles), kRouteThreads, smem, s>>>(
      logits, groups, sg, e, k, cap, tpg, idx, gates, pos, keep, src, aux,
      state, partials);
  return static_cast<int>(cudaGetLastError());
}

// pos (groups x n int32), keep (groups x n bytes, 0 or 1) and src (groups x
// e x cap int32) of idx (groups x n int64, n = sg * k, contiguous).
extern "C" int moe_slots(const long long* idx, int groups, int n, int k,
                         int e, int cap, int* pos, uint8_t* keep, int* src,
                         void* stream) {
  if (groups < 1 || n < 1 || k < 1 || k > e || e > kMaxExperts || cap < 1 ||
      n % k || !idx || !pos || !keep || !src)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = (n + 31) / 32 < kMaxWarps ? (n + 31) / 32 : kMaxWarps;
  moe_slots_kernel<<<groups, warps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(idx, n, k, e, cap,
                                                          pos, keep, src);
  return static_cast<int>(cudaGetLastError());
}

// buf (groups * e * cap rows of d, contiguous) from x (groups x sg x d at
// strides x_g, x_s elements, unit stride along d) and a map src in the
// buffer's storage order (token rows below sg, or -1): e_major 1 for an
// (e, g, cap) order, 0 for (g, e, cap).
extern "C" int moe_dispatch(void* buf, const void* x, const int* src,
                            int groups, int e, int cap, int d, long long x_g,
                            long long x_s, int e_major, int bf16,
                            void* stream) {
  if (groups < 1 || e < 1 || cap < 1 || d < 1 || !buf || !x || !src)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dispatch<__nv_bfloat16>(buf, x, src, groups, e, cap, d,
                                            e_major, x_g, x_s, 1, s)
           : launch_dispatch<float>(buf, x, src, groups, e, cap, d, e_major,
                                    x_g, x_s, 0, s);
  return static_cast<int>(err);
}

// y (groups x sg x d, contiguous, out's dtype) from out (groups x e x cap x
// d at strides o_g, o_e, o_c elements, unit stride along d), idx and gates
// (groups x sg x k, int64 and f32, contiguous), pos and keep of moe_route
// or moe_slots.
extern "C" int moe_combine(void* y, const void* out, const long long* idx,
                           const int* pos, const uint8_t* keep,
                           const float* gates, int groups, int sg, int k,
                           int e, int cap, int d, long long o_g,
                           long long o_e, long long o_c, int bf16,
                           void* stream) {
  if (groups < 1 || sg < 1 || k < 1 || e < 1 || cap < 1 || d < 1 || !y ||
      !out || !idx || !pos || !keep || !gates)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_combine<__nv_bfloat16>(y, out, idx, pos, keep, gates,
                                           groups, sg, k, e, cap, d, o_g,
                                           o_e, o_c, 1, s)
           : launch_combine<float>(y, out, idx, pos, keep, gates, groups, sg,
                                   k, e, cap, d, o_g, o_e, o_c, 0, s);
  return static_cast<int>(err);
}

// The device's count of launches of kernel 0 (slots), 1 (dispatch), 2
// (combine) or 3 (route), instance `instance`; ~0 on a bad argument or a
// failed copy.
extern "C" unsigned long long moe_dispatch_launches(int kernel,
                                                    int instance) {
  static const int kInstances[4] = {1, 2, 2, 1};
  if (kernel < 0 || kernel > 3 || instance < 0 ||
      instance >= kInstances[kernel])
    return ~0ull;
  unsigned long long n = 0;
  const size_t off = instance * sizeof(n);
  cudaError_t err;
  switch (kernel) {
    case 0:
      err = cudaMemcpyFromSymbol(&n, g_slots_launches, sizeof(n), off);
      break;
    case 1:
      err = cudaMemcpyFromSymbol(&n, g_dispatch_launches, sizeof(n), off);
      break;
    case 2:
      err = cudaMemcpyFromSymbol(&n, g_combine_launches, sizeof(n), off);
      break;
    default:
      err = cudaMemcpyFromSymbol(&n, g_route_launches, sizeof(n), off);
  }
  return err == cudaSuccess ? n : ~0ull;
}
