// The train step's fused update for Hopper (sm_90a): AdamW in one pass over
// a leaf, and the grads' sum of squares for the global-norm clip.
//
// Replaces no Pallas kernel: the reference computes both with jnp inside its
// jitted train step (src/repro/optim/adamw.py `adamw_update` and
// `clip_by_global_norm`, compiled by jax.jit in src/repro/launch/train.py),
// where XLA fuses the clip and the update into a few passes over the state.
// The port's plain versions (repro_torch/optim/adamw.py `_update_slice`,
// `global_norm`) run some twenty eager ops a slice, each writing an f32
// temporary: ~200 bytes a parameter for the update, ~18 for the norm.
//
// What bounds them: bytes.  The update reads p and g in their dtype and m, v
// in f32 once each, and writes p, m and v once (22 bytes a bf16 parameter,
// 28 an f32 one); the sum of squares reads g once (2 or 4 bytes).  Neither
// does more than a few operations a byte.
//
// What the design does: 16-byte vector loads (8 elements a thread a step:
// one vector of bf16, two of f32) with 64-bit offsets (a stacked leaf of
// codeqwen1.5-7b's MLP holds 0.88 B elements at 16 layers), the last n % 8
// elements one a thread, and a one-element path where a pointer is not
// 16-byte aligned.
//
// - adamw_update_kernel: a grid-stride loop over a leaf; the reference's
//   f32 ops in its order, each one
//   IEEE-rounded (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn cannot be
//   contracted into an FMA), so p, m and v equal the plain version's to the
//   bit: g * scale; b1 m + (1 - b1) g; b2 v + (1 - b2) g^2; m2 / c1;
//   v2 / c2; mh / (sqrt(vh) + eps) + wd p; p - lr delta; p rounded to its
//   dtype to nearest even.  lr, the clip scale and the bias corrections c1,
//   c2 are read from device memory, so the step makes no host synchronise
//   and a captured step replays them.  The outputs may be the inputs (the
//   donating form) or new tensors.
// - sumsq_kernel: one launch over every grad of a step (up to kSumsqLeaves
//   leaves, any mix of f32 and bf16; more split into launches of that many
//   in leaf order).  The leaf table (pointer, element count, dtype and
//   alignment flags, first chunk) is a by-value kernel parameter, so a
//   launch copies nothing from the host and a captured step can replay it.
//   Each leaf is cut into chunks of kChunkBytes (the last one shorter), a
//   block and a partial a chunk: per-thread f32 sums in the chunk's
//   stride order, a fixed shuffle tree a warp and the warps in index order.
//   The last block to finish (a ticket) sums the partials in chunk order
//   (thread t the groups of four t, t + 256, ..., then the tree) and adds
//   the launch's total to the running total of earlier launches of the
//   call.  Every sum has a fixed order that depends only on the leaves'
//   sizes, dtypes and order (not on the grid or the SM count), so a run
//   repeats itself to the bit.  The ticket returns to 0 at the end of each
//   launch, so a caller keeps one ticket a stream, zeroed once, and fills
//   nothing before a launch.  One launch a step in place of one a leaf:
//   small leaves (lm100m's 11) paid a launch, a grid and a ticket each.
//
// C interface (loaded with ctypes): adamw_update(...) and sumsq(...) return
// the cudaError_t of the launch, 0 on success.  Each launch adds one to a
// device counter of its instance (one thread a launch), so a CUDA graph's
// replays are counted too; optimizer_launches(kernel, instance) copies it to
// the host (a synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// A leaf of a sumsq launch, also in its C interface: flags bit 0 bf16,
// bit 1 16-byte aligned.
struct SumsqLeaf {
  const void* ptr;
  long long n;
  int first_chunk;   // its first chunk (block) in the launch
  int flags;
};

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements a thread a step (aligned)
constexpr int kBlocksPerSm = 8;      // adamw: the most resident at 256 threads
constexpr int kChunkBytes = 131072;  // sumsq: a chunk of a leaf, a partial
constexpr int kSumsqLeaves = 64;     // sumsq: leaves a launch (the table)
constexpr int kSumsqUnroll = 4;      // sumsq: vectors in flight a thread
constexpr int kMaxDevices = 64;

// instance ids: adamw (p bf16) * 2 + (g bf16); sumsq: 0 every leaf f32,
// 1 every leaf bf16, 2 both
__device__ unsigned long long g_adamw_launches[4];
__device__ unsigned long long g_sumsq_launches[3];

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

// V elements at src as f32: 16-byte loads when V > 1 (src aligned)
template <typename T, int V>
__device__ __forceinline__ void load(const T* src, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(src[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(V % kPer == 0, "whole 16-byte vectors");
#pragma unroll
    for (int c = 0; c < V / kPer; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(src)[c];
      T t[kPer];
      memcpy(t, &u, sizeof(u));
#pragma unroll
      for (int j = 0; j < kPer; ++j) x[c * kPer + j] = to_f32(t[j]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const float (&x)[V]) {
  if constexpr (V == 1) {
    dst[0] = from_f32<T>(x[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < V / kPer; ++c) {
      T t[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) t[j] = from_f32<T>(x[c * kPer + j]);
      uint4 u;
      memcpy(&u, t, sizeof(u));
      reinterpret_cast<uint4*>(dst)[c] = u;
    }
  }
}

struct AdamW {
  const float* lr;
  const float* scale;   // null: the grads come clipped (or unclipped)
  const float* c1;
  const float* c2;
  float b1, omb1, b2, omb2, eps, wd;   // omb = (1 - b) rounded once
};

// one element: the reference's f32 ops in its order, each IEEE-rounded
__device__ __forceinline__ void adamw_element(float& p, float g, float& m,
                                              float& v, const AdamW& a,
                                              float lr, float c1, float c2,
                                              float scale) {
  const float gj = a.scale ? __fmul_rn(g, scale) : g;
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, gj));
  const float v2 = __fadd_rn(__fmul_rn(a.b2, v),
                             __fmul_rn(a.omb2, __fmul_rn(gj, gj)));
  const float mh = __fdiv_rn(m2, c1);
  const float vh = __fdiv_rn(v2, c2);
  const float delta =
      __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps)),
                __fmul_rn(a.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, delta));
  m = m2;
  v = v2;
}

template <typename P, typename G, int V>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(P* p_out, const P* p, const G* g, float* m_out,
                        const float* m, float* v_out, const float* v,
                        long long n, AdamW a) {
  const long long groups = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (tid == 0)
    atomicAdd(&g_adamw_launches[(sizeof(P) == 2) * 2 + (sizeof(G) == 2)],
              1ull);
  const float lr = *a.lr, c1 = *a.c1, c2 = *a.c2;
  const float scale = a.scale ? *a.scale : 1.0f;
  for (long long i = tid; i < groups; i += stride) {
    const long long o = i * V;
    float pf[V], gf[V], mf[V], vf[V];
    load<P, V>(p + o, pf);
    load<G, V>(g + o, gf);
    load<float, V>(m + o, mf);
    load<float, V>(v + o, vf);
#pragma unroll
    for (int j = 0; j < V; ++j)
      adamw_element(pf[j], gf[j], mf[j], vf[j], a, lr, c1, c2, scale);
    store<P, V>(p_out + o, pf);
    store<float, V>(m_out + o, mf);
    store<float, V>(v_out + o, vf);
  }
  // the last n % V elements: one a thread of block 0
  if (blockIdx.x == 0 && groups * V + threadIdx.x < n) {
    const long long o = groups * V + threadIdx.x;
    float pf = to_f32(p[o]), mf = m[o], vf = v[o];
    adamw_element(pf, to_f32(g[o]), mf, vf, a, lr, c1, c2, scale);
    p_out[o] = from_f32<P>(pf);
    m_out[o] = mf;
    v_out[o] = vf;
  }
}

// thread 0's value: lanes by a fixed xor tree, then the warps in order
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = x;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s = __fadd_rn(s, warps[w]);
  __syncthreads();
  return s;
}

struct SumsqTable {
  SumsqLeaf leaf[kSumsqLeaves];
  int count;
};

// this thread's sum of squares over a chunk of m elements at g (V = 8: g
// 16-byte aligned): the groups of V elements t, t + kThreads, ... in
// order, then the last m % V elements one a thread
template <typename G, int V>
__device__ __forceinline__ float chunk_sumsq(const G* g, long long m) {
  const long long groups = m / V;
  float acc = 0.0f;
  for (long long i = threadIdx.x; i < groups;
       i += kSumsqUnroll * kThreads) {
    float x[kSumsqUnroll][V];
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (i + u * kThreads < groups) load<G, V>(g + (i + u * kThreads) * V,
                                                x[u]);
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (i + u * kThreads < groups)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc = __fadd_rn(acc, __fmul_rn(x[u][j], x[u][j]));
  }
  if (groups * V + threadIdx.x < m) {
    const float x = to_f32(g[groups * V + threadIdx.x]);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  return acc;
}

// One block a chunk (gridDim.x = the launch's chunks); partials: one float
// a chunk; ticket: 0 between launches; out: the total, replaced
// (accumulate 0) or added to.
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const __grid_constant__ SumsqTable table, float* partials,
                 unsigned* ticket, float* out, int accumulate, int route) {
  const int c = blockIdx.x;
  int i = 0;
  while (i + 1 < table.count && table.leaf[i + 1].first_chunk <= c) ++i;
  const SumsqLeaf& leaf = table.leaf[i];
  const bool bf16 = leaf.flags & 1, vec = leaf.flags & 2;
  const long long per = kChunkBytes / (bf16 ? 2 : 4);
  const long long o = static_cast<long long>(c - leaf.first_chunk) * per;
  const long long m = leaf.n - o < per ? leaf.n - o : per;
  float acc;
  if (bf16) {
    const auto* g = static_cast<const __nv_bfloat16*>(leaf.ptr) + o;
    acc = vec ? chunk_sumsq<__nv_bfloat16, kVec>(g, m)
              : chunk_sumsq<__nv_bfloat16, 1>(g, m);
  } else {
    const auto* g = static_cast<const float*>(leaf.ptr) + o;
    acc = vec ? chunk_sumsq<float, kVec>(g, m) : chunk_sumsq<float, 1>(g, m);
  }
  const float part = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[c] = part;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the partials in chunk order: groups of four, t + kThreads * k
  const int quads = gridDim.x / 4;
  const float4* p4 = reinterpret_cast<const float4*>(partials);
  float s = 0.0f;
  for (int q = threadIdx.x; q < quads; q += kSumsqUnroll * kThreads) {
    float4 x[kSumsqUnroll];
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (q + u * kThreads < quads) x[u] = __ldcg(p4 + q + u * kThreads);
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (q + u * kThreads < quads) {
        s = __fadd_rn(s, x[u].x);
        s = __fadd_rn(s, x[u].y);
        s = __fadd_rn(s, x[u].z);
        s = __fadd_rn(s, x[u].w);
      }
  }
  if (4 * quads + static_cast<int>(threadIdx.x) < static_cast<int>(gridDim.x))
    s = __fadd_rn(s, __ldcg(partials + 4 * quads + threadIdx.x));
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    *out = accumulate ? __fadd_rn(*out, total) : total;
    *ticket = 0u;
    atomicAdd(&g_sumsq_launches[route], 1ull);
  }
}

int sm_count() {
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

int grid_for(long long groups, long long most) {
  const long long want = (groups + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < most ? want : most));
}

template <typename P, typename G>
cudaError_t launch_adamw(void* p_out, const void* p, const void* g,
                         float* m_out, const float* m, float* v_out,
                         const float* v, long long n, const AdamW& a,
                         cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const bool vec = aligned(p_out) && aligned(p) && aligned(g) &&
                   aligned(m_out) && aligned(m) && aligned(v_out) &&
                   aligned(v);
  const long long groups = vec ? n / kVec : n;
  const int grid =
      grid_for(groups, static_cast<long long>(sms) * kBlocksPerSm);
  auto* po = static_cast<P*>(p_out);
  auto* pi = static_cast<const P*>(p);
  auto* gi = static_cast<const G*>(g);
  if (vec)
    adamw_update_kernel<P, G, kVec><<<grid, kThreads, 0, stream>>>(
        po, pi, gi, m_out, m, v_out, v, n, a);
  else
    adamw_update_kernel<P, G, 1><<<grid, kThreads, 0, stream>>>(
        po, pi, gi, m_out, m, v_out, v, n, a);
  return cudaGetLastError();
}

}  // namespace

// p_bf16 / g_bf16: 1 for bf16, 0 for f32; m, v f32.  The outputs may alias
// the inputs element for element (in place) and must not overlap otherwise.
// scale may be null (no clip factor).
extern "C" int adamw_update(void* p_out, const void* p, const void* g,
                            float* m_out, const float* m, float* v_out,
                            const float* v, long long n, int p_bf16,
                            int g_bf16, const float* lr, const float* scale,
                            const float* c1, const float* c2, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, void* stream) {
  if (n < 1 || !p_out || !p || !g || !m_out || !m || !v_out || !v || !lr ||
      !c1 || !c2)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamW a{lr, scale, c1, c2, b1, omb1, b2, omb2, eps, wd};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p_bf16 && g_bf16)
    err = launch_adamw<__nv_bfloat16, __nv_bfloat16>(p_out, p, g, m_out, m,
                                                     v_out, v, n, a, s);
  else if (p_bf16)
    err = launch_adamw<__nv_bfloat16, float>(p_out, p, g, m_out, m, v_out, v,
                                             n, a, s);
  else if (g_bf16)
    err = launch_adamw<float, __nv_bfloat16>(p_out, p, g, m_out, m, v_out, v,
                                             n, a, s);
  else
    err = launch_adamw<float, float>(p_out, p, g, m_out, m, v_out, v, n, a,
                                     s);
  return static_cast<int>(err);
}

// The sum of squares of `count` leaves (each: ptr, n >= 1, flags bit 0 for
// bf16; first_chunk and the alignment bit are filled in here) in one
// launch, count <= kSumsqLeaves.  partials: `capacity` floats, at
// least the launch's chunks (sum of ceil(n / (kChunkBytes / element
// size))), 16-byte aligned; ticket: an unsigned 0 before the first launch
// on it (each launch leaves it 0); out: the total, replaced (accumulate 0)
// or added to (1); route: the device counter's instance (0 f32, 1 bf16, 2
// both).
extern "C" int sumsq(const SumsqLeaf* leaves, int count, float* partials,
                     int capacity, unsigned* ticket, float* out,
                     int accumulate, int route, void* stream) {
  if (count < 1 || count > kSumsqLeaves || !leaves || !partials ||
      !ticket || !out || route < 0 || route > 2 ||
      (reinterpret_cast<uintptr_t>(partials) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  SumsqTable table;
  memset(&table, 0, sizeof(table));
  table.count = count;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    SumsqLeaf leaf = leaves[i];
    if (leaf.n < 1 || !leaf.ptr)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long per = kChunkBytes / ((leaf.flags & 1) ? 2 : 4);
    leaf.first_chunk = static_cast<int>(chunks);
    leaf.flags = (leaf.flags & 1) | (aligned(leaf.ptr) ? 2 : 0);
    table.leaf[i] = leaf;
    chunks += (leaf.n + per - 1) / per;
    if (chunks > capacity) return static_cast<int>(cudaErrorInvalidValue);
  }
  sumsq_kernel<<<static_cast<int>(chunks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      table, partials, ticket, out, accumulate, route);
  return static_cast<int>(cudaGetLastError());
}

// kernel 0: adamw_update (instance (p bf16) * 2 + (g bf16)); 1: sumsq
// (instance 0 f32, 1 bf16, 2 both).  ~0 on a bad argument or a failed copy.
extern "C" unsigned long long optimizer_launches(int kernel, int instance) {
  const int count = kernel == 0 ? 4 : 3;
  if (kernel < 0 || kernel > 1 || instance < 0 || instance >= count)
    return ~0ull;
  unsigned long long n = 0;
  const cudaError_t err =
      kernel == 0
          ? cudaMemcpyFromSymbol(&n, g_adamw_launches, sizeof(n),
                                 instance * sizeof(n))
          : cudaMemcpyFromSymbol(&n, g_sumsq_launches, sizeof(n),
                                 instance * sizeof(n));
  return err == cudaSuccess ? n : ~0ull;
}
