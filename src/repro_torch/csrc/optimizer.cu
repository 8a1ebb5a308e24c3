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
// What the design does: a grid-stride loop over 16-byte vectors (8 elements
// a thread a step: one vector of bf16, two of f32) with 64-bit offsets (a
// stacked leaf of codeqwen1.5-7b's MLP holds 0.88 B elements at 16 layers),
// the last n % 8 elements one a thread of block 0, and a one-element path
// where a pointer is not 16-byte aligned.
//
// - adamw_update_kernel: the reference's f32 ops in its order, each one
//   IEEE-rounded (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn cannot be
//   contracted into an FMA), so p, m and v equal the plain version's to the
//   bit: g * scale; b1 m + (1 - b1) g; b2 v + (1 - b2) g^2; m2 / c1;
//   v2 / c2; mh / (sqrt(vh) + eps) + wd p; p - lr delta; p rounded to its
//   dtype to nearest even.  lr, the clip scale and the bias corrections c1,
//   c2 are read from device memory, so the step makes no host synchronise
//   and a captured step replays them.  The outputs may be the inputs (the
//   donating form) or new tensors.
// - sumsq_kernel: per-thread f32 sums in the grid-stride order, a fixed
//   shuffle tree a warp and the warps in index order, one partial a block
//   over a grid fixed by the leaf's size; the last block to finish (a
//   ticket) sums the partials in index order and adds the leaf's total to
//   the running total of earlier launches on the stream.  Every sum has a
//   fixed order, so a run repeats itself to the bit.
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

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;              // elements a thread a step (aligned)
constexpr int kBlocksPerSm = 8;      // adamw: the most resident at 256 threads
constexpr int kSumsqBlocks = 1024;   // sumsq: the largest grid (the partials)
constexpr int kSumsqUnroll = 4;      // sumsq: vectors in flight a thread
constexpr int kMaxDevices = 64;

// instance ids: adamw (p bf16) * 2 + (g bf16); sumsq (g bf16)
__device__ unsigned long long g_adamw_launches[4];
__device__ unsigned long long g_sumsq_launches[2];

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

// ws: kSumsqBlocks partials, a ticket (0 between launches), the total
template <typename G, int V>
__global__ void __launch_bounds__(kThreads)
    sumsq_kernel(const G* g, long long n, float* ws, int accumulate) {
  const long long groups = n / V;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float acc = 0.0f;
  for (long long i = tid; i < groups; i += kSumsqUnroll * stride) {
    float x[kSumsqUnroll][V];
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (i + u * stride < groups) load<G, V>(g + (i + u * stride) * V, x[u]);
#pragma unroll
    for (int u = 0; u < kSumsqUnroll; ++u)
      if (i + u * stride < groups)
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc = __fadd_rn(acc, __fmul_rn(x[u][j], x[u][j]));
  }
  // the last n % V elements: one a thread of block 0
  if (blockIdx.x == 0 && groups * V + threadIdx.x < n) {
    const float x = to_f32(g[groups * V + threadIdx.x]);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  const float part = block_sum(acc);
  __shared__ bool last;
  unsigned* ticket = reinterpret_cast<unsigned*>(ws + kSumsqBlocks);
  if (threadIdx.x == 0) {
    ws[blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += kThreads)
    s = __fadd_rn(s, __ldcg(ws + b));
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    float* out = ws + kSumsqBlocks + 1;
    *out = accumulate ? __fadd_rn(*out, total) : total;
    *ticket = 0u;
    atomicAdd(&g_sumsq_launches[sizeof(G) == 2], 1ull);
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

template <typename G>
cudaError_t launch_sumsq(const void* g, long long n, float* ws,
                         int accumulate, cudaStream_t stream) {
  const bool vec = aligned(g);
  const long long groups = vec ? n / kVec : n;
  const int grid = grid_for(groups, kSumsqBlocks);
  auto* gi = static_cast<const G*>(g);
  if (vec)
    sumsq_kernel<G, kVec><<<grid, kThreads, 0, stream>>>(gi, n, ws,
                                                         accumulate);
  else
    sumsq_kernel<G, 1><<<grid, kThreads, 0, stream>>>(gi, n, ws, accumulate);
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

// ws: sumsq_workspace() floats, zero before the first launch on it; the
// total lands in ws[sumsq_workspace() - 1], replaced (accumulate 0) or added
// to (accumulate 1).
extern "C" int sumsq(const void* g, long long n, int g_bf16, float* ws,
                     int accumulate, void* stream) {
  if (n < 1 || !g || !ws) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      g_bf16 ? launch_sumsq<__nv_bfloat16>(g, n, ws, accumulate, s)
             : launch_sumsq<float>(g, n, ws, accumulate, s));
}

extern "C" int sumsq_workspace() { return kSumsqBlocks + 2; }

// kernel 0: adamw_update (instance (p bf16) * 2 + (g bf16)); 1: sumsq
// (instance g bf16).  ~0 on a bad argument or a failed copy.
extern "C" unsigned long long optimizer_launches(int kernel, int instance) {
  const int count = kernel == 0 ? 4 : 2;
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
