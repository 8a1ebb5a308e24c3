// The train step's loss for Hopper (sm_90a), forward and backward: the
// soft-capped cross-entropy of the head's logits, cap * tanh(x / cap) (cap
// 0: x) in f32, its mean over the labels in [0, vocab_size).
//
// Replaces no Pallas kernel: the reference computes softcap(logits.astype(
// f32), cap) and cross_entropy with jnp inside its jitted train step
// (src/repro/models/model.py:317-323 logits_fn, :339, and
// src/repro/models/common.py:185-188 softcap, :218-227 cross_entropy,
// compiled by jax.jit in src/repro/launch/train.py:96), where XLA fuses
// them and their vjp.  The port's plain version (repro_torch/models/
// common.py cross_entropy of the capped f32 copy) writes an f32 copy of
// the logits (1.5 GB at codeqwen1.5-7b's 8 x 512 x 92,416), reads it for
// the logsumexp and the gather, and autograd writes f32 grads and casts
// them back.
//
// What bounds them: bytes.  The forward reads the logits once; the
// backward reads them once and writes their grad once, in their own dtype.
// Each element costs an expf (and with a cap a tanhf): a few dozen
// operations against 2 or 4 bytes, near the card's balance in bf16, so the
// arithmetic is kept to one expf an element.
//
// What the design does:
//
// - cross_entropy_fwd_kernel: a block a row (T threads, a power of two
//   from 32 to 1024, the fewest that leave each thread at most kItems
//   groups), 16-byte loads (8 bf16 or 4 f32) where the row's pointers are
//   aligned and the width a multiple of the vector, else one element a
//   thread.  The cap is the plain route's on the card bit for bit: x times
//   the f32 reciprocal of the cap (ATen's division of a tensor by a CPU
//   scalar), tanhf, times the cap.  Each thread keeps an online maximum and
//   a sum of expf(c - max) over its groups in order (a group's maximum
//   first, one rescale a new maximum; a group's terms summed in f32, the
//   groups in f64), then the block merges the
//   (max, sum) pairs in a fixed order (each warp's xor tree, the warps in
//   order): lse = max + log(sum) in f64, kept as an f32 value and its f32
//   remainder (so the backward's exp(c - lse) carries no rounding of lse).
//   The label's capped logit is read again by one thread; labels outside
//   [0, vocab_size), past the padded width included, are masked (no NaN:
//   the port's masked mean).  Writes the row's lse pair and its masked loss
//   (lse - gold in f64, rounded once).
// - cross_entropy_sum_kernel: one block sums the rows' losses in f64 in a
//   fixed order (thread t's rows t, t + 1024, ..., then the xor trees and
//   the warps in order) and counts the labels kept, then writes the f32 sum
//   over max(count, 1) (the plain route's f32 division) and that
//   denominator.  No float atomics: a run repeats itself to the bit.
// - cross_entropy_bwd_kernel: a block a row again, reading the logits, the
//   row's lse and label and the upstream grad and the denominator from the
//   device (no host read, so a captured step can replay it), writing the
//   grad of the pre-cap logits in their dtype in the plain autograd's
//   order: w = g / denominator (x the mask), w * expf((c - lse) - lse's
//   remainder), less w at the label, then the cap's chain (times cap,
//   times 1 - tanh^2, times the reciprocal).
//
// C interface (loaded with ctypes): cross_entropy_fwd (both of its
// kernels) and cross_entropy_bwd return the cudaError_t of the launch, 0
// on success.  Each kernel adds one to a device counter of its instance
// (the logits' dtype) from one thread a launch, so a CUDA graph's replays
// are counted too; cross_entropy_launches copies it to the host (a
// synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxThreads = 1024;   // a row's block, at most
constexpr int kItems = 8;           // groups a thread, at most (wider: more)
constexpr int kSumThreads = 1024;

// instances: logits bf16
__device__ unsigned long long g_ce_fwd_launches[2];
__device__ unsigned long long g_ce_sum_launches[2];
__device__ unsigned long long g_ce_bwd_launches[2];

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

template <typename T, int V>
__device__ __forceinline__ void load(const T* src, float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(src[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    static_assert(V == kPer, "one 16-byte vector");
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    T t[kPer];
    memcpy(t, &u, sizeof(u));
#pragma unroll
    for (int j = 0; j < kPer; ++j) x[j] = to_f32(t[j]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* dst, const float (&x)[V]) {
  if constexpr (V == 1) {
    dst[0] = from_f32<T>(x[0]);
  } else {
    constexpr int kPer = 16 / sizeof(T);
    T t[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) t[j] = from_f32<T>(x[j]);
    uint4 u;
    memcpy(&u, t, sizeof(u));
    *reinterpret_cast<uint4*>(dst) = u;
  }
}

// the plain route's cap on the card: (x * (1 / cap)) -> tanhf -> * cap,
// each an IEEE-rounded f32 op
template <bool kCap>
__device__ __forceinline__ float capped(float x, float cap, float inv_cap) {
  if constexpr (kCap) return __fmul_rn(cap, tanhf(__fmul_rn(x, inv_cap)));
  return x;
}

// (m, s) merged with (om, os): the larger maximum, the sums rescaled to it
__device__ __forceinline__ void merge(float& m, double& s, float om,
                                      double os) {
  if (om == -INFINITY) return;
  if (m == -INFINITY) {
    m = om;
    s = os;
    return;
  }
  const float nm = fmaxf(m, om);
  s = s * exp(static_cast<double>(m) - nm) +
      os * exp(static_cast<double>(om) - nm);
  m = nm;
}

// The block's (max, sum) merged in a fixed order: each warp's xor tree
// (every lane gets the warp's), then the warps in order; thread 0 gets the
// block's.
__device__ __forceinline__ void block_merge(float& m, double& s) {
  __shared__ float wm[kMaxThreads / 32];
  __shared__ double ws[kMaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  const int warps = blockDim.x / 32;
  if (warps == 1) return;
  if (threadIdx.x % 32 == 0) {
    wm[threadIdx.x / 32] = m;
    ws[threadIdx.x / 32] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) merge(m, s, wm[w], ws[w]);
  }
}

template <typename T, int V, bool kCap>
__global__ void __launch_bounds__(kMaxThreads)
    cross_entropy_fwd_kernel(float* __restrict__ lse,
                             float* __restrict__ row_loss,
                             const T* __restrict__ logits,
                             const long long* __restrict__ labels,
                             int width, int vocab, float cap, float inv_cap,
                             int route) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_ce_fwd_launches[route], 1ull);
  const long long row = blockIdx.x;
  const T* x = logits + row * width;
  const int groups = width / V;
  float m = -INFINITY;
  double s = 0.0;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float v[V];
    load<T, V>(x + static_cast<long long>(g) * V, v);
    float vm = -INFINITY;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = capped<kCap>(v[j], cap, inv_cap);
      vm = fmaxf(vm, v[j]);
    }
    if (vm > m) {
      if (m != -INFINITY) s *= static_cast<double>(expf(m - vm));
      m = vm;
    }
    float gs = 0.0f;
#pragma unroll
    for (int j = 0; j < V; ++j) gs += expf(v[j] - m);
    s += static_cast<double>(gs);
  }
  block_merge(m, s);
  if (threadIdx.x == 0) {
    const double l = static_cast<double>(m) + log(s);
    const float hi = static_cast<float>(l);
    const long long label = labels[row];
    float loss = 0.0f;
    if (label >= 0 && label < vocab)
      loss = static_cast<float>(
          l - capped<kCap>(to_f32(x[label]), cap, inv_cap));
    lse[2 * row] = hi;
    lse[2 * row + 1] = static_cast<float>(l - hi);
    row_loss[row] = loss;
  }
}

// the sum of row_loss over max(kept labels, 1) into loss, and that
// denominator
__global__ void __launch_bounds__(kSumThreads)
    cross_entropy_sum_kernel(float* __restrict__ loss,
                             float* __restrict__ denominator,
                             const float* __restrict__ row_loss,
                             const long long* __restrict__ labels,
                             long long rows, int vocab, int route) {
  if (threadIdx.x == 0) atomicAdd(&g_ce_sum_launches[route], 1ull);
  __shared__ double ws[kSumThreads / 32];
  __shared__ long long wc[kSumThreads / 32];
  double s = 0.0;
  long long c = 0;
  for (long long r = threadIdx.x; r < rows; r += kSumThreads) {
    s += static_cast<double>(row_loss[r]);
    c += labels[r] >= 0 && labels[r] < vocab;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    c += __shfl_xor_sync(0xffffffffu, c, o);
  }
  if (threadIdx.x % 32 == 0) {
    ws[threadIdx.x / 32] = s;
    wc[threadIdx.x / 32] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kSumThreads / 32; ++w) {
      s += ws[w];
      c += wc[w];
    }
    const float denom = static_cast<float>(c > 0 ? c : 1);
    loss[0] = __fdiv_rn(static_cast<float>(s), denom);
    denominator[0] = denom;
  }
}

template <typename T, int V, bool kCap>
__global__ void __launch_bounds__(kMaxThreads)
    cross_entropy_bwd_kernel(T* __restrict__ grad,
                             const T* __restrict__ logits,
                             const float* __restrict__ lse,
                             const long long* __restrict__ labels,
                             const float* __restrict__ upstream,
                             const float* __restrict__ denom, int width,
                             int vocab, float cap, float inv_cap,
                             int route) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_ce_bwd_launches[route], 1ull);
  const long long row = blockIdx.x;
  const T* x = logits + row * width;
  T* dx = grad + row * width;
  const int groups = width / V;
  const long long label = labels[row];
  const bool kept = label >= 0 && label < vocab;
  const float w = kept ? __fdiv_rn(upstream[0], denom[0]) : 0.0f;
  const float l = lse[2 * row], l_lo = lse[2 * row + 1];
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float v[V];
    if (!kept) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.0f;
      store<T, V>(dx + static_cast<long long>(g) * V, v);
      continue;
    }
    load<T, V>(x + static_cast<long long>(g) * V, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = g * V + j;
      const float c = capped<kCap>(v[j], cap, inv_cap);
      float gc = __fmul_rn(w, expf(__fsub_rn(__fsub_rn(c, l), l_lo)));
      if (col == label) gc = __fsub_rn(gc, w);
      if constexpr (kCap) {
        const float t = tanhf(__fmul_rn(v[j], inv_cap));
        gc = __fmul_rn(__fmul_rn(__fmul_rn(gc, cap),
                                 __fsub_rn(1.0f, __fmul_rn(t, t))),
                       inv_cap);
      }
      v[j] = gc;
    }
    store<T, V>(dx + static_cast<long long>(g) * V, v);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// threads a row: the fewest powers of two from 32 that leave each at most
// kItems groups, up to kMaxThreads
int row_threads(int groups) {
  int t = 32;
  while (t < kMaxThreads && groups > kItems * t) t *= 2;
  return t;
}

template <typename T, bool kCap>
cudaError_t launch_fwd(float* lse, float* row_loss, float* loss,
                       float* denom, const void* logits,
                       const long long* labels,
                       long long rows, int width, int vocab, float cap,
                       float inv_cap, int route, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = width % kVec == 0 && aligned(logits);
  const int groups = vec ? width / kVec : width;
  const int threads = row_threads(groups);
  auto* kernel = vec ? cross_entropy_fwd_kernel<T, kVec, kCap>
                     : cross_entropy_fwd_kernel<T, 1, kCap>;
  kernel<<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      lse, row_loss, static_cast<const T*>(logits), labels, width, vocab,
      cap, inv_cap, route);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cross_entropy_sum_kernel<<<1, kSumThreads, 0, stream>>>(
      loss, denom, row_loss, labels, rows, vocab, route);
  return cudaGetLastError();
}

template <typename T, bool kCap>
cudaError_t launch_bwd(void* grad, const void* logits, const float* lse,
                       const long long* labels, const float* upstream,
                       const float* denom, long long rows, int width,
                       int vocab, float cap, float inv_cap, int route,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = width % kVec == 0 && aligned(logits) && aligned(grad);
  const int groups = vec ? width / kVec : width;
  const int threads = row_threads(groups);
  auto* kernel = vec ? cross_entropy_bwd_kernel<T, kVec, kCap>
                     : cross_entropy_bwd_kernel<T, 1, kCap>;
  kernel<<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<T*>(grad), static_cast<const T*>(logits), lse, labels,
      upstream, denom, width, vocab, cap, inv_cap, route);
  return cudaGetLastError();
}

}  // namespace

// The mean capped cross-entropy of `rows` rows of `width` logits (f32, or
// bf16 with bf16 = 1; contiguous) against labels (int64, rows): lse (rows
// x 2, f32: each row's value and remainder), row_loss (rows, f32), loss
// and denom (one f32 each: the mean and max(kept, 1)).
// cap 0: no cap; inv_cap: the f32 reciprocal of cap.
extern "C" int cross_entropy_fwd(float* lse, float* row_loss, float* loss,
                                 float* denom, const void* logits,
                                 const long long* labels,
                                 long long rows, int width, int vocab,
                                 float cap, float inv_cap, int bf16,
                                 void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || width < 1 || vocab < 1 ||
      vocab > width || !lse || !row_loss || !loss || !denom || !logits ||
      !labels)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int route = bf16 ? 1 : 0;
  const bool capped = cap != 0.0f;
  cudaError_t err;
  if (bf16)
    err = capped ? launch_fwd<__nv_bfloat16, true>(
                       lse, row_loss, loss, denom, logits, labels, rows,
                       width, vocab, cap, inv_cap, route, s)
                 : launch_fwd<__nv_bfloat16, false>(
                       lse, row_loss, loss, denom, logits, labels, rows,
                       width, vocab, cap, inv_cap, route, s);
  else
    err = capped ? launch_fwd<float, true>(lse, row_loss, loss, denom,
                                           logits, labels, rows, width,
                                           vocab, cap, inv_cap, route, s)
                 : launch_fwd<float, false>(lse, row_loss, loss, denom,
                                            logits, labels, rows, width,
                                            vocab, cap, inv_cap, route, s);
  return static_cast<int>(err);
}

// The grad of cross_entropy_fwd's loss with respect to the logits (their
// dtype and layout) given the upstream grad (a device f32 scalar), the
// forward's lse and its denominator.
extern "C" int cross_entropy_bwd(void* grad, const void* logits,
                                 const float* lse, const long long* labels,
                                 const float* upstream, const float* denom,
                                 long long rows, int width, int vocab,
                                 float cap, float inv_cap, int bf16,
                                 void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || width < 1 || vocab < 1 ||
      vocab > width || !grad || !logits || !lse || !labels || !upstream ||
      !denom)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int route = bf16 ? 1 : 0;
  cudaError_t err;
  if (bf16)
    err = cap != 0.0f
              ? launch_bwd<__nv_bfloat16, true>(grad, logits, lse, labels,
                                                upstream, denom, rows, width,
                                                vocab, cap, inv_cap, route, s)
              : launch_bwd<__nv_bfloat16, false>(grad, logits, lse, labels,
                                                 upstream, denom, rows,
                                                 width, vocab, cap, inv_cap,
                                                 route, s);
  else
    err = cap != 0.0f
              ? launch_bwd<float, true>(grad, logits, lse, labels, upstream,
                                        denom, rows, width, vocab, cap,
                                        inv_cap, route, s)
              : launch_bwd<float, false>(grad, logits, lse, labels, upstream,
                                         denom, rows, width, vocab, cap,
                                         inv_cap, route, s);
  return static_cast<int>(err);
}

// kernel 0: cross_entropy_fwd, 1: its sum, 2: cross_entropy_bwd; instance
// the logits' dtype (1 bf16).  ~0 on a bad argument or a failed copy.
extern "C" unsigned long long cross_entropy_launches(int kernel,
                                                     int instance) {
  if (kernel < 0 || kernel > 2 || instance < 0 || instance > 1) return ~0ull;
  unsigned long long n = 0;
  const size_t off = instance * sizeof(n);
  cudaError_t err;
  switch (kernel) {
    case 0:
      err = cudaMemcpyFromSymbol(&n, g_ce_fwd_launches, sizeof(n), off);
      break;
    case 1:
      err = cudaMemcpyFromSymbol(&n, g_ce_sum_launches, sizeof(n), off);
      break;
    default:
      err = cudaMemcpyFromSymbol(&n, g_ce_bwd_launches, sizeof(n), off);
  }
  return err == cudaSuccess ? n : ~0ull;
}
