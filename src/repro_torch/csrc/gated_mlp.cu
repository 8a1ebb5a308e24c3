// The gated MLP's activation for Hopper (sm_90a), forward and backward:
// y = act(a) * b of the two projections a = x w1 and b = x w3, with act
// silu (swiglu) or the tanh form of gelu (geglu).
//
// Replaces no Pallas kernel: the reference computes gate(h) * g with jnp
// inside its jitted steps (src/repro/models/model.py:90-97 _mlp and the
// experts of src/repro/models/moe.py:98-100, compiled by jax.jit in
// src/repro/launch/train.py:96 and src/repro/launch/serve.py:75-76), where
// XLA fuses the pair and its vjp.  The port's plain version
// (repro_torch/kernels/gated_mlp.py gated_act_plain) runs two elementwise
// ATen kernels forward, remat runs them again, and autograd three more
// backward, each a full pass over (B, S, d_ff).
//
// What bounds them: bytes.  The forward reads a and b and writes y once; the
// backward reads a, b and dy and writes da and db once.  Neither does more
// than a few dozen operations an element (expf, or tanhf, and a division).
//
// What the design does: a flat pass over the elements, which lie in one
// dense layout in all the tensors (the wrapper hands over a permuted
// layout as it is, so the MoE experts' e-major product needs no copy), 16
// bytes a thread a load (8 bf16 or 4 f32) where every pointer is 16-byte
// aligned and the count a multiple of the vector, else one element a
// thread; a grid-stride loop.  The arithmetic is the plain route's on the
// card, expression for expression: ATen's silu and gelu-tanh functors and
// their backward functors (f32 inside, expf / tanhf, written as ATen writes
// them so that nvcc makes the same contractions), with the plain route's
// roundings between them in bf16: the forward rounds act(a) to bf16, then
// the product; the backward takes db = dy * round(act(a)) and da =
// act'(a) applied to round(dy * b), each rounded once, as autograd's mul
// and activation backward do.  Nothing is saved but a and b (the plain
// route keeps act(a) too).
//
// C interface (loaded with ctypes): gated_act_fwd and gated_act_bwd return
// the cudaError_t of the launch, 0 on success.  Each kernel adds one to a
// device counter of its instance from one thread a launch, so a CUDA
// graph's replays are counted too; gated_act_launches copies it to the
// host (a synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kBlock = 256;
constexpr long long kMaxGrid = 132LL * 16;   // 16 blocks an SM of an H100

// instances: activation (0 silu, 1 gelu-tanh) * 2 + (bf16)
__device__ unsigned long long g_gate_fwd_launches[4];
__device__ unsigned long long g_gate_bwd_launches[4];

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

// x rounded to T and back: the plain route's rounding of an intermediate
// tensor of dtype T (none in f32)
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
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

// ATen's CUDA functors (ActivationSiluKernel.cu, ActivationGeluKernel.cu),
// in their order of operations; their constants made as ATen makes them
// (M_SQRT2 * M_2_SQRTPI * 0.5 and 0.044715 in double, then cast)
constexpr double kSqrt2 = 1.41421356237309504880;     // M_SQRT2
constexpr double k2SqrtPi = 1.12837916709551257390;   // M_2_SQRTPI
constexpr float kBeta = static_cast<float>(kSqrt2 * k2SqrtPi * 0.5);
constexpr float kKappa = static_cast<float>(0.044715);

template <int kAct>
__device__ __forceinline__ float act(float x) {
  if constexpr (kAct == 0) {
    return x / (1.0f + expf(-x));
  } else {
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  }
}

// dy * act'(x), as ATen's silu_backward / gelu_backward(tanh) compute it
template <int kAct>
__device__ __forceinline__ float act_backward(float dy, float x) {
  if constexpr (kAct == 0) {
    const float s = 1.0f / (1.0f + expf(-x));
    return dy * s * (1.0f + x * (1.0f - s));
  } else {
    const float x_sq = x * x;
    const float x_cube = x_sq * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    const float tanh_inner = tanhf(inner);
    const float left = 0.5f * x;
    const float right = 1.0f + tanh_inner;
    const float left_derivative = 0.5f * right;
    const float right_derivative = left * (1.0f - tanh_inner * tanh_inner) *
                                   kBeta * (1.0f + 3.0f * kKappa * x_sq);
    return dy * (left_derivative + right_derivative);
  }
}

template <typename T, int kAct, int V>
__global__ void __launch_bounds__(kBlock)
    gated_act_fwd_kernel(T* __restrict__ y, const T* __restrict__ a,
                         const T* __restrict__ b, long long groups,
                         int route) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_gate_fwd_launches[route], 1ull);
  const long long step = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < groups; i += step) {
    float xa[V], xb[V], out[V];
    load<T, V>(a + i * V, xa);
    load<T, V>(b + i * V, xb);
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = rounded<T>(act<kAct>(xa[j])) * xb[j];
    store<T, V>(y + i * V, out);
  }
}

template <typename T, int kAct, int V>
__global__ void __launch_bounds__(kBlock)
    gated_act_bwd_kernel(T* __restrict__ da, T* __restrict__ db,
                         const T* __restrict__ a, const T* __restrict__ b,
                         const T* __restrict__ dy, long long groups,
                         int route) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_gate_bwd_launches[route], 1ull);
  const long long step = static_cast<long long>(gridDim.x) * kBlock;
  for (long long i = static_cast<long long>(blockIdx.x) * kBlock +
                     threadIdx.x;
       i < groups; i += step) {
    float xa[V], xb[V], g[V], outa[V], outb[V];
    load<T, V>(a + i * V, xa);
    load<T, V>(b + i * V, xb);
    load<T, V>(dy + i * V, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      outb[j] = g[j] * rounded<T>(act<kAct>(xa[j]));
      outa[j] = act_backward<kAct>(rounded<T>(g[j] * xb[j]), xa[j]);
    }
    store<T, V>(da + i * V, outa);
    store<T, V>(db + i * V, outb);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int grid_for(long long groups) {
  const long long blocks = (groups + kBlock - 1) / kBlock;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

template <typename T, int kAct>
cudaError_t launch_fwd(void* y, const void* a, const void* b, long long n,
                       int route, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n % kVec == 0 && aligned(y) && aligned(a) && aligned(b)) {
    gated_act_fwd_kernel<T, kAct, kVec>
        <<<grid_for(n / kVec), kBlock, 0, stream>>>(
            static_cast<T*>(y), static_cast<const T*>(a),
            static_cast<const T*>(b), n / kVec, route);
  } else {
    gated_act_fwd_kernel<T, kAct, 1><<<grid_for(n), kBlock, 0, stream>>>(
        static_cast<T*>(y), static_cast<const T*>(a),
        static_cast<const T*>(b), n, route);
  }
  return cudaGetLastError();
}

template <typename T, int kAct>
cudaError_t launch_bwd(void* da, void* db, const void* a, const void* b,
                       const void* dy, long long n, int route,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (n % kVec == 0 && aligned(da) && aligned(db) && aligned(a) &&
      aligned(b) && aligned(dy)) {
    gated_act_bwd_kernel<T, kAct, kVec>
        <<<grid_for(n / kVec), kBlock, 0, stream>>>(
            static_cast<T*>(da), static_cast<T*>(db),
            static_cast<const T*>(a), static_cast<const T*>(b),
            static_cast<const T*>(dy), n / kVec, route);
  } else {
    gated_act_bwd_kernel<T, kAct, 1><<<grid_for(n), kBlock, 0, stream>>>(
        static_cast<T*>(da), static_cast<T*>(db), static_cast<const T*>(a),
        static_cast<const T*>(b), static_cast<const T*>(dy), n, route);
  }
  return cudaGetLastError();
}

}  // namespace

// y = act(a) * b over n elements laid out alike in y, a and b; act 0 silu,
// 1 gelu (tanh form); bf16 1 for bf16, 0 for f32.
extern "C" int gated_act_fwd(void* y, const void* a, const void* b,
                             long long n, int act, int bf16, void* stream) {
  if (n < 1 || !y || !a || !b || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int route = act * 2 + (bf16 ? 1 : 0);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = act ? launch_fwd<__nv_bfloat16, 1>(y, a, b, n, route, s)
              : launch_fwd<__nv_bfloat16, 0>(y, a, b, n, route, s);
  else
    err = act ? launch_fwd<float, 1>(y, a, b, n, route, s)
              : launch_fwd<float, 0>(y, a, b, n, route, s);
  return static_cast<int>(err);
}

// da, db of y = gated_act_fwd(a, b) given dy, all laid out alike.
extern "C" int gated_act_bwd(void* da, void* db, const void* a,
                             const void* b, const void* dy, long long n,
                             int act, int bf16, void* stream) {
  if (n < 1 || !da || !db || !a || !b || !dy || act < 0 || act > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int route = act * 2 + (bf16 ? 1 : 0);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = act ? launch_bwd<__nv_bfloat16, 1>(da, db, a, b, dy, n, route, s)
              : launch_bwd<__nv_bfloat16, 0>(da, db, a, b, dy, n, route, s);
  else
    err = act ? launch_bwd<float, 1>(da, db, a, b, dy, n, route, s)
              : launch_bwd<float, 0>(da, db, a, b, dy, n, route, s);
  return static_cast<int>(err);
}

// kernel 0: gated_act_fwd, 1: gated_act_bwd; instance activation * 2 +
// bf16.  ~0 on a bad argument or a failed copy.
extern "C" unsigned long long gated_act_launches(int kernel, int instance) {
  if (kernel < 0 || kernel > 1 || instance < 0 || instance > 3) return ~0ull;
  unsigned long long n = 0;
  const size_t off = instance * sizeof(n);
  const cudaError_t err =
      kernel == 0
          ? cudaMemcpyFromSymbol(&n, g_gate_fwd_launches, sizeof(n), off)
          : cudaMemcpyFromSymbol(&n, g_gate_bwd_launches, sizeof(n), off);
  return err == cudaSuccess ? n : ~0ull;
}
