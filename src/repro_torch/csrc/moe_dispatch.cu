// The MoE block's dispatch for Hopper (sm_90a): slot positions, the
// token -> expert buffer, and the gate-weighted combine back.
//
// Replaces no Pallas kernel: the reference computes the whole block with
// jnp inside its jitted serve steps (src/repro/models/moe.py:44-112 under
// jax.jit in src/repro/launch/serve.py:75-76), where XLA fuses the routing
// glue.  The port's plain route (repro_torch/models/moe.py) runs it as some
// twenty eager ops a layer: an int64 one-hot (g, n, e) scanned along n
// (the cumsum was 39% of granite-moe's prefill on the card), a
// repeat_interleave of x, a scatter_add into a padded buffer that the
// experts' einsum then copies, and a gather, a where and an f32 upcast of
// (g, n, d) before the combine's einsum.  The router's product, softmax,
// top-k and gate renormalisation stay torch ops; the kernels start from the
// top-k experts `idx` and their gates.
//
// What bounds them: bytes.  The slot scan reads idx and writes pos, keep
// and the inverse map; the dispatch reads the tokens' rows and writes the
// (g, e, cap, d) buffer; the combine reads the kept rows of the experts'
// output and writes y.  None does more than a few operations a byte.
//
// What the design does:
//
// - moe_slots_kernel: a block a group, taking the group's n = sg * k slots
//   (token order, top-1 before top-2 within a token: the reference's
//   flattening) in tiles of the block's threads, a slot a thread.  A warp
//   ranks its 32 slots among themselves by __match_any_sync on the expert
//   id (rank = the earlier lanes of the same expert); one lane of each
//   expert present writes the warp's count of it into shared memory; then
//   a thread an expert turns the warps' counts into exclusive offsets in
//   warp order, starting from the expert's total over the earlier tiles,
//   which it carries on.  pos = offset + rank is then exactly the
//   reference's cumsum(one_hot) - 1 at the slot's expert (integers: no
//   rounding, no atomics, the same result on every run).  keep = pos < cap.
//   A kept slot writes its token's row into the inverse map src[g, e, pos];
//   after the last tile the block writes -1 into each expert's slots past
//   its count, so src is whole without a fill before the launch.
// - moe_dispatch_kernel: a warp a buffer row (g, e, c): the token row
//   src[g, e, c] of x copied in 16-byte vectors (where d, the strides and
//   the pointers allow; one element a lane otherwise), or zeros where src is
//   -1.  This is the reference's buffer: each kept slot receives exactly one
//   token, added to zeros.
// - moe_combine_kernel: a warp a token: for each of its k slots in order,
//   keep * gate * float(out_buf[g, expert, pos, :]) summed in f32 (an FMA a
//   term), rounded once to y's dtype.  out_buf is read by its strides (the
//   experts' einsum returns it e-major), so no copy precedes the launch.
//
// C interface (loaded with ctypes): moe_slots, moe_dispatch and moe_combine
// return the cudaError_t of the launch, 0 on success.  Each kernel adds one
// to a device counter of its instance from one thread a launch, so a CUDA
// graph's replays are counted too; moe_dispatch_launches copies it to the
// host (a synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxExperts = 256;    // shared-memory counts: e at most
constexpr int kSlotsThreads = 1024; // moe_slots_kernel: threads a block, most
constexpr int kMaxWarps = kSlotsThreads / 32;
constexpr int kRowWarps = 8;        // dispatch / combine: rows a block
constexpr int kChunk = 4;           // combine: vectors a lane sums at once

// instances: slots one (idx int64); dispatch and combine (bf16)
__device__ unsigned long long g_slots_launches[1];
__device__ unsigned long long g_dispatch_launches[2];
__device__ unsigned long long g_combine_launches[2];

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

// buf[g, e, c, :] = x[g, src[g, e, c], :], or zeros where src is -1.
// x's rows at strides (x_g, x_s) elements, unit stride along d.
template <typename T, int V>
__global__ void moe_dispatch_kernel(T* __restrict__ buf,
                                    const T* __restrict__ x,
                                    const int* __restrict__ src,
                                    long long rows, int ecap, int d,
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
      for (int c = lane; c < vecs; c += 32) dst[c] = z;
    } else {
      const Vt* from = reinterpret_cast<const Vt*>(x + (row / ecap) * x_g +
                                                   s * x_s);
      for (int c = lane; c < vecs; c += 32) dst[c] = from[c];
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

template <typename T>
cudaError_t launch_dispatch(void* buf, const void* x, const int* src,
                            int groups, int e, int cap, int d, long long x_g,
                            long long x_s, int inst, cudaStream_t s) {
  const long long rows = static_cast<long long>(groups) * e * cap;
  T* b = static_cast<T*>(buf);
  const T* xt = static_cast<const T*>(x);
  if (vectorised<T>(d, x_g, x_s, 0, buf, x))
    moe_dispatch_kernel<T, 16 / sizeof(T)><<<blocks_for(rows),
                                             kRowWarps * 32, 0, s>>>(
        b, xt, src, rows, e * cap, d, x_g, x_s, inst);
  else
    moe_dispatch_kernel<T, 1><<<blocks_for(rows), kRowWarps * 32, 0, s>>>(
        b, xt, src, rows, e * cap, d, x_g, x_s, inst);
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

// buf (groups x e x cap x d, contiguous) from x (groups x sg x d at strides
// x_g, x_s elements, unit stride along d) and src of moe_slots (token rows
// below sg, or -1).
extern "C" int moe_dispatch(void* buf, const void* x, const int* src,
                            int groups, int e, int cap, int d, long long x_g,
                            long long x_s, int bf16, void* stream) {
  if (groups < 1 || e < 1 || cap < 1 || d < 1 || !buf || !x || !src)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_dispatch<__nv_bfloat16>(buf, x, src, groups, e, cap, d,
                                            x_g, x_s, 1, s)
           : launch_dispatch<float>(buf, x, src, groups, e, cap, d, x_g, x_s,
                                    0, s);
  return static_cast<int>(err);
}

// y (groups x sg x d, contiguous, out's dtype) from out (groups x e x cap x
// d at strides o_g, o_e, o_c elements, unit stride along d), idx and gates
// (groups x sg x k, int64 and f32, contiguous), pos and keep of moe_slots.
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

// The device's count of launches of kernel 0 (slots), 1 (dispatch) or 2
// (combine), instance `instance`; ~0 on a bad argument or a failed copy.
extern "C" unsigned long long moe_dispatch_launches(int kernel,
                                                    int instance) {
  if (kernel < 0 || kernel > 2 || instance < 0 ||
      instance > (kernel == 0 ? 0 : 1))
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
    default:
      err = cudaMemcpyFromSymbol(&n, g_combine_launches, sizeof(n), off);
  }
  return err == cudaSuccess ? n : ~0ull;
}
