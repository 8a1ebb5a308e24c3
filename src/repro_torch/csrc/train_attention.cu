// The train step's attention for Hopper (sm_90a): forward and backward of
// softmax attention over full sequences in the reference's f32 arithmetic;
// GQA by head index, causal, sliding window, tanh logit soft-cap, and
// S != T (whisper's cross-attention, non-causal, no window).
//
// Replaces no Pallas kernel: the reference trains its attention with jnp
// inside the jitted train step (src/repro/models/attention.py:118-129:
// _gqa_scores, softcap, the mask, jax.nn.softmax, _gqa_out; jax.jit in
// src/repro/launch/train.py:96), where XLA feeds the f32 upcast into the
// products and fuses the scale, cap, mask and softmax.  Same function, in
// the reference's order: x = (q . k) / sqrt(D), then cap * tanh(x / cap),
// then -1e30 where the mask hides the pair, an f32 softmax over the keys
// and the f32 sum of P V; the backward is autograd's on those ops (the
// softmax's P (dP - rowsum(dP P)), tanh's 1 - t^2, the two divides).
// The divides by the constants sqrt(D) and cap are products with their
// f32 reciprocals, as ATen divides a CUDA tensor by a scalar (the port's
// plain route on the card); tanh, exp and log are the libm f32 functions
// (tanhf, expf, logf), not the fast approximations; each op is rounded on
// its own (__fmul_rn and friends: no contraction into an FMA).
//
// Bound.  At codeqwen1.5-7b's train shape (B = 8, 32 heads, S = 512, D =
// 128, causal, bf16) a forward must read q, k, v and write o and the
// log-sum-exp once: 134 MB, 40 us at 3.35 TB/s, against 17 GFLOP of visible
// pairs (17 us at 989 TFLOP/s); it also writes o's f32 values for the
// backward (67 MB more); the backward must move about twice the bytes.  Bytes bound it, and the plain route moves the whole S x S
// f32 score tensor a dozen times.  What the design does about it: no S x S
// tensor ever reaches device memory (an online softmax in the forward, P
// recomputed from the log-sum-exp in the backward), the kv tiles that the
// causal mask or the window hide are skipped, and q, k, v are read in the
// model's (B, S, H, D) layout by strides, with no transposed copies.
//
// Routes, fixed by the wrapper before the launch (kernels/train_attention.py
// route):
//
// - mma_bf16 (bf16 q, k, v with D a multiple of 8 up to 128): the tensor
//   cores through mma.sync m16n8k16 from ldmatrix fragments, f32
//   accumulation, K / V (forward, dQ) or Q / dO (dK dV) tiles in a 2-stage
//   cp.async ring, D zero-padded to DP (32, 64, 80 or 128).  bf16 x bf16
//   products are exact in f32, so Q K^T and dO V^T are the reference's
//   products up to the order of the f32 sums.  The f32 operands, P and dS,
//   enter P V, P^T dO, dS K and dS^T Q as a hi and a lo bf16 half (two
//   products against the same fragment of the other operand): ~16 mantissa
//   bits, where one bf16 rounding would move the result by ~2^-9 of it.
// - scalar_f32 (f32 q, k, v; the wrapper takes bf16 at other D, and whisper's
//   bf16 q against the f32 encoder's k and v, here after an exact upcast):
//   scalar f32 FMAs from f32 shared-memory tiles (TF32 tensor cores would
//   keep ~10 bits).
//
// Four kernels a route: the forward (o in the inputs' dtype, the f32
// output o32 for the backward (o itself on the f32 route) and the f32
// log-sum-exp of each row); delta = rowsum(dO o32); dK dV over key tiles,
// one block a (b, kv head, key tile) that sums the G query heads of its kv
// head in a fixed order; dQ over query tiles.  Both backward passes
// recompute P = exp(x - lse).  Each grad is summed in f32 and rounded once
// to the inputs' dtype.  No float atomics: the same bits on every run.
//
// Positions: the mask compares row and column indices, which equals the
// reference's mask on positions wherever they are arange (every train
// caller's; the causal and windowed calls need S == T, which the wrapper
// checks, so every row sees its own key).
//
// C interface (loaded with ctypes): train_attention_forward(...) and
// train_attention_backward(...) return the cudaError_t of their launches,
// 0 on success.  Each launch adds one to a device counter of its kernel and
// route (one thread of block 0), so a CUDA graph's replays would count
// too; train_attention_launches(kernel, route) copies it to the host (a
// synchronous copy: call it outside a capture).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using tc::bf16;

constexpr float kMasked = -1e30f;   // the reference's mask value

enum Kernel { kForward, kDelta, kDkdv, kDq, kKernels };
enum Route { kMma, kF32, kRoutes };
__device__ unsigned long long g_launches[kKernels * kRoutes];

__device__ __forceinline__ void count_launch(Kernel kernel, Route route) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0)
    atomicAdd(&g_launches[kernel * kRoutes + route], 1ull);
}

struct Args {
  const void* q;      // (B, S, Hq, D), strides q_sb, q_ss, q_sh, last dim 1
  const void* k;      // (B, T, Hkv, D), strides k_*
  const void* v;      // (B, T, Hkv, D), strides v_*
  void* o;            // (B, S, Hq, D) contiguous, the inputs' dtype
  float* o32;         // (B, S, Hq, D) contiguous f32 (o itself on f32)
  float* lse;         // (B, Hq, S)
  const void* dout;   // (B, S, Hq, D) contiguous, the inputs' dtype
  float* delta;       // (B, Hq, S)
  void* dq;           // like q, contiguous, the inputs' dtype
  void* dk;           // like k, contiguous
  void* dv;
  int B, S, T, Hq, Hkv, G, D;
  long long q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int causal, window;
  float cap, inv_cap, inv_sqrt_d;   // cap 0: no cap
};

__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return (!a.causal || col <= row) && (a.window <= 0 || row - col < a.window);
}

// The reference's score of a raw product s = q . k at (row, col): s /
// sqrt(D), then cap * tanh(. / cap) (th: the tanh, for the backward), then
// -1e30 where the mask hides the pair; -inf past the last key (a padded
// column: weight exactly 0).
__device__ __forceinline__ float masked_score(const Args& a, float s, int row,
                                              int col, float& th) {
  float x = __fmul_rn(s, a.inv_sqrt_d);
  th = 0.f;
  if (a.cap != 0.f) {
    th = tanhf(__fmul_rn(x, a.inv_cap));
    x = __fmul_rn(a.cap, th);
  }
  if (col >= a.T) return -INFINITY;
  return visible(a, row, col) ? x : kMasked;
}

// The grad of the raw product q . k from P and dP = dO . v of its pair:
// softmax's P (dP - delta), then back through the cap (cap * g * (1 - th^2)
// / cap, autograd's order) and the divide by sqrt(D).
__device__ __forceinline__ float product_grad(const Args& a, float p,
                                              float dp, float delta,
                                              float th) {
  float g = __fmul_rn(p, __fsub_rn(dp, delta));
  if (a.cap != 0.f)
    g = __fmul_rn(__fmul_rn(__fmul_rn(g, a.cap),
                            __fsub_rn(1.f, __fmul_rn(th, th))),
                  a.inv_cap);
  return __fmul_rn(g, a.inv_sqrt_d);
}

// Tile [begin, end) of the key tiles of `keys` keys that can hold a key
// visible to some row of the query tile [q0, q0 + rows).
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int rows,
                                          int keys, int& begin, int& end) {
  const int q_last = min(q0 + rows, a.S) - 1;
  const int k_end = a.causal ? min(a.T, q_last + 1) : a.T;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  begin = k_begin / keys;
  end = (k_end + keys - 1) / keys;
}

// The same for the query tiles of `rows` rows that can see some key of the
// key tile [k0, k0 + keys).
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int keys,
                                            int rows, int& begin, int& end) {
  const int k_last = min(k0 + keys, a.T) - 1;
  const int q_begin = a.causal ? k0 : 0;
  const int q_end = a.window > 0 ? min(a.S, k_last + a.window) : a.S;
  begin = q_begin / rows;
  end = q_end > q_begin ? (q_end + rows - 1) / rows : begin;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// delta[b, h, s] = sum_d dO[b, s, h, d] o32[b, s, h, d]: one warp a row.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  count_launch(kDelta, sizeof(T) == 4 ? kF32 : kMma);
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)a.B * a.S * a.Hq;
  if (row >= rows) return;
  const T* dout = static_cast<const T*>(a.dout) + row * a.D;
  const float* o = a.o32 + row * a.D;
  float sum = 0.f;
  for (int d = lane; d < a.D; d += 32)
    sum = fmaf(to_float(dout[d]), o[d], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = (int)(row % a.Hq);
    const long long bs = row / a.Hq;            // b * S + s
    const int s = (int)(bs % a.S);
    const int b = (int)(bs / a.S);
    a.delta[((long long)b * a.Hq + h) * a.S + s] = sum;
  }
}

// ------------------------------------------------------------ mma_bf16

// four warps of 16 rows; the mma kernels' launch bounds name one block an
// SM as the least, else ptxas held dq_mma_kernel<64> to 128 registers and
// spilled
constexpr int kMmaThreads = 128;
constexpr int kRows = 64;          // query rows (forward, dQ) or keys (dK dV) a block
constexpr int kKeys = 64;          // keys a tile (forward, dQ)

// Rows [r0, r0 + ROWS) (those below n) of a head of a strided bf16 tensor
// whose rows are `ld` elements apart, columns [0, D) of DP, into a shared
// tile with row stride DP + 8, by cp.async; the rest zero.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* head,
                                          long long ld, int r0, int n,
                                          int D) {
  tc::load_tile_async<ROWS, DP, DP + 8, kMmaThreads>(dst, head + r0 * ld,
                                                     (int)ld, n - r0, D);
}

// The A fragments (hi and lo bf16 halves) of k-step kk of an f32 tile held
// in the C layout of n-blocks 2 kk and 2 kk + 1: the C fragment of a 16 x 16
// block is the A fragment of the same block.
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tc::pack_split_bf16(c0[0], c0[1], hi[0], lo[0]);
  tc::pack_split_bf16(c0[2], c0[3], hi[1], lo[1]);
  tc::pack_split_bf16(c1[0], c1[1], hi[2], lo[2]);
  tc::pack_split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// acc (16 x DP, C layout) += A B, A the f32 tile c (16 x 16 KSTEPS, C layout)
// as hi + lo halves, B rows [0, 16 KSTEPS) of a k-major shared tile.
template <int DP, int KSTEPS>
__device__ __forceinline__ void mma_split(float (&acc)[DP / 8][4],
                                          const float (&c)[2 * KSTEPS][4],
                                          const bf16* tile, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t hi[4], lo[4];
    split_a(c[2 * kk], c[2 * kk + 1], hi, lo);
#pragma unroll
    for (int j = 0; j < DP / 8; j += 2) {
      uint32_t b[4];
      tc::load_b_kmajor(b, tile, LD, j * 8, kk * 16, lane);
      tc::mma_bf16(acc[j], hi, b[0], b[1]);
      tc::mma_bf16(acc[j], lo, b[0], b[1]);
      tc::mma_bf16(acc[j + 1], hi, b[2], b[3]);
      tc::mma_bf16(acc[j + 1], lo, b[2], b[3]);
    }
  }
}

// s (16 x 8 NB, C layout) = A B^T: A rows [row0, row0 + 16) of shared tile
// ta, B rows [0, 8 NB) of shared tile tb (n-major), both DP wide.
template <int DP, int NB>
__device__ __forceinline__ void mma_nt(float (&s)[NB][4], const bf16* ta,
                                       int row0, const bf16* tb, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    tc::load_a(af, ta, LD, row0, kk * 16, lane);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      uint32_t b[4];
      tc::load_b_nmajor(b, tb, LD, nb * 8, kk * 16, lane);
      tc::mma_bf16(s[nb], af, b[0], b[1]);
      tc::mma_bf16(s[nb + 1], af, b[2], b[3]);
    }
  }
}

// Forward: one block a (b * Hq + h, tile of 64 query rows), a warp 16 rows.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
fwd_mma_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NB = kKeys / 8;
  constexpr int OB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // kRows x LD
  bf16* sK = sQ + kRows * LD;                      // 2 x kKeys x LD
  bf16* sV = sK + 2 * kKeys * LD;                  // 2 x kKeys x LD
  count_launch(kForward, kMma);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // heavy tiles first
  const bf16* qh = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int tb, te;
  key_tiles(a, q0, kRows, kKeys, tb, te);

  load_rows<kRows, DP>(sQ, qh, a.q_ss, q0, a.S, a.D);
  load_rows<kKeys, DP>(sK, kh, a.k_st, tb * kKeys, a.T, a.D);
  load_rows<kKeys, DP>(sV, vh, a.v_st, tb * kKeys, a.T, a.D);
  tc::cp_async_commit();

  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  for (int it = tb; it < te; ++it) {
    const int st = (it - tb) & 1;
    const int k0 = it * kKeys;
    if (it + 1 < te) {
      load_rows<kKeys, DP>(sK + (st ^ 1) * kKeys * LD, kh, a.k_st, k0 + kKeys,
                           a.T, a.D);
      load_rows<kKeys, DP>(sV + (st ^ 1) * kKeys * LD, vh, a.v_st, k0 + kKeys,
                           a.T, a.D);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * kKeys * LD;
    const bf16* cV = sV + st * kKeys * LD;

    float s[NB][4];
    mma_nt<DP, NB>(s, sQ, warp * 16, cK, lane);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float th;
        s[nb][e] = masked_score(a, s[nb][e], row[e >> 1],
                                k0 + nb * 8 + 2 * t + (e & 1), th);
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      corr[hh] = expf(m[hh] - mx[hh]);   // 0 on the first tile (m = -inf)
      m[hh] = mx[hh];
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = expf(s[nb][e] - m[e >> 1]);
        l[e >> 1] += s[nb][e];
      }
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
    mma_split<DP, kKeys / 16>(acc, s, cV, lane);
    __syncthreads();   // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  bf16* o = static_cast<bf16*>(a.o);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row[hh];
    if (r >= a.S) continue;
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= a.D) continue;
      const float v0 = __fdiv_rn(acc[j][2 * hh], l[hh]);
      const float v1 = __fdiv_rn(acc[j][2 * hh + 1], l[hh]);
      *reinterpret_cast<uint32_t*>(o + base + c) = tc::pack_bf16(v0, v1);
      *reinterpret_cast<float2*>(a.o32 + base + c) = make_float2(v0, v1);
    }
    if (t == 0)
      a.lse[((long long)b * a.Hq + h) * a.S + r] = m[hh] + logf(l[hh]);
  }
}

// dQ: one block a (b * Hq + h, tile of 64 query rows), a warp 16 rows.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads, 1)
dq_mma_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NB = kKeys / 8;
  constexpr int OB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // kRows x LD
  bf16* sO = sQ + kRows * LD;                      // dO: kRows x LD
  bf16* sK = sO + kRows * LD;                      // 2 x kKeys x LD
  bf16* sV = sK + 2 * kKeys * LD;                  // 2 x kKeys x LD
  count_launch(kDq, kMma);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long row_ld = (long long)a.Hq * a.D;   // dO, dQ: contiguous
  const bf16* qh = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* oh = static_cast<const bf16*>(a.dout) +
                   (long long)b * a.S * row_ld + (long long)h * a.D;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int tb, te;
  key_tiles(a, q0, kRows, kKeys, tb, te);

  load_rows<kRows, DP>(sQ, qh, a.q_ss, q0, a.S, a.D);
  load_rows<kRows, DP>(sO, oh, row_ld, q0, a.S, a.D);
  load_rows<kKeys, DP>(sK, kh, a.k_st, tb * kKeys, a.T, a.D);
  load_rows<kKeys, DP>(sV, vh, a.v_st, tb * kKeys, a.T, a.D);
  tc::cp_async_commit();

  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long long i = ((long long)b * a.Hq + h) * a.S + row[hh];
    lse[hh] = row[hh] < a.S ? a.lse[i] : 0.f;
    delta[hh] = row[hh] < a.S ? a.delta[i] : 0.f;
  }
  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = tb; it < te; ++it) {
    const int st = (it - tb) & 1;
    const int k0 = it * kKeys;
    if (it + 1 < te) {
      load_rows<kKeys, DP>(sK + (st ^ 1) * kKeys * LD, kh, a.k_st, k0 + kKeys,
                           a.T, a.D);
      load_rows<kKeys, DP>(sV + (st ^ 1) * kKeys * LD, vh, a.v_st, k0 + kKeys,
                           a.T, a.D);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * kKeys * LD;
    const bf16* cV = sV + st * kKeys * LD;

    float s[NB][4], dp[NB][4];
    mma_nt<DP, NB>(s, sQ, warp * 16, cK, lane);
    mma_nt<DP, NB>(dp, sO, warp * 16, cV, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float th;
        const float x = masked_score(a, s[nb][e], row[e >> 1],
                                     k0 + nb * 8 + 2 * t + (e & 1), th);
        const float p = expf(x - lse[e >> 1]);
        s[nb][e] = product_grad(a, p, dp[nb][e], delta[e >> 1], th);
      }
    mma_split<DP, kKeys / 16>(acc, s, cK, lane);
    __syncthreads();
  }

  bf16* dq = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row[hh];
    if (r >= a.S) continue;
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < a.D)
        *reinterpret_cast<uint32_t*>(dq + base + c) =
            tc::pack_bf16(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// dK, dV: one block a (b * Hkv + kv head, tile of 64 keys), a warp 16 keys;
// the block walks the G query heads of its kv head, each over the query
// tiles of BQ rows that see its keys, in that order.
template <int DP, int BQ>
__global__ void __launch_bounds__(kMmaThreads, 1)
dkdv_mma_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NQ = BQ / 8;
  constexpr int OB = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);   // kRows x LD
  bf16* sV = sK + kRows * LD;                      // kRows x LD
  bf16* sQ = sV + kRows * LD;                      // 2 x BQ x LD
  bf16* sO = sQ + 2 * BQ * LD;                     // dO: 2 x BQ x LD
  float* sLse = reinterpret_cast<float*>(sO + 2 * BQ * LD);   // 2 x BQ
  float* sDelta = sLse + 2 * BQ;                               // 2 x BQ
  count_launch(kDkdv, kMma);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x - b * a.Hkv;
  const int k0 = blockIdx.y * kRows;   // the long causal key tiles first
  const long long row_ld = (long long)a.Hq * a.D;
  const bf16* kh = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* vh = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int qb, qe;
  query_tiles(a, k0, kRows, BQ, qb, qe);
  const int per_head = qe - qb;
  const int items = a.G * per_head;

  // item i: query head hk * G + i / per_head, query tile qb + i % per_head
  auto load_item = [&](int i, int st) {
    const int h = hk * a.G + i / per_head;
    const int q0 = (qb + i % per_head) * BQ;
    load_rows<BQ, DP>(sQ + st * BQ * LD,
                      static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh,
                      a.q_ss, q0, a.S, a.D);
    load_rows<BQ, DP>(sO + st * BQ * LD,
                      static_cast<const bf16*>(a.dout) +
                          (long long)b * a.S * row_ld + (long long)h * a.D,
                      row_ld, q0, a.S, a.D);
    for (int j = threadIdx.x; j < BQ; j += kMmaThreads) {
      const long long r = ((long long)b * a.Hq + h) * a.S + q0 + j;
      const bool ok = q0 + j < a.S;
      sLse[st * BQ + j] = ok ? a.lse[r] : 0.f;
      sDelta[st * BQ + j] = ok ? a.delta[r] : 0.f;
    }
  };

  load_rows<kRows, DP>(sK, kh, a.k_st, k0, a.T, a.D);
  load_rows<kRows, DP>(sV, vh, a.v_st, k0, a.T, a.D);
  if (items > 0) load_item(0, 0);
  tc::cp_async_commit();

  float dk[OB][4], dv[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  for (int i = 0; i < items; ++i) {
    const int st = i & 1;
    const int q0 = (qb + i % per_head) * BQ;
    if (i + 1 < items) {
      load_item(i + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + st * BQ * LD;
    const bf16* cO = sO + st * BQ * LD;
    const float* cLse = sLse + st * BQ;
    const float* cDelta = sDelta + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T for this warp's keys (rows) and the
    // tile's queries (columns)
    float s[NQ][4], dp[NQ][4];
    mma_nt<DP, NQ>(s, sK, warp * 16, cQ, lane);
    mma_nt<DP, NQ>(dp, sV, warp * 16, cO, lane);
#pragma unroll
    for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + 2 * t + (e & 1);   // query within the tile
        if (q0 + c >= a.S) {   // a padded query row: no weight, no grad
          s[nb][e] = 0.f;
          dp[nb][e] = 0.f;
          continue;
        }
        float th;
        const float x = masked_score(a, s[nb][e], q0 + c, key[e >> 1], th);
        const float p = expf(x - cLse[c]);
        dp[nb][e] = product_grad(a, p, dp[nb][e], cDelta[c], th);
        s[nb][e] = p;
      }
    mma_split<DP, BQ / 16>(dv, s, cO, lane);    // dV += P^T dO
    mma_split<DP, BQ / 16>(dk, dp, cQ, lane);   // dK += dS^T Q
    __syncthreads();
  }

  bf16* dkp = static_cast<bf16*>(a.dk);
  bf16* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = key[hh];
    if (r >= a.T) continue;
    const long long base = (((long long)b * a.T + r) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= a.D) continue;
      *reinterpret_cast<uint32_t*>(dkp + base + c) =
          tc::pack_bf16(dk[j][2 * hh], dk[j][2 * hh + 1]);
      *reinterpret_cast<uint32_t*>(dvp + base + c) =
          tc::pack_bf16(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
}

// The dK dV pass's query tile: 16 rows at DP = 128 (its dK and dV
// accumulators take 128 registers a thread; at 32 rows ptxas spilled),
// else 64.
template <int DP>
constexpr int dkdv_rows() { return DP > 80 ? 16 : 64; }

template <int DP>
cudaError_t launch_mma_forward(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(bf16) * (kRows + 4 * kKeys) * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hq, (a.S + kRows - 1) / kRows);
  fwd_mma_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma_backward(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.S * a.Hq;
  delta_kernel<bf16><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dq_smem = (int)sizeof(bf16) * (2 * kRows + 4 * kKeys) * (DP + 8);
  err = cudaFuncSetAttribute(dq_mma_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return err;
  dq_mma_kernel<DP><<<dim3(a.B * a.Hq, (a.S + kRows - 1) / kRows),
                      kMmaThreads, dq_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr int BQ = dkdv_rows<DP>();
  const int kv_smem = (int)sizeof(bf16) * (2 * kRows + 4 * BQ) * (DP + 8) +
                      (int)sizeof(float) * 4 * BQ;
  err = cudaFuncSetAttribute(dkdv_mma_kernel<DP, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_mma_kernel<DP, BQ><<<dim3(a.B * a.Hkv, (a.T + kRows - 1) / kRows),
                            kMmaThreads, kv_smem, stream>>>(a);
  return cudaGetLastError();
}

// --------------------------------------------------------- scalar_f32

constexpr int kF32Threads = 256;   // a 16 x 16 thread grid over each tile

// Rows [r0, r0 + rows) (those below n) of a head of a strided f32 tensor
// whose rows are `ld` apart into shared memory with row stride D + 1; the
// rest zero.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* head,
                                              long long ld, int r0, int rows,
                                              int n, int D) {
  for (int i = threadIdx.x; i < rows * D; i += kF32Threads) {
    const int r = i / D;
    const int c = i - r * D;
    dst[r * (D + 1) + c] = r0 + r < n ? head[(r0 + r) * ld + c] : 0.f;
  }
}

// Forward: BQ query rows a block, BK keys a tile; the thread owns rows
// ty + 16 i and output columns tx + 16 j (j < NJ, so D <= 16 NJ).
template <int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kF32Threads)
fwd_f32_kernel(const Args a) {
  constexpr int RI = BQ / 16, CJ = BK / 16;
  constexpr int TPR = kF32Threads / BQ;   // threads a row in the softmax
  constexpr int LS = BK + 1;
  extern __shared__ float smem[];
  const int ld = a.D + 1;
  float* sQ = smem;               // BQ x ld
  float* sK = sQ + BQ * ld;       // BK x ld
  float* sV = sK + BK * ld;       // BK x ld
  float* sS = sV + BK * ld;       // BQ x LS: scores, then probabilities
  float* sM = sS + BQ * LS;       // running max a row
  float* sL = sM + BQ;            // running denominator a row
  float* sC = sL + BQ;            // this tile's rescale factor a row
  count_launch(kForward, kF32);

  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float* qh = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32(sQ, qh, a.q_ss, q0, BQ, a.S, a.D);
  for (int r = threadIdx.x; r < BQ; r += kF32Threads) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int tb, te;
  key_tiles(a, q0, BQ, BK, tb, te);
  for (int it = tb; it < te; ++it) {
    const int k0 = it * BK;
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_rows_f32(sK, kh, a.k_st, k0, BK, a.T, a.D);
    load_rows_f32(sV, vh, a.v_st, k0, BK, a.T, a.D);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sQ[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = sK[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        float th;
        sS[(ty + 16 * i) * LS + tx + 16 * j] = masked_score(
            a, s[i][j], q0 + ty + 16 * i, k0 + tx + 16 * j, th);
      }
    __syncthreads();

    {   // online softmax: TPR threads a row, reduced by shuffles
      const int r = threadIdx.x / TPR;
      const int gi = threadIdx.x % TPR;
      float* srow = sS + r * LS;
      float mx = -INFINITY;
      for (int c = gi; c < BK; c += TPR) mx = fmaxf(mx, srow[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = gi; c < BK; c += TPR) {
        const float p = expf(srow[c] - m_new);
        srow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (gi == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    const int kn = min(BK, a.T - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sS[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < a.D ? sV[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  float* o = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.S) continue;
    const float lr = sL[ty + 16 * i];
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.D) o[base + col] = __fdiv_rn(acc[i][j], lr);
    }
    if (tx == 0)
      a.lse[((long long)b * a.Hq + h) * a.S + r] = sM[ty + 16 * i] + logf(lr);
  }
}

// dQ: BQ query rows a block, BK keys a tile; the thread owns rows ty + 16 i
// and columns tx + 16 j (score columns j < BK / 16, dQ columns j < NJ).
template <int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kF32Threads)
dq_f32_kernel(const Args a) {
  constexpr int RI = BQ / 16, CJ = BK / 16;
  constexpr int LS = BK + 1;
  extern __shared__ float smem[];
  const int ld = a.D + 1;
  float* sQ = smem;               // BQ x ld
  float* sO = sQ + BQ * ld;       // dO: BQ x ld
  float* sK = sO + BQ * ld;       // BK x ld
  float* sV = sK + BK * ld;       // BK x ld
  float* sG = sV + BK * ld;       // BQ x LS: the products' grads
  float* sLse = sG + BQ * LS;     // BQ
  float* sDelta = sLse + BQ;      // BQ
  count_launch(kDq, kF32);

  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long row_ld = (long long)a.Hq * a.D;
  const float* qh = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* oh = static_cast<const float*>(a.dout) +
                    (long long)b * a.S * row_ld + (long long)h * a.D;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32(sQ, qh, a.q_ss, q0, BQ, a.S, a.D);
  load_rows_f32(sO, oh, row_ld, q0, BQ, a.S, a.D);
  for (int r = threadIdx.x; r < BQ; r += kF32Threads) {
    const long long i = ((long long)b * a.Hq + h) * a.S + q0 + r;
    sLse[r] = q0 + r < a.S ? a.lse[i] : 0.f;
    sDelta[r] = q0 + r < a.S ? a.delta[i] : 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  int tb, te;
  key_tiles(a, q0, BQ, BK, tb, te);
  for (int it = tb; it < te; ++it) {
    const int k0 = it * BK;
    __syncthreads();
    load_rows_f32(sK, kh, a.k_st, k0, BK, a.T, a.D);
    load_rows_f32(sV, vh, a.v_st, k0, BK, a.T, a.D);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < a.D; ++d) {
      float qv[RI], ov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = sQ[(ty + 16 * i) * ld + d];
        ov[i] = sO[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = sK[(tx + 16 * j) * ld + d];
        vv[j] = sV[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i;
        float th;
        const float x = masked_score(a, s[i][j], q0 + r, k0 + tx + 16 * j, th);
        const float p = expf(x - sLse[r]);
        sG[r * LS + tx + 16 * j] = product_grad(a, p, dp[i][j], sDelta[r], th);
      }
    __syncthreads();

    const int kn = min(BK, a.T - k0);
    for (int c = 0; c < kn; ++c) {
      float gv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) gv[i] = sG[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float kv = col < a.D ? sK[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(gv[i], kv, acc[i][j]);
      }
    }
  }

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.S) continue;
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.D) dq[base + col] = acc[i][j];
    }
  }
}

// dK, dV: BK keys a block (one kv head), BQ queries a tile; the thread owns
// keys ty + 16 i and columns tx + 16 j.  The G query heads of the kv head
// in order, each over its visible query tiles.
template <int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kF32Threads)
dkdv_f32_kernel(const Args a) {
  constexpr int RI = BK / 16, CJ = BQ / 16;
  constexpr int LS = BQ + 1;
  extern __shared__ float smem[];
  const int ld = a.D + 1;
  float* sK = smem;               // BK x ld
  float* sV = sK + BK * ld;       // BK x ld
  float* sQ = sV + BK * ld;       // BQ x ld
  float* sO = sQ + BQ * ld;       // dO: BQ x ld
  float* sP = sO + BQ * ld;       // BK x LS
  float* sG = sP + BK * LS;       // BK x LS
  float* sLse = sG + BK * LS;     // BQ
  float* sDelta = sLse + BQ;      // BQ
  count_launch(kDkdv, kF32);

  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x - b * a.Hkv;
  const int k0 = blockIdx.y * BK;
  const long long row_ld = (long long)a.Hq * a.D;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows_f32(sK, kh, a.k_st, k0, BK, a.T, a.D);
  load_rows_f32(sV, vh, a.v_st, k0, BK, a.T, a.D);
  float dk[RI][NJ], dv[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  int qb, qe;
  query_tiles(a, k0, BK, BQ, qb, qe);
  for (int gi = 0; gi < a.G; ++gi) {
    const int h = hk * a.G + gi;
    const float* qh = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* oh = static_cast<const float*>(a.dout) +
                      (long long)b * a.S * row_ld + (long long)h * a.D;
    for (int qt = qb; qt < qe; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // the previous tile's Q, dO, P and dS are consumed
      load_rows_f32(sQ, qh, a.q_ss, q0, BQ, a.S, a.D);
      load_rows_f32(sO, oh, row_ld, q0, BQ, a.S, a.D);
      for (int r = threadIdx.x; r < BQ; r += kF32Threads) {
        const long long i = ((long long)b * a.Hq + h) * a.S + q0 + r;
        sLse[r] = q0 + r < a.S ? a.lse[i] : 0.f;
        sDelta[r] = q0 + r < a.S ? a.delta[i] : 0.f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < a.D; ++d) {
        float kv[RI], vv[RI], qv[CJ], ov[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          kv[i] = sK[(ty + 16 * i) * ld + d];
          vv[i] = sV[(ty + 16 * i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          qv[j] = sQ[(tx + 16 * j) * ld + d];
          ov[j] = sO[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int c = tx + 16 * j;      // query within the tile
          float p = 0.f, gs = 0.f;
          if (q0 + c < a.S) {
            float th;
            const float x = masked_score(a, s[i][j], q0 + c,
                                         k0 + ty + 16 * i, th);
            p = expf(x - sLse[c]);
            gs = product_grad(a, p, dp[i][j], sDelta[c], th);
          }
          sP[(ty + 16 * i) * LS + c] = p;
          sG[(ty + 16 * i) * LS + c] = gs;
        }
      __syncthreads();

      const int qn = min(BQ, a.S - q0);
      for (int c = 0; c < qn; ++c) {
        float pv[RI], gv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pv[i] = sP[(ty + 16 * i) * LS + c];
          gv[i] = sG[(ty + 16 * i) * LS + c];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int col = tx + 16 * j;
          const float ov = col < a.D ? sO[c * ld + col] : 0.f;
          const float qv = col < a.D ? sQ[c * ld + col] : 0.f;
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            dv[i][j] = fmaf(pv[i], ov, dv[i][j]);
            dk[i][j] = fmaf(gv[i], qv, dk[i][j]);
          }
        }
      }
    }
  }

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= a.T) continue;
    const long long base = (((long long)b * a.T + r) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < a.D) {
        dkp[base + col] = dk[i][j];
        dvp[base + col] = dv[i][j];
      }
    }
  }
}

template <int BQ, int BK, int NJ>
cudaError_t launch_f32_forward(const Args& a, cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   ((BQ + 2 * BK) * (a.D + 1) + BQ * (BK + 1) + 3 * BQ);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_f32_kernel<BQ, BK, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  fwd_f32_kernel<BQ, BK, NJ><<<dim3(a.B * a.Hq, (a.S + BQ - 1) / BQ),
                               kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BQ, int BK, int NJ>
cudaError_t launch_f32_backward(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.S * a.Hq;
  delta_kernel<float><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int dq_smem = (int)sizeof(float) *
                      ((2 * BQ + 2 * BK) * (a.D + 1) + BQ * (BK + 1) + 2 * BQ);
  err = cudaFuncSetAttribute(dq_f32_kernel<BQ, BK, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem);
  if (err != cudaSuccess) return err;
  dq_f32_kernel<BQ, BK, NJ><<<dim3(a.B * a.Hq, (a.S + BQ - 1) / BQ),
                              kF32Threads, dq_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int kv_smem = (int)sizeof(float) *
                      ((2 * BK + 2 * BQ) * (a.D + 1) + 2 * BK * (BQ + 1) +
                       2 * BQ);
  err = cudaFuncSetAttribute(dkdv_f32_kernel<BQ, BK, NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  dkdv_f32_kernel<BQ, BK, NJ><<<dim3(a.B * a.Hkv, (a.T + BK - 1) / BK),
                                kF32Threads, kv_smem, stream>>>(a);
  return cudaGetLastError();
}

// The route's instance for the head dim, forward or backward.
cudaError_t dispatch(const Args& a, int route, bool backward,
                     cudaStream_t stream) {
  if (route == kMma) {
    if (a.D % 8 || a.D > 128) return cudaErrorInvalidValue;
    if (a.D <= 32)
      return backward ? launch_mma_backward<32>(a, stream)
                      : launch_mma_forward<32>(a, stream);
    if (a.D <= 64)
      return backward ? launch_mma_backward<64>(a, stream)
                      : launch_mma_forward<64>(a, stream);
    if (a.D <= 80)
      return backward ? launch_mma_backward<80>(a, stream)
                      : launch_mma_forward<80>(a, stream);
    return backward ? launch_mma_backward<128>(a, stream)
                    : launch_mma_forward<128>(a, stream);
  }
  if (route == kF32) {
    if (a.D > 256) return cudaErrorInvalidValue;
    if (a.D <= 64)
      return backward ? launch_f32_backward<64, 64, 4>(a, stream)
                      : launch_f32_forward<64, 64, 4>(a, stream);
    if (a.D <= 128)
      return backward ? launch_f32_backward<64, 64, 8>(a, stream)
                      : launch_f32_forward<64, 64, 8>(a, stream);
    return backward ? launch_f32_backward<32, 32, 16>(a, stream)
                    : launch_f32_forward<32, 32, 16>(a, stream);
  }
  return cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, int B, int S,
               int T, int Hq, int Hkv, int D, const long long* qs,
               const long long* ks, const long long* vs, int causal,
               int window, float cap, float inv_cap, float inv_sqrt_d) {
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.S = S;
  a.T = T;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.G = Hq / Hkv;
  a.D = D;
  a.q_sb = qs[0];
  a.q_ss = qs[1];
  a.q_sh = qs[2];
  a.k_sb = ks[0];
  a.k_st = ks[1];
  a.k_sh = ks[2];
  a.v_sb = vs[0];
  a.v_st = vs[1];
  a.v_sh = vs[2];
  a.causal = causal;
  a.window = window;
  a.cap = cap;
  a.inv_cap = inv_cap;
  a.inv_sqrt_d = inv_sqrt_d;
  return a;
}

}  // namespace

// q: (B, S, Hq, D), k and v: (B, T, Hkv, D), in the model's layout with
// the strides (batch, row, head) in elements and the last dim contiguous
// (qs, ks, vs: three each); route 0 (mma_bf16: bf16, rows 16-byte aligned)
// or 1 (scalar_f32: f32).  Writes o (B, S, Hq, D) in the inputs' dtype, o32
// (f32; on route 1 pass o) and lse (B, Hq, S), all contiguous.  cap 0 is
// no cap; inv_cap and inv_sqrt_d are the f32 reciprocals of cap and
// sqrt(D).  The wrapper checks shapes, Hq % Hkv == 0 and S == T where
// causal or window > 0.
extern "C" int train_attention_forward(
    const void* q, const void* k, const void* v, void* o, float* o32,
    float* lse, int B, int S, int T, int Hq, int Hkv, int D,
    const long long* qs, const long long* ks, const long long* vs,
    int causal, int window, float cap, float inv_cap, float inv_sqrt_d,
    int route, void* stream) {
  Args a = make_args(q, k, v, B, S, T, Hq, Hkv, D, qs, ks, vs, causal,
                     window, cap, inv_cap, inv_sqrt_d);
  a.o = o;
  a.o32 = o32;
  a.lse = lse;
  return static_cast<int>(
      dispatch(a, route, false, static_cast<cudaStream_t>(stream)));
}

// The backward of a forward with the same arguments: dout (B, S, Hq, D)
// contiguous in the inputs' dtype, o32 and lse the forward's, delta a (B,
// Hq, S) f32 scratch; writes dq (B, S, Hq, D), dk and dv (B, T, Hkv, D),
// contiguous, in the inputs' dtype.  Three launches: delta, dQ, dK dV.
extern "C" int train_attention_backward(
    const void* q, const void* k, const void* v, const float* o32,
    const float* lse, const void* dout, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int Hq, int Hkv, int D,
    const long long* qs, const long long* ks, const long long* vs,
    int causal, int window, float cap, float inv_cap, float inv_sqrt_d,
    int route, void* stream) {
  Args a = make_args(q, k, v, B, S, T, Hq, Hkv, D, qs, ks, vs, causal,
                     window, cap, inv_cap, inv_sqrt_d);
  a.o32 = const_cast<float*>(o32);
  a.lse = const_cast<float*>(lse);
  a.dout = dout;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  return static_cast<int>(
      dispatch(a, route, true, static_cast<cudaStream_t>(stream)));
}

// Launches of kernel (0 forward, 1 delta, 2 dK dV, 3 dQ) on route (0
// mma_bf16, 1 scalar_f32) counted on the device since the library was
// loaded; ~0 on a bad argument or a failed copy.
extern "C" unsigned long long train_attention_launches(int kernel, int route) {
  if (kernel < 0 || kernel >= kKernels || route < 0 || route >= kRoutes)
    return ~0ull;
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n),
                           (kernel * kRoutes + route) * sizeof(n)) !=
      cudaSuccess)
    return ~0ull;
  return n;
}
