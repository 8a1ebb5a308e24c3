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
// - wgmma_bf16 (bf16 q, k, v at D = 64 and 128): warp-specialised for
//   Hopper.  Each kernel is a block of 384 threads: a producer warpgroup,
//   whose one thread issues every TMA load through rings of stages with
//   full and empty mbarriers, and two consumer warpgroups of 64 rows each
//   (setmaxnreg moves registers from the producer to them) that take turns
//   to issue their wgmma products (named barriers), so that one's exact
//   softmax runs under the other's products.  q, k, v are read where they
//   lie through 4-D TMA maps (D, H, S, B) with the tensors' own strides; a
//   row of D = 128 is two 64-column boxes in the 128-byte swizzle.
//   Forward: a work item is (b, h, 128 query rows); S = Q K^T is wgmma
//   m64n64k16 from shared memory over 64-key tiles, the exact scale, cap,
//   mask and online softmax run on the accumulator registers, P's hi and lo
//   halves are packed in place as the register A operand of two wgmmas into
//   O (V MN-major through the transpose bit); tile j + 1's Q K^T and tile
//   j's P V are in flight while tile j + 1's softmax runs.  o and o32 are
//   staged in swizzled shared memory and stored by TMA, clipped at S; a
//   persistent grid deals the heavy causal items first in zigzag rounds.
//   dQ: the same items and K / V ring; S and dP = dO V^T from shared
//   memory, dS's hi and lo halves into dQ += dS K (K MN-major).  dK dV: a
//   block owns 128 keys (64 a consumer warpgroup) and walks the G query
//   heads of its kv head in order, then their 64-row query tiles (Q and dO
//   by TMA, the log-sum-exp and delta by a producer warp's loads, through
//   one ring); S^T = K Q^T and dP^T = V dO^T from shared memory, P^T and
//   dS^T (hi and lo) the register A operands of dV += P^T dO and dK +=
//   dS^T Q (dO and Q MN-major); dK and dV are staged where K and V were
//   and stored by TMA.  Built with
//   -DTRAIN_ATTN_FORCE_MMA the route runs mma_bf16 at every shape (and
//   counts there): the old route, for timing in turns.
// - mma_bf16 (bf16 q, k, v with D a multiple of 8 up to 128): the tensor
//   cores through mma.sync m16n8k16 from ldmatrix fragments, f32
//   accumulation, K / V (forward, dQ) or Q / dO (dK dV) tiles in a 2-stage
//   cp.async ring, D zero-padded to DP (32, 64, 80 or 128).  bf16 x bf16
//   products are exact in f32, so Q K^T and dO V^T are the reference's
//   products up to the order of the f32 sums.  The f32 operands, P and dS,
//   enter P V, P^T dO, dS K and dS^T Q as a hi and a lo bf16 half (two
//   products against the same fragment of the other operand): ~16 mantissa
//   bits, where one bf16 rounding would move the result by ~2^-9 of it.
// - mma_3xtf32 (f32 q, k, v with D a multiple of 8 up to 128; whisper's
//   bf16 q against the f32 encoder's k and v comes here after an exact
//   upcast): every product, Q K^T, P V, dO V^T, dS K, dS^T Q and P^T dO, on
//   the tensor cores as a split-f32 product (f32_split.cuh: each operand
//   as a TF32 big part and a TF32 remainder, three mma.sync m16n8k8.tf32
//   products, ~21 bits a product; one TF32 rounding keeps 11 and misses the
//   f32 tolerance).  Blocks of 32 query rows (dK dV: keys) in two strips
//   of 16, each worked by two warps that split its 32-key tiles (dK dV:
//   query tiles of 32 rows, 16 at D = 128) and merge at the end, tiles by
//   cp.async, the fragments loaded from f32 tiles whose row stride avoids
//   bank conflicts; kernels templated on the cap; the dQ kernel computes
//   delta, so a backward is two launches.
//   The softmax, the mask and the grads are scalar_f32's, op for op.  Built
//   with -DTRAIN_ATTN_FORCE_SCALAR the route runs scalar_f32 (and counts
//   there): the old route, for timing in turns.
// - scalar_f32 (f32 q, k, v at the other head dims up to 256, the wrapper
//   taking bf16 there after an exact upcast): scalar f32 FMAs from f32
//   shared-memory tiles.
//
// Four kernels a route (mma_3xtf32: three, delta inside dQ): the forward
// (o in the inputs' dtype, the f32 output o32 for the backward (o itself
// on the f32 routes) and the f32 log-sum-exp of each row); delta =
// rowsum(dO o32); dK dV over key tiles,
// one block a (b, kv head, key tile) that sums the G query heads of its kv
// head in a fixed order; dQ over query tiles.  Both backward passes
// recompute P = exp(x - lse).  Each grad is summed in f32 and rounded once
// to the inputs' dtype.  No float atomics: the same bits on every run.
//
// Positions: the mask compares row and column indices, which equals the
// reference's mask on positions wherever they are arange (the callers say
// so: models.attention._attend takes these kernels for a masked call only
// then; the causal and windowed calls need S == T, which the wrapper
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

#include "f32_split.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using tc::bf16;

constexpr float kMasked = -1e30f;   // the reference's mask value

enum Kernel { kForward, kDelta, kDkdv, kDq, kKernels };
enum Route { kMma, kF32, kWgmma, kX3, kRoutes };
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
// CAP: 1 the cap is compiled in, 0 out (the wgmma_bf16 kernels, one
// instance each, so that a kernel without a cap carries no tanhf code in
// its unrolled loops), -1 the cap read at run time (the other routes).
template <int CAP = -1>
__device__ __forceinline__ float scaled_score(const Args& a, float s,
                                              float& th) {
  float x = __fmul_rn(s, a.inv_sqrt_d);
  th = 0.f;
  if (CAP == 1 || (CAP == -1 && a.cap != 0.f)) {
    th = tanhf(__fmul_rn(x, a.inv_cap));
    x = __fmul_rn(a.cap, th);
  }
  return x;
}

// The mask on a scaled score x at (row, col).
__device__ __forceinline__ float mask_score(const Args& a, float x, int row,
                                            int col) {
  if (col >= a.T) return -INFINITY;
  return visible(a, row, col) ? x : kMasked;
}

template <int CAP = -1>
__device__ __forceinline__ float masked_score(const Args& a, float s, int row,
                                              int col, float& th) {
  return mask_score(a, scaled_score<CAP>(a, s, th), row, col);
}

// The grad of the raw product q . k from P and dP = dO . v of its pair:
// softmax's P (dP - delta), then back through the cap (cap * g * (1 - th^2)
// / cap, autograd's order) and the divide by sqrt(D).
template <int CAP = -1>
__device__ __forceinline__ float product_grad(const Args& a, float p,
                                              float dp, float delta,
                                              float th) {
  float g = __fmul_rn(p, __fsub_rn(dp, delta));
  if (CAP == 1 || (CAP == -1 && a.cap != 0.f))
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
template <typename T, Route R>
__global__ void __launch_bounds__(256) delta_kernel(const Args a) {
  count_launch(kDelta, R);
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
  delta_kernel<bf16, kMma><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
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

// ---------------------------------------------------------- wgmma_bf16

constexpr int kWgThreads = 384;   // a producer and two consumer warpgroups
constexpr int kWgItem = 128;      // query rows (forward, dQ) or keys (dK dV)
                                  // a work item, 64 a consumer warpgroup
constexpr int kWgTile = 64;       // keys a tile (forward, dQ), query rows a
                                  // tile (dK dV)
constexpr int kWgBox = 8192;      // bytes of a 64-row x 128-byte box
// setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536; dK
// dV, whose consumers hold dK and dV (128 f32 a thread at D = 128) beside
// S^T and dP^T, 2 x 128 x 240 + 128 x 24
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kDkdvConsumerRegs = 240;
constexpr int kDkdvProducerRegs = 24;
// One block an SM walks the forward's and dQ's work items in zigzag rounds
// while there are at most this many items an SM; past that, one block an
// item (as serve flash's wgmma route).
constexpr int kPersistentItemsPerSm = 8;

// Ring stages: K and V tiles (forward, dQ), Q / dO / lse / delta tiles (dK
// dV).  dQ holds each K tile until its dQ product is done, so it keeps a
// third stage in flight.  (More stages changed no time at codeqwen's train
// shape: the loads are not what holds these kernels, PERF.md.)
constexpr int kFwdStages = 2;
constexpr int kDqStages = 3;
constexpr int kDkdvStages = 2;

// Byte offset of the 16-byte chunk `chunk` of row r in a box of 128-byte
// rows written or read by TMA in the 128-byte swizzle.
__device__ __forceinline__ int sw128(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// A consumer warpgroup's 64 x D accumulator tile (rows 16 warp + g and + 8)
// as bf16 into D / 64 swizzled boxes of 64 rows x 64 columns, `box` bytes
// apart, at dst.
template <int D>
__device__ __forceinline__ void stage_bf16(unsigned char* dst, int box,
                                           const float (&acc)[D / 2],
                                           int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = 16 * warp + g + 8 * hh;
      *reinterpret_cast<uint32_t*>(dst + (j / 8) * box + sw128(r, j % 8) +
                                   4 * t) =
          tc::pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
}

// A work item of the forward and dQ: (b, h, 128 query rows from q0), the
// key tiles [tb, tb + nt).  Items count from the last query tile of every
// head, so the long causal items come first.
struct WgItem {
  int b, h, hk, q0, tb, nt;
};

__device__ __forceinline__ WgItem wg_item(const Args& a, int w) {
  WgItem it;
  const int BH = a.B * a.Hq;
  const int n_q = (a.S + kWgItem - 1) / kWgItem;
  const int bh = w % BH;
  it.q0 = (n_q - 1 - w / BH) * kWgItem;
  it.b = bh / a.Hq;
  it.h = bh - it.b * a.Hq;
  it.hk = it.h / a.G;
  int te;
  key_tiles(a, it.q0, kWgItem, kWgTile, it.tb, te);
  it.nt = te - it.tb;
  return it;
}

// The work item of this block in round r (gridDim.x items a round), in
// zigzag: forward in even rounds, backward in odd ones, so the blocks'
// sums of heavy-first items come out even; n_items or more: none.
__device__ __forceinline__ int wg_round_item(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// A consumer warp's score tile (16 rows from r0, 64 columns from c0; in
// the accumulator layout s[4 j + e] sits at row r0 + g + 8 (e / 2), column
// c0 + 8 j + 2 t + e % 2) is wholly visible and inside the keys: no mask.
__device__ __forceinline__ bool tile_visible(const Args& a, int r0, int c0) {
  return c0 + kWgTile <= a.T && (!a.causal || c0 + kWgTile - 1 <= r0) &&
         (a.window <= 0 || r0 + 15 - c0 < a.window);
}

// The forward's online softmax of one 64-key tile in the accumulator
// registers s (the raw products q . k): the reference's score, then m, l
// and the rescale factors corr of the thread's two rows; leaves p = exp(x -
// m) in s.  The mma_bf16 kernel's arithmetic, op for op.
template <int CAP>
__device__ __forceinline__ void wg_softmax(const Args& a,
                                           float (&s)[kWgTile / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int r0, int k0,
                                           int g, int t) {
  const bool full = tile_visible(a, r0, k0);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kWgTile / 2; ++i) {
    float th;
    const int hh = (i >> 1) & 1;
    s[i] = scaled_score<CAP>(a, s[i], th);
    if (!full)
      s[i] = mask_score(a, s[i], r0 + g + 8 * hh,
                        k0 + (i >> 2) * 8 + 2 * t + (i & 1));
    mx[hh] = fmaxf(mx[hh], s[i]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    corr[hh] = expf(m[hh] - mx[hh]);   // 0 on the first tile (m = -inf)
    m[hh] = mx[hh];
    l[hh] *= corr[hh];
  }
#pragma unroll
  for (int i = 0; i < kWgTile / 2; ++i) {
    s[i] = expf(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// hi and lo bf16 halves of an f32 accumulator tile, packed in place as the
// register A operand of the next products (hopper.cuh's layout identity).
template <int N>
__device__ __forceinline__ void pack_halves(const float (&x)[N],
                                            uint32_t (&hi)[N / 2],
                                            uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    tc::pack_split_bf16(x[2 * j], x[2 * j + 1], hi[j], lo[j]);
}

// acc (64 x D) += A B over a 64-deep k: A as its hi and lo halves (two
// wgmmas against the same B for each k16 slice, hi first), B the 64 x D tile
// at bt, MN-major (D / 64 boxes of 64 rows x 64 columns).
template <int D>
__device__ __forceinline__ void wg_split_product(float (&acc)[D / 2],
                                                 const uint32_t (&hi)[16],
                                                 const uint32_t (&lo)[16],
                                                 const bf16* bt) {
#pragma unroll
  for (int kk = 0; kk < kWgTile / 16; ++kk) {
    const uint64_t db =
        hopper::desc_sw128(bt + kk * 16 * 64, kWgTile * 128, 1024);
    const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                            hi[4 * kk + 3]};
    const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                            lo[4 * kk + 3]};
    hopper::wgmma_rs_tb<D>(acc, ah, db);
    hopper::wgmma_rs_tb<D>(acc, al, db);
  }
}

// acc (64 x 64) = A B^T over k = D: A 64 rows of a K-major tile at at whose
// boxes of 64 columns lie `a_box` elements apart, B the 64-row K-major tile
// at bt (boxes kWgTile x 64 apart).
template <int D>
__device__ __forceinline__ void wg_nt_product(float (&acc)[kWgTile / 2],
                                              const bf16* at, int a_box,
                                              const bf16* bt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<kWgTile>(
        acc,
        hopper::desc_sw128(at + (kk / 4) * a_box + (kk % 4) * 16, 16, 1024),
        hopper::desc_sw128(bt + (kk / 4) * kWgTile * 64 + (kk % 4) * 16, 16,
                           1024),
        kk > 0);
}

// Two split products, their wgmmas interleaved (acc1's hi, acc2's hi,
// acc1's lo, acc2's lo for each k16 slice): neither chain waits on its own
// accumulator between two wgmmas, and each keeps wg_split_product's order.
template <int D>
__device__ __forceinline__ void wg_split_product2(
    float (&acc1)[D / 2], const uint32_t (&hi1)[16],
    const uint32_t (&lo1)[16], const bf16* bt1, float (&acc2)[D / 2],
    const uint32_t (&hi2)[16], const uint32_t (&lo2)[16], const bf16* bt2) {
#pragma unroll
  for (int kk = 0; kk < kWgTile / 16; ++kk) {
    const uint64_t db1 =
        hopper::desc_sw128(bt1 + kk * 16 * 64, kWgTile * 128, 1024);
    const uint64_t db2 =
        hopper::desc_sw128(bt2 + kk * 16 * 64, kWgTile * 128, 1024);
    const uint32_t ah1[4] = {hi1[4 * kk], hi1[4 * kk + 1], hi1[4 * kk + 2],
                             hi1[4 * kk + 3]};
    const uint32_t al1[4] = {lo1[4 * kk], lo1[4 * kk + 1], lo1[4 * kk + 2],
                             lo1[4 * kk + 3]};
    const uint32_t ah2[4] = {hi2[4 * kk], hi2[4 * kk + 1], hi2[4 * kk + 2],
                             hi2[4 * kk + 3]};
    const uint32_t al2[4] = {lo2[4 * kk], lo2[4 * kk + 1], lo2[4 * kk + 2],
                             lo2[4 * kk + 3]};
    hopper::wgmma_rs_tb<D>(acc1, ah1, db1);
    hopper::wgmma_rs_tb<D>(acc2, ah2, db2);
    hopper::wgmma_rs_tb<D>(acc1, al1, db1);
    hopper::wgmma_rs_tb<D>(acc2, al2, db2);
  }
}

// Two products A B^T (wg_nt_product) with their wgmmas interleaved.
template <int D>
__device__ __forceinline__ void wg_nt_product2(float (&acc1)[kWgTile / 2],
                                               const bf16* at1,
                                               const bf16* bt1,
                                               float (&acc2)[kWgTile / 2],
                                               const bf16* at2,
                                               const bf16* bt2, int a_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int ao = (kk / 4) * a_box + (kk % 4) * 16;
    const int bo = (kk / 4) * kWgTile * 64 + (kk % 4) * 16;
    hopper::wgmma_ss<kWgTile>(acc1, hopper::desc_sw128(at1 + ao, 16, 1024),
                              hopper::desc_sw128(bt1 + bo, 16, 1024), kk > 0);
    hopper::wgmma_ss<kWgTile>(acc2, hopper::desc_sw128(at2 + ao, 16, 1024),
                              hopper::desc_sw128(bt2 + bo, 16, 1024), kk > 0);
  }
}

// Shared memory of the forward: Q (D / 64 boxes of 128 rows), ST stages of
// K and of V (boxes of 64 rows), each consumer warpgroup's o (D / 64 boxes)
// and o32 (D / 32 boxes of 32 f32) staging tiles, the mbarriers.
template <int D, int ST>
struct FwdSmem {
  static constexpr int kQ = kWgItem * D * 2;
  static constexpr int kKV = kWgTile * D * 2;
  static constexpr int kOWg = 64 * D * 2;
  static constexpr int kO32Wg = 64 * D * 4;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + ST * kKV;
  static constexpr int kO = kV + ST * kKV;
  static constexpr int kO32 = kO + 2 * kOWg;
  static constexpr int kBar = kO32 + 2 * kO32Wg;
  // + 1024: the base is rounded up to the swizzle's 1024-byte atom
  static constexpr int kBytes = kBar + (2 + 4 * ST) * 8 + 1024;
};

template <int D, int ST, int CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const __grid_constant__ CUtensorMap to32, const Args a,
                 int n_items) {
  using L = FwdSmem<D, ST>;
  constexpr int NB = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = reinterpret_cast<bf16*>(base + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(base + L::kV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  count_launch(kForward, kWgmma);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 8);     // one arrival a consumer warp
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
  if (wg == 0) {
    // producer: thread 0 issues the Q and K loads, thread 32 the V loads
    // (the consumers free a K stage a product earlier than a V stage); the
    // rings' counters run on across work items
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool qk = threadIdx.x == 0;
      uint64_t* full = qk ? k_full : v_full;
      uint64_t* empty = qk ? k_empty : v_empty;
      bf16* ring = qk ? sK : sV;
      const CUtensorMap* map = qk ? &tk : &tv;
      int kv = 0;
      for (int r = 0; r < rounds; ++r) {
        const int w = wg_round_item(r);
        if (w >= n_items) break;      // only in a last, partial round
        const WgItem it = wg_item(a, w);
        if (qk) {
          hopper::mbar_wait(q_empty, (r & 1) ^ 1);
          hopper::mbar_expect_tx(q_full, L::kQ);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_4d(sQ + j * kWgItem * 64, &tq, q_full, 64 * j,
                                it.h, it.q0, it.b);
        }
        for (int i = 0; i < it.nt; ++i, ++kv) {
          const int s = kv % ST;
          hopper::mbar_wait(&empty[s], ((kv / ST) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], L::kKV);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_4d(ring + s * kWgTile * D + j * kWgTile * 64,
                                map, &full[s], 64 * j, it.hk,
                                (it.tb + i) * kWgTile, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 of each
    // work item
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bf16* q_wg = sQ + cw * 64 * 64;     // box j at + j * kWgItem * 64
    unsigned char* o_wg = base + L::kO + cw * L::kOWg;
    unsigned char* o32_wg = base + L::kO32 + cw * L::kO32Wg;

    float o[D / 2], s[kWgTile / 2], m[2], l[2], corr[2];
    uint32_t phi[kWgTile / 4], plo[kWgTile / 4];
#pragma unroll
    for (int i = 0; i < kWgTile / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgTile / 4; ++i) phi[i] = plo[i] = 0u;

    auto issue_s = [&](int st) {
      wg_nt_product<D>(s, q_wg, kWgItem * 64, sK + st * kWgTile * D);
      hopper::wgmma_commit();
    };
    auto issue_pv = [&](int st) {
      wg_split_product<D>(o, phi, plo, sV + st * kWgTile * D);
      hopper::wgmma_commit();
    };
    auto fence_all = [&]() {
      hopper::fence_regs(o);
      hopper::fence_regs(s);
      hopper::fence_regs(phi);
      hopper::fence_regs(plo);
      hopper::wgmma_fence();
    };

    if (cw == 1) hopper::bar_arrive(1, 256);   // warpgroup 0 issues first
    int kv = 0;
    for (int r = 0; r < rounds; ++r) {
      const int w = wg_round_item(r);
      if (w >= n_items) break;
      const bool last = r + 1 >= rounds || wg_round_item(r + 1) >= n_items;
      const WgItem it = wg_item(a, w);
      const int r0 = it.q0 + 64 * cw + 16 * warp;   // this warp's first row
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      hopper::mbar_wait(q_full, r & 1);

      // first tile: S_0 and its softmax
      int ks = kv % ST;
      hopper::mbar_wait(&k_full[ks], (kv / ST) & 1);
      hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_s(ks);
      hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if (lane == 0) {
        hopper::mbar_arrive(&k_empty[ks]);
        if (it.nt == 1) hopper::mbar_arrive(q_empty);   // Q is read
      }
      wg_softmax<CAP>(a, s, m, l, corr, r0, it.tb * kWgTile, g, t);
      pack_halves(s, phi, plo);

      // tile i: S_i and P_{i-1} V_{i-1} in flight, then S_i's softmax runs
      // while P V finishes; the rescale waits for it
      for (int i = 1; i < it.nt; ++i) {
        ks = (kv + i) % ST;
        const int vs = (kv + i - 1) % ST;
        hopper::mbar_wait(&k_full[ks], ((kv + i) / ST) & 1);
        hopper::mbar_wait(&v_full[vs], ((kv + i - 1) / ST) & 1);
        hopper::bar_sync(1 + cw, 256);
        fence_all();
        issue_s(ks);
        issue_pv(vs);
        hopper::bar_arrive(2 - cw, 256);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        if (lane == 0) {
          hopper::mbar_arrive(&k_empty[ks]);
          if (i == it.nt - 1) hopper::mbar_arrive(q_empty);
        }
        wg_softmax<CAP>(a, s, m, l, corr, r0, (it.tb + i) * kWgTile, g, t);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
        if (lane == 0) hopper::mbar_arrive(&v_empty[vs]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= corr[0];
          o[4 * j + 1] *= corr[0];
          o[4 * j + 2] *= corr[1];
          o[4 * j + 3] *= corr[1];
        }
        pack_halves(s, phi, plo);
      }

      // last P V; warpgroup 1's very last turn has no follower
      const int vs = (kv + it.nt - 1) % ST;
      hopper::mbar_wait(&v_full[vs], ((kv + it.nt - 1) / ST) & 1);
      hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_pv(vs);
      if (!(cw == 1 && last)) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&v_empty[vs]);
      kv += it.nt;

      // o = acc / l (IEEE divides, as the mma_bf16 kernel), staged in the
      // 128-byte swizzle once the previous item's stores have read the
      // tiles, then one TMA store a box, clipped at S
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
        l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      }
      if (tid == 0) hopper::tma_store_wait_read();
      hopper::bar_sync(3 + cw, 128);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = 16 * warp + g + 8 * hh;
          const float v0 = __fdiv_rn(o[4 * j + 2 * hh], l[hh]);
          const float v1 = __fdiv_rn(o[4 * j + 2 * hh + 1], l[hh]);
          *reinterpret_cast<uint32_t*>(o_wg + (j / 8) * kWgBox +
                                       sw128(rr, j % 8) + 4 * t) =
              tc::pack_bf16(v0, v1);
          *reinterpret_cast<float2*>(o32_wg + (j / 4) * kWgBox +
                                     sw128(rr, 2 * (j % 4) + (t >> 1)) +
                                     8 * (t & 1)) = make_float2(v0, v1);
        }
      if (t == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = r0 + g + 8 * hh;
          if (row < a.S)
            a.lse[((long long)it.b * a.Hq + it.h) * a.S + row] =
                m[hh] + logf(l[hh]);
        }
      }
      hopper::fence_async_shared();
      hopper::bar_sync(3 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::tma_store_4d(&to, o_wg + j * kWgBox, 64 * j, it.h,
                               it.q0 + 64 * cw, it.b);
#pragma unroll
        for (int j = 0; j < D / 32; ++j)
          hopper::tma_store_4d(&to32, o32_wg + j * kWgBox, 32 * j, it.h,
                               it.q0 + 64 * cw, it.b);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait_all();
  }
}

// Shared memory of dQ: Q and dO (D / 64 boxes of 128 rows each), ST stages
// of K and of V (boxes of 64 rows), each consumer warpgroup's dq staging
// tile, the mbarriers.
template <int D, int ST>
struct DqSmem {
  static constexpr int kQ = kWgItem * D * 2;
  static constexpr int kKV = kWgTile * D * 2;
  static constexpr int kOWg = 64 * D * 2;
  static constexpr int kDo = kQ;
  static constexpr int kK = 2 * kQ;
  static constexpr int kV = kK + ST * kKV;
  static constexpr int kO = kV + ST * kKV;
  static constexpr int kBar = kO + 2 * kOWg;
  static constexpr int kBytes = kBar + (2 + 4 * ST) * 8 + 1024;
};

template <int D, int ST, int CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdq, const Args a,
                int n_items) {
  using L = DqSmem<D, ST>;
  constexpr int NB = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sDo = reinterpret_cast<bf16*>(base + L::kDo);
  bf16* sK = reinterpret_cast<bf16*>(base + L::kK);
  bf16* sV = reinterpret_cast<bf16*>(base + L::kV);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;
  count_launch(kDq, kWgmma);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 8);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 8);
      hopper::mbar_init(&v_empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
  if (wg == 0) {
    // producer: thread 0 issues the Q, dO and K loads, thread 32 the V
    // loads (the consumers free a V stage a product earlier than a K stage)
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool qk = threadIdx.x == 0;
      uint64_t* full = qk ? k_full : v_full;
      uint64_t* empty = qk ? k_empty : v_empty;
      bf16* ring = qk ? sK : sV;
      const CUtensorMap* map = qk ? &tk : &tv;
      int kv = 0;
      for (int r = 0; r < rounds; ++r) {
        const int w = wg_round_item(r);
        if (w >= n_items) break;
        const WgItem it = wg_item(a, w);
        if (qk) {
          hopper::mbar_wait(q_empty, (r & 1) ^ 1);
          hopper::mbar_expect_tx(q_full, 2 * L::kQ);
#pragma unroll
          for (int j = 0; j < NB; ++j) {
            hopper::tma_load_4d(sQ + j * kWgItem * 64, &tq, q_full, 64 * j,
                                it.h, it.q0, it.b);
            hopper::tma_load_4d(sDo + j * kWgItem * 64, &tdo, q_full,
                                64 * j, it.h, it.q0, it.b);
          }
        }
        for (int i = 0; i < it.nt; ++i, ++kv) {
          const int s = kv % ST;
          hopper::mbar_wait(&empty[s], ((kv / ST) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], L::kKV);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_4d(ring + s * kWgTile * D + j * kWgTile * 64,
                                map, &full[s], 64 * j, it.hk,
                                (it.tb + i) * kWgTile, it.b);
        }
      }
    }
  } else {
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bf16* q_wg = sQ + cw * 64 * 64;
    const bf16* do_wg = sDo + cw * 64 * 64;
    unsigned char* dq_wg = base + L::kO + cw * L::kOWg;

    float dq[D / 2], s[kWgTile / 2], dp[kWgTile / 2], lse[2], delta[2];
    uint32_t dhi[kWgTile / 4], dlo[kWgTile / 4];
#pragma unroll
    for (int i = 0; i < kWgTile / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgTile / 4; ++i) dhi[i] = dlo[i] = 0u;

    // S = Q K^T and dP = dO V^T of the tiles in stage st, one group
    auto issue_sdp = [&](int st) {
      wg_nt_product2<D>(s, q_wg, sK + st * kWgTile * D, dp, do_wg,
                        sV + st * kWgTile * D, kWgItem * 64);
      hopper::wgmma_commit();
    };
    // dQ += dS K of the K tile in stage st
    auto issue_dq = [&](int st) {
      wg_split_product<D>(dq, dhi, dlo, sK + st * kWgTile * D);
      hopper::wgmma_commit();
    };
    auto fence_all = [&]() {
      hopper::fence_regs(dq);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::fence_regs(dhi);
      hopper::fence_regs(dlo);
      hopper::wgmma_fence();
    };

    if (cw == 1) hopper::bar_arrive(1, 256);
    int kv = 0;
    for (int r = 0; r < rounds; ++r) {
      const int w = wg_round_item(r);
      if (w >= n_items) break;
      const bool last = r + 1 >= rounds || wg_round_item(r + 1) >= n_items;
      const WgItem it = wg_item(a, w);
      const int r0 = it.q0 + 64 * cw + 16 * warp;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + g + 8 * hh;
        const long long i = ((long long)it.b * a.Hq + it.h) * a.S + row;
        lse[hh] = row < a.S ? a.lse[i] : 0.f;
        delta[hh] = row < a.S ? a.delta[i] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      // dS of the tile from k0 in place of S: P = exp(x - lse), then the
      // grad of the raw product (the mma_bf16 kernel's arithmetic)
      auto grad = [&](int k0) {
        const bool full = tile_visible(a, r0, k0);
#pragma unroll
        for (int i = 0; i < kWgTile / 2; ++i) {
          float th;
          const int hh = (i >> 1) & 1;
          float x = scaled_score<CAP>(a, s[i], th);
          if (!full)
            x = mask_score(a, x, r0 + g + 8 * hh,
                           k0 + (i >> 2) * 8 + 2 * t + (i & 1));
          const float p = expf(x - lse[hh]);
          s[i] = product_grad<CAP>(a, p, dp[i], delta[hh], th);
        }
      };
      hopper::mbar_wait(q_full, r & 1);

      int ks = kv % ST;
      hopper::mbar_wait(&k_full[ks], (kv / ST) & 1);
      hopper::mbar_wait(&v_full[ks], (kv / ST) & 1);
      hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_sdp(ks);
      hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      if (lane == 0) {
        hopper::mbar_arrive(&v_empty[ks]);
        if (it.nt == 1) hopper::mbar_arrive(q_empty);
      }
      grad(it.tb * kWgTile);
      pack_halves(s, dhi, dlo);

      // tile i: S_i, dP_i and dS_{i-1} K_{i-1} in flight, then dS_i runs
      // while the dQ product finishes
      for (int i = 1; i < it.nt; ++i) {
        ks = (kv + i) % ST;
        const int ps = (kv + i - 1) % ST;
        hopper::mbar_wait(&k_full[ks], ((kv + i) / ST) & 1);
        hopper::mbar_wait(&v_full[ks], ((kv + i) / ST) & 1);
        hopper::bar_sync(1 + cw, 256);
        fence_all();
        issue_sdp(ks);
        issue_dq(ps);
        hopper::bar_arrive(2 - cw, 256);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        hopper::fence_regs(dp);
        if (lane == 0) {
          hopper::mbar_arrive(&v_empty[ks]);
          if (i == it.nt - 1) hopper::mbar_arrive(q_empty);
        }
        grad((it.tb + i) * kWgTile);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dq);
        if (lane == 0) hopper::mbar_arrive(&k_empty[ps]);
        pack_halves(s, dhi, dlo);
      }

      // the last dQ product; warpgroup 1's very last turn has no follower
      const int ps = (kv + it.nt - 1) % ST;
      hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_dq(ps);
      if (!(cw == 1 && last)) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dq);
      if (lane == 0) hopper::mbar_arrive(&k_empty[ps]);
      kv += it.nt;

      if (tid == 0) hopper::tma_store_wait_read();
      hopper::bar_sync(3 + cw, 128);
      stage_bf16<D>(dq_wg, kWgBox, dq, warp, g, t);
      hopper::fence_async_shared();
      hopper::bar_sync(3 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::tma_store_4d(&tdq, dq_wg + j * kWgBox, 64 * j, it.h,
                               it.q0 + 64 * cw, it.b);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait_all();
  }
}

// Shared memory of dK dV: K and V (D / 64 boxes of 128 rows each; dK and dV
// staged there at the end), ST stages of Q and of dO (boxes of 64 rows) and
// of the log-sum-exp and delta of their rows, the mbarriers.
template <int D, int ST>
struct DkdvSmem {
  static constexpr int kKV = kWgItem * D * 2;
  static constexpr int kQ = kWgTile * D * 2;
  static constexpr int kV = kKV;
  static constexpr int kQs = 2 * kKV;
  static constexpr int kDo = kQs + ST * kQ;
  static constexpr int kLse = kDo + ST * kQ;
  static constexpr int kDelta = kLse + ST * kWgTile * 4;
  static constexpr int kBar = kDelta + ST * kWgTile * 4;
  static constexpr int kBytes = kBar + (1 + 2 * ST) * 8 + 1024;
};

// One block a (b * Hkv + kv head, 128 keys), the key blocks from the first
// (the longest causal walk) on.
template <int D, int ST, int CAP>
__global__ void __launch_bounds__(kWgThreads, 1)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdk,
                  const __grid_constant__ CUtensorMap tdv, const Args a) {
  using L = DkdvSmem<D, ST>;
  constexpr int NB = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sK = reinterpret_cast<bf16*>(base);
  bf16* sV = reinterpret_cast<bf16*>(base + L::kV);
  bf16* sQ = reinterpret_cast<bf16*>(base + L::kQs);
  bf16* sDo = reinterpret_cast<bf16*>(base + L::kDo);
  float* sLse = reinterpret_cast<float*>(base + L::kLse);
  float* sDelta = reinterpret_cast<float*>(base + L::kDelta);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  count_launch(kDkdv, kWgmma);

  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x - b * a.Hkv;
  const int k0 = blockIdx.y * kWgItem;
  int qb, qe;
  query_tiles(a, k0, kWgItem, kWgTile, qb, qe);
  const int per_head = qe - qb;
  const int items = a.G * per_head;   // (query head, query tile) in order

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);   // the TMA thread, a warp's lanes
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    hopper::reg_dealloc<kDkdvProducerRegs>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
      // K and V once, then each item's Q and dO through the ring
      hopper::mbar_expect_tx(kv_full, 2 * L::kKV);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        hopper::tma_load_4d(sK + j * kWgItem * 64, &tk, kv_full, 64 * j, hk,
                            k0, b);
        hopper::tma_load_4d(sV + j * kWgItem * 64, &tv, kv_full, 64 * j, hk,
                            k0, b);
      }
      for (int i = 0; i < items; ++i) {
        const int s = i % ST;
        const int h = hk * a.G + i / per_head;
        const int q0 = (qb + i % per_head) * kWgTile;
        hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * L::kQ);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          hopper::tma_load_4d(sQ + s * kWgTile * D + j * kWgTile * 64, &tq,
                              &full[s], 64 * j, h, q0, b);
          hopper::tma_load_4d(sDo + s * kWgTile * D + j * kWgTile * 64, &tdo,
                              &full[s], 64 * j, h, q0, b);
        }
      }
    } else if (warp == 1) {
      // the log-sum-exp and delta of each item's rows (0 past S), by plain
      // loads: a TMA map needs 16-byte row strides, and a (B, Hq, S) f32
      // row is S x 4 bytes; the warp's 32 arrivals complete the stage
      for (int i = 0; i < items; ++i) {
        const int s = i % ST;
        const int h = hk * a.G + i / per_head;
        const int q0 = (qb + i % per_head) * kWgTile;
        hopper::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
        const long long row0 = ((long long)b * a.Hq + h) * a.S + q0;
#pragma unroll
        for (int j = lane; j < kWgTile; j += 32) {
          const bool ok = q0 + j < a.S;
          sLse[s * kWgTile + j] = ok ? a.lse[row0 + j] : 0.f;
          sDelta[s * kWgTile + j] = ok ? a.delta[row0 + j] : 0.f;
        }
        hopper::mbar_arrive(&full[s]);
      }
    }
  } else {
    hopper::reg_alloc<kDkdvConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const bf16* k_wg = sK + cw * 64 * 64;   // box j at + j * kWgItem * 64
    const bf16* v_wg = sV + cw * 64 * 64;
    const int kw0 = k0 + 64 * cw + 16 * warp;   // this warp's first key

    // the packed halves live only from the elementwise pass to the end of
    // the products that read them (dK, dV, S^T, dP^T and the halves at
    // once would take 256 registers a thread at D = 128)
    float dk[D / 2], dv[D / 2], s[kWgTile / 2], dp[kWgTile / 2];
    uint32_t phi[kWgTile / 4], plo[kWgTile / 4], dhi[kWgTile / 4],
        dlo[kWgTile / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kWgTile / 2; ++i) s[i] = dp[i] = 0.f;

    hopper::mbar_wait(kv_full, 0);
    if (cw == 1 && items > 0) hopper::bar_arrive(1, 256);
    for (int i = 0; i < items; ++i) {
      const int st = i % ST;
      const int q0 = (qb + i % per_head) * kWgTile;
      const bf16* qt = sQ + st * kWgTile * D;
      const bf16* dot = sDo + st * kWgTile * D;
      hopper::mbar_wait(&full[st], (i / ST) & 1);

      // S^T = K Q^T and dP^T = V dO^T (keys on M, the tile's queries on N)
      hopper::bar_sync(1 + cw, 256);
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      hopper::wgmma_fence();
      wg_nt_product2<D>(s, k_wg, qt, dp, v_wg, dot, kWgItem * 64);
      hopper::wgmma_commit();
      hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);

      // P^T and dS^T in place (the mma_bf16 kernel's arithmetic); a padded
      // query row has no weight and no grad
      const float* cl = sLse + st * kWgTile;
      const float* cd = sDelta + st * kWgTile;
      const bool full_tile =
          q0 + kWgTile <= a.S && kw0 + 16 <= a.T &&
          (!a.causal || kw0 + 15 <= q0) &&
          (a.window <= 0 || q0 + kWgTile - 1 - kw0 < a.window);
#pragma unroll
      for (int j = 0; j < kWgTile / 8; ++j) {
        const int c = 8 * j + 2 * t;   // the query of s[4 j] in the tile
        const float2 lc = *reinterpret_cast<const float2*>(cl + c);
        const float2 dc = *reinterpret_cast<const float2*>(cd + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i4 = 4 * j + e;
          const float lse = (e & 1) ? lc.y : lc.x;
          const float del = (e & 1) ? dc.y : dc.x;
          const int q = q0 + c + (e & 1);
          float th;
          float x = scaled_score<CAP>(a, s[i4], th);
          if (!full_tile) x = mask_score(a, x, q, kw0 + g + 8 * (e >> 1));
          const float p = expf(x - lse);
          const float gs = product_grad<CAP>(a, p, dp[i4], del, th);
          const bool real = full_tile || q < a.S;
          s[i4] = real ? p : 0.f;
          dp[i4] = real ? gs : 0.f;
        }
      }
      pack_halves(s, phi, plo);
      pack_halves(dp, dhi, dlo);

      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major); warpgroup 1's
      // very last turn has no follower
      hopper::bar_sync(1 + cw, 256);
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      hopper::fence_regs(phi);
      hopper::fence_regs(plo);
      hopper::fence_regs(dhi);
      hopper::fence_regs(dlo);
      hopper::wgmma_fence();
      wg_split_product2<D>(dv, phi, plo, dot, dk, dhi, dlo, qt);
      hopper::wgmma_commit();
      if (!(cw == 1 && i == items - 1)) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk);
      hopper::fence_regs(dv);
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    // dK and dV into this warpgroup's own rows of the K and V tiles (only
    // its own products read them), then one TMA store a box, clipped at T
    unsigned char* k_rows = reinterpret_cast<unsigned char*>(sK) + cw * kWgBox;
    unsigned char* v_rows = reinterpret_cast<unsigned char*>(sV) + cw * kWgBox;
    stage_bf16<D>(k_rows, 2 * kWgBox, dk, warp, g, t);
    stage_bf16<D>(v_rows, 2 * kWgBox, dv, warp, g, t);
    hopper::fence_async_shared();
    hopper::bar_sync(3 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        hopper::tma_store_4d(&tdk, k_rows + j * 2 * kWgBox, 64 * j, hk,
                             k0 + 64 * cw, b);
        hopper::tma_store_4d(&tdv, v_rows + j * 2 * kWgBox, 64 * j, hk,
                             k0 + 64 * cw, b);
      }
      hopper::tma_store_commit();
      hopper::tma_store_wait_all();
    }
  }
}

// The TMA map of a bf16 (B, L, H, D) tensor with element strides (sb, sl,
// sh) and its last dim contiguous, as (D, H, L, B) innermost first: boxes
// of 64 columns x 1 head x `rows` rows x 1, 128-byte swizzle, zeros read
// outside, stores clipped.
bool bshd_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
              long long sb, long long sl, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hopper::tensor_map_bf16(map, ptr, 4, dims, strides, box);
}

// The same map of a contiguous bf16 (B, L, H, D) tensor.
bool bshd_map(CUtensorMap* map, const void* ptr, int B, int L, int H, int D,
              int rows) {
  return bshd_map(map, ptr, B, L, H, D, (long long)L * H * D,
                  (long long)H * D, D, rows);
}

// The map of a contiguous f32 (B, L, H, D) tensor: boxes of 32 columns
// (128 bytes) x 1 x `rows` x 1, 128-byte swizzle, stores clipped.
bool bshd_map_f32(CUtensorMap* map, void* ptr, int B, int L, int H, int D,
                  int rows) {
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)L * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One block an SM for at most kPersistentItemsPerSm items an SM, else one
// block an item.
cudaError_t persistent_grid(int n_items, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  grid = n_items <= kPersistentItemsPerSm * sms ? min(n_items, sms) : n_items;
  return cudaSuccess;
}

template <int D, int CAP>
cudaError_t launch_wg_forward(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo, mo32;
  if (!bshd_map(&mq, a.q, a.B, a.S, a.Hq, D, a.q_sb, a.q_ss, a.q_sh,
                kWgItem) ||
      !bshd_map(&mk, a.k, a.B, a.T, a.Hkv, D, a.k_sb, a.k_st, a.k_sh,
                kWgTile) ||
      !bshd_map(&mv, a.v, a.B, a.T, a.Hkv, D, a.v_sb, a.v_st, a.v_sh,
                kWgTile) ||
      !bshd_map(&mo, a.o, a.B, a.S, a.Hq, D, 64) ||
      !bshd_map_f32(&mo32, a.o32, a.B, a.S, a.Hq, D, 64))
    return cudaErrorInvalidValue;
  constexpr int ST = kFwdStages;
  constexpr int smem = FwdSmem<D, ST>::kBytes;
  auto kernel = fwd_wgmma_kernel<D, ST, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_items = a.B * a.Hq * ((a.S + kWgItem - 1) / kWgItem);
  int grid = 0;
  if ((err = persistent_grid(n_items, grid)) != cudaSuccess) return err;
  kernel<<<grid, kWgThreads, smem, stream>>>(mq, mk, mv, mo, mo32, a,
                                             n_items);
  return cudaGetLastError();
}

template <int D, int CAP>
cudaError_t launch_wg_backward(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.S * a.Hq;
  delta_kernel<bf16, kWgmma><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap mq, mdo, mk, mv, mdq;
  if (!bshd_map(&mq, a.q, a.B, a.S, a.Hq, D, a.q_sb, a.q_ss, a.q_sh,
                kWgItem) ||
      !bshd_map(&mdo, a.dout, a.B, a.S, a.Hq, D, kWgItem) ||
      !bshd_map(&mk, a.k, a.B, a.T, a.Hkv, D, a.k_sb, a.k_st, a.k_sh,
                kWgTile) ||
      !bshd_map(&mv, a.v, a.B, a.T, a.Hkv, D, a.v_sb, a.v_st, a.v_sh,
                kWgTile) ||
      !bshd_map(&mdq, a.dq, a.B, a.S, a.Hq, D, 64))
    return cudaErrorInvalidValue;
  constexpr int DQ_ST = kDqStages;
  constexpr int dq_smem = DqSmem<D, DQ_ST>::kBytes;
  auto dq_kernel = dq_wgmma_kernel<D, DQ_ST, CAP>;
  if ((err = cudaFuncSetAttribute(dq_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dq_smem)) != cudaSuccess)
    return err;
  const int n_items = a.B * a.Hq * ((a.S + kWgItem - 1) / kWgItem);
  int grid = 0;
  if ((err = persistent_grid(n_items, grid)) != cudaSuccess) return err;
  dq_kernel<<<grid, kWgThreads, dq_smem, stream>>>(mq, mdo, mk, mv, mdq, a,
                                                   n_items);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap tk, tv, tq, tdo, tdk, tdv;
  if (!bshd_map(&tk, a.k, a.B, a.T, a.Hkv, D, a.k_sb, a.k_st, a.k_sh,
                kWgItem) ||
      !bshd_map(&tv, a.v, a.B, a.T, a.Hkv, D, a.v_sb, a.v_st, a.v_sh,
                kWgItem) ||
      !bshd_map(&tq, a.q, a.B, a.S, a.Hq, D, a.q_sb, a.q_ss, a.q_sh,
                kWgTile) ||
      !bshd_map(&tdo, a.dout, a.B, a.S, a.Hq, D, kWgTile) ||
      !bshd_map(&tdk, a.dk, a.B, a.T, a.Hkv, D, 64) ||
      !bshd_map(&tdv, a.dv, a.B, a.T, a.Hkv, D, 64))
    return cudaErrorInvalidValue;
  constexpr int KV_ST = kDkdvStages;
  constexpr int kv_smem = DkdvSmem<D, KV_ST>::kBytes;
  auto kv_kernel = dkdv_wgmma_kernel<D, KV_ST, CAP>;
  if ((err = cudaFuncSetAttribute(kv_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kv_smem)) != cudaSuccess)
    return err;
  kv_kernel<<<dim3(a.B * a.Hkv, (a.T + kWgItem - 1) / kWgItem), kWgThreads,
              kv_smem, stream>>>(tk, tv, tq, tdo, tdk, tdv, a);
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
  delta_kernel<float, kF32><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a);
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

// --------------------------------------------------------- mma_3xtf32

// A block owns 32 query rows (forward, dQ) or keys (dK dV): two strips of
// 16, each worked by two warps that split the strip's key tiles (dK dV: its
// items of query rows) between them, taking turns, and merge at the end
// (x3::merge_softmax, x3::merge_sum).  The kernels are bound by the
// latency of each warp's chain of tiles, not by issue: the split halves
// the chain of lm100m's heaviest causal tiles and doubles the warps in
// flight.  A step's two tiles (one a half) come by cp.async into one stage:
// a ring that prefetched the next step measured slower at lm100m's shape
// (its shared memory held two blocks an SM in place of five).  The kernels
// are templated on the cap (CAP 1 in, 0 out): a run-time cap test inlines
// tanhf into every score of the unrolled tiles.
constexpr int kX3Threads = 64 * x3::kSplit;
constexpr int kX3Rows = 32;
constexpr int kX3Keys = x3::kKeys;

template <int DP>
__host__ __device__ constexpr int x3_tile_floats(int rows) {
  return rows * x3::ld<DP>();
}

// Forward: one block a (b * Hq + h, tile of 32 query rows), the heavy
// causal tiles first; each warp runs x3::forward_tile over its half of the
// strip's key tiles.
template <int DP, int CAP>
__global__ void __launch_bounds__(kX3Threads)
fwd_3xtf32_kernel(const Args a) {
  constexpr int OB = DP / 8;
  constexpr int TK = x3_tile_floats<DP>(kX3Keys);
  extern __shared__ __align__(16) float x3_smem[];
  float* sQ = x3_smem;                            // kX3Rows rows
  float* sK = sQ + x3_tile_floats<DP>(kX3Rows);   // kSplit tiles, one a half
  float* sV = sK + x3::kSplit * TK;               // kSplit tiles, one a half
  count_launch(kForward, kX3);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp & 1, half = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kX3Rows;
  const float* qh = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int tb, te;
  key_tiles(a, q0, kX3Rows, kX3Keys, tb, te);
  const int steps = (te - tb + x3::kSplit - 1) / x3::kSplit;
  auto load_step = [&](int p) {   // step p's key tiles, one a half
#pragma unroll
    for (int hf = 0; hf < x3::kSplit; ++hf) {
      const int it = tb + p * x3::kSplit + hf;
      if (it < te) {
        x3::load_rows<kX3Keys, DP, kX3Threads>(sK + hf * TK, kh, a.k_st,
                                               it * kX3Keys, a.T, a.D);
        x3::load_rows<kX3Keys, DP, kX3Threads>(sV + hf * TK, vh, a.v_st,
                                               it * kX3Keys, a.T, a.D);
      }
    }
    tc::cp_async_commit();
  };

  x3::load_rows<kX3Rows, DP, kX3Threads>(sQ, qh, a.q_ss, q0, a.S, a.D);

  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + strip * 16 + g, q0 + strip * 16 + g + 8};

  for (int p = 0; p < steps; ++p) {
    load_step(p);   // Q joins step 0
    tc::cp_async_wait<0>();
    __syncthreads();
    const int it = tb + p * x3::kSplit + half;
    if (it < te) {
      const int k0 = it * kX3Keys;
      x3::forward_tile<DP>(acc, m, l, sQ, strip * 16, sK + half * TK,
                           sV + half * TK, lane, [&](float s, int hh, int c) {
                             float th;
                             return masked_score<CAP>(a, s, row[hh], k0 + c,
                                                      th);
                           });
    }
    __syncthreads();   // this step's tiles are consumed before the next
  }
  if (half == 1) x3::hand_over_softmax(sK, acc, m, l, strip, lane);
  __syncthreads();
  if (half == 1) return;
  x3::merge_softmax(acc, m, l, sK, strip, lane);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row[hh];
    const float lr = x3::quad_sum(l[hh]);
    if (r >= a.S) continue;
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < a.D)
        *reinterpret_cast<float2*>(a.o32 + base + c) =
            make_float2(__fdiv_rn(acc[j][2 * hh], lr),
                        __fdiv_rn(acc[j][2 * hh + 1], lr));
    }
    if (t == 0)
      a.lse[((long long)b * a.Hq + h) * a.S + r] = m[hh] + logf(lr);
  }
}

// dQ: one block a (b * Hq + h, tile of 32 query rows).  It first computes
// delta = rowsum(dO o32) of its rows (two lanes a row, o32 staged in shared
// memory beside dO) and writes it for the dK dV pass that follows on the
// stream: no delta launch.
template <int DP, int CAP>
__global__ void __launch_bounds__(kX3Threads)
dq_3xtf32_kernel(const Args a) {
  constexpr int NB = kX3Keys / 8;
  constexpr int OB = DP / 8;
  constexpr int LD = x3::ld<DP>();
  constexpr int TQ = x3_tile_floats<DP>(kX3Rows);
  constexpr int TK = x3_tile_floats<DP>(kX3Keys);
  extern __shared__ __align__(16) float x3_smem[];
  float* sQ = x3_smem;                   // kX3Rows rows
  float* sO = sQ + TQ;                   // dO: kX3Rows rows
  float* sO32 = sO + TQ;                 // o32: kX3Rows rows
  float* sK = sO32 + TQ;                 // kSplit tiles, one a half
  float* sV = sK + x3::kSplit * TK;
  count_launch(kDq, kX3);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp & 1, half = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hq, h = blockIdx.x - b * a.Hq;
  const int hk = h / a.G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kX3Rows;
  const long long row_ld = (long long)a.Hq * a.D;   // dO, o32, dQ: contiguous
  const long long head = (long long)b * a.S * row_ld + (long long)h * a.D;
  const float* qh = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int tb, te;
  key_tiles(a, q0, kX3Rows, kX3Keys, tb, te);
  const int steps = (te - tb + x3::kSplit - 1) / x3::kSplit;
  auto load_step = [&](int p) {
#pragma unroll
    for (int hf = 0; hf < x3::kSplit; ++hf) {
      const int it = tb + p * x3::kSplit + hf;
      if (it < te) {
        x3::load_rows<kX3Keys, DP, kX3Threads>(sK + hf * TK, kh, a.k_st,
                                               it * kX3Keys, a.T, a.D);
        x3::load_rows<kX3Keys, DP, kX3Threads>(sV + hf * TK, vh, a.v_st,
                                               it * kX3Keys, a.T, a.D);
      }
    }
    tc::cp_async_commit();
  };

  x3::load_rows<kX3Rows, DP, kX3Threads>(sQ, qh, a.q_ss, q0, a.S, a.D);
  x3::load_rows<kX3Rows, DP, kX3Threads>(
      sO, static_cast<const float*>(a.dout) + head, row_ld, q0, a.S, a.D);
  x3::load_rows<kX3Rows, DP, kX3Threads>(sO32, a.o32 + head, row_ld, q0, a.S,
                                         a.D);
  tc::cp_async_commit();

  const int row[2] = {q0 + strip * 16 + g, q0 + strip * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    lse[hh] = row[hh] < a.S
                  ? a.lse[((long long)b * a.Hq + h) * a.S + row[hh]] : 0.f;
  tc::cp_async_wait<0>();   // Q, dO and o32
  __syncthreads();
  {   // delta of the strip's row lane / 2 (both halves alike): even columns
      // in even lanes, odd in odd ones (zero past D), then their sum
    const int i = strip * 16 + (lane >> 1);
    float sum = 0.f;
#pragma unroll 8
    for (int d = lane & 1; d < DP; d += 2)
      sum = fmaf(sO[i * LD + d], sO32[i * LD + d], sum);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    delta[0] = __shfl_sync(0xffffffffu, sum, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, sum, 2 * g + 16);
    if (half == 0 && (lane & 1) == 0 && q0 + i < a.S)
      a.delta[((long long)b * a.Hq + h) * a.S + q0 + i] = sum;
  }

  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int p = 0; p < steps; ++p) {
    load_step(p);
    tc::cp_async_wait<0>();
    __syncthreads();
    const int it = tb + p * x3::kSplit + half;
    if (it < te) {
      const int k0 = it * kX3Keys;
      const float* cK = sK + half * TK;
      const float* cV = sV + half * TK;
      float s[NB][4], dp[NB][4];
      x3::product_nt<DP, NB>(s, sQ, strip * 16, cK, lane);
      x3::product_nt<DP, NB>(dp, sO, strip * 16, cV, lane);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float th;
          const float x = masked_score<CAP>(a, s[nb][e], row[e >> 1],
                                            k0 + nb * 8 + 2 * t + (e & 1),
                                            th);
          const float pr = expf(x - lse[e >> 1]);
          s[nb][e] = product_grad<CAP>(a, pr, dp[nb][e], delta[e >> 1], th);
        }
      x3::product_nn<DP, NB>(acc, s, cK, lane);   // dQ += dS K
    }
    __syncthreads();
  }
  if (half == 1) x3::hand_over_sum(sK, acc, strip, lane);
  __syncthreads();
  if (half == 1) return;
  x3::merge_sum(acc, sK, strip, lane);

  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row[hh];
    if (r >= a.S) continue;
    const long long base = (((long long)b * a.S + r) * a.Hq + h) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < a.D)
        *reinterpret_cast<float2*>(dq + base + c) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
    }
  }
}

// Query rows an item of the dK dV pass: 32, and 16 at DP = 128, whose dK
// and dV accumulators take 128 registers a thread (at 32 ptxas spilled).
template <int DP>
__host__ __device__ constexpr int x3_item_rows() {
  return DP > 64 ? 16 : kX3Keys;
}

// dK, dV: one block a (b * Hkv + kv head, tile of 32 keys), a strip 16
// keys; the block walks the G query heads of its kv head, each over its
// query tiles (x3_item_rows) that see the keys, in that order, the two
// halves taking the items in turns (a fixed sum order).
template <int DP, int CAP>
__global__ void __launch_bounds__(kX3Threads)
dkdv_3xtf32_kernel(const Args a) {
  constexpr int BQ = x3_item_rows<DP>();   // query rows an item
  constexpr int NQ = BQ / 8;
  constexpr int OB = DP / 8;
  constexpr int NI = x3::kSplit;   // item slots, one a half
  constexpr int TR = x3_tile_floats<DP>(kX3Rows);
  constexpr int TQ = x3_tile_floats<DP>(BQ);
  extern __shared__ __align__(16) float x3_smem[];
  float* sK = x3_smem;          // kX3Rows keys
  float* sV = sK + TR;          // kX3Rows keys
  float* sQ = sV + TR;          // NI slots of BQ rows
  float* sO = sQ + NI * TQ;     // dO: NI slots
  float* sLse = sO + NI * TQ;   // NI x BQ
  float* sDelta = sLse + NI * BQ;
  count_launch(kDkdv, kX3);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp & 1, half = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / a.Hkv, hk = blockIdx.x - b * a.Hkv;
  const int k0 = blockIdx.y * kX3Rows;   // the long causal key tiles first
  const long long row_ld = (long long)a.Hq * a.D;
  const float* kh = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vh = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  int qb, qe;
  query_tiles(a, k0, kX3Rows, BQ, qb, qe);
  const int per_head = qe - qb;
  const int items = a.G * per_head;
  const int steps = (items + x3::kSplit - 1) / x3::kSplit;

  // item i: query head hk * G + i / per_head, query tile qb + i % per_head
  auto load_step = [&](int p) {
#pragma unroll
    for (int hf = 0; hf < x3::kSplit; ++hf) {
      const int i = p * x3::kSplit + hf;
      if (i < items) {
        const int h = hk * a.G + i / per_head;
        const int q0 = (qb + i % per_head) * BQ;
        x3::load_rows<BQ, DP, kX3Threads>(
            sQ + hf * TQ,
            static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
            q0, a.S, a.D);
        x3::load_rows<BQ, DP, kX3Threads>(
            sO + hf * TQ, static_cast<const float*>(a.dout) +
                                (long long)b * a.S * row_ld +
                                (long long)h * a.D,
            row_ld, q0, a.S, a.D);
        const long long r = ((long long)b * a.Hq + h) * a.S + q0;
        for (int j = threadIdx.x; j < BQ; j += kX3Threads) {
          const bool ok = q0 + j < a.S;
          x3::cp_async4(sLse + hf * BQ + j, ok ? a.lse + r + j : a.lse, ok);
          x3::cp_async4(sDelta + hf * BQ + j,
                        ok ? a.delta + r + j : a.delta, ok);
        }
      }
    }
    tc::cp_async_commit();
  };

  x3::load_rows<kX3Rows, DP, kX3Threads>(sK, kh, a.k_st, k0, a.T, a.D);
  x3::load_rows<kX3Rows, DP, kX3Threads>(sV, vh, a.v_st, k0, a.T, a.D);

  float dk[OB][4], dv[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  const int key[2] = {k0 + strip * 16 + g, k0 + strip * 16 + g + 8};

  for (int p = 0; p < steps; ++p) {
    load_step(p);
    tc::cp_async_wait<0>();
    __syncthreads();
    const int i = p * x3::kSplit + half;
    if (i < items) {
      const int q0 = (qb + i % per_head) * BQ;
      const float* cQ = sQ + half * TQ;
      const float* cO = sO + half * TQ;
      const float* cLse = sLse + half * BQ;
      const float* cDelta = sDelta + half * BQ;
      // S^T = K Q^T and dP^T = V dO^T: the strip's keys (rows) against the
      // item's queries (columns)
      float s[NQ][4], dp[NQ][4];
      x3::product_nt<DP, NQ>(s, sK, strip * 16, cQ, lane);
      x3::product_nt<DP, NQ>(dp, sV, strip * 16, cO, lane);
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + 2 * t + (e & 1);   // query within the item
          if (q0 + c >= a.S) {   // a padded query row: no weight, no grad
            s[nb][e] = 0.f;
            dp[nb][e] = 0.f;
            continue;
          }
          float th;
          const float x = masked_score<CAP>(a, s[nb][e], q0 + c,
                                            key[e >> 1], th);
          const float pr = expf(x - cLse[c]);
          dp[nb][e] = product_grad<CAP>(a, pr, dp[nb][e], cDelta[c], th);
          s[nb][e] = pr;
        }
      x3::product_nn<DP, NQ>(dv, s, cO, lane);    // dV += P^T dO
      x3::product_nn<DP, NQ>(dk, dp, cQ, lane);   // dK += dS^T Q
    }
    __syncthreads();
  }
  float* dk_scratch = sQ;
  float* dv_scratch = sQ + 2 * 32 * OB * 4;
  if (half == 1) {
    x3::hand_over_sum(dk_scratch, dk, strip, lane);
    x3::hand_over_sum(dv_scratch, dv, strip, lane);
  }
  __syncthreads();
  if (half == 1) return;
  x3::merge_sum(dk, dk_scratch, strip, lane);
  x3::merge_sum(dv, dv_scratch, strip, lane);

  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = key[hh];
    if (r >= a.T) continue;
    const long long base = (((long long)b * a.T + r) * a.Hkv + hk) * a.D;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c >= a.D) continue;
      *reinterpret_cast<float2*>(dkp + base + c) =
          make_float2(dk[j][2 * hh], dk[j][2 * hh + 1]);
      *reinterpret_cast<float2*>(dvp + base + c) =
          make_float2(dv[j][2 * hh], dv[j][2 * hh + 1]);
    }
  }
}

template <int DP, int CAP>
cudaError_t launch_x3_forward(const Args& a, cudaStream_t stream) {
  constexpr int NI = x3::kSplit;   // tile slots, one a half
  const int smem = (int)sizeof(float) * (x3_tile_floats<DP>(kX3Rows) +
                                         2 * NI * x3_tile_floats<DP>(kX3Keys));
  auto kernel = fwd_3xtf32_kernel<DP, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.B * a.Hq, (a.S + kX3Rows - 1) / kX3Rows), kX3Threads, smem,
           stream>>>(a);
  return cudaGetLastError();
}

// Two launches: dQ (with delta), then dK dV, which reads that delta.
template <int DP, int CAP>
cudaError_t launch_x3_backward(const Args& a, cudaStream_t stream) {
  constexpr int NI = x3::kSplit;
  const int dq_smem = (int)sizeof(float) *
                      (3 * x3_tile_floats<DP>(kX3Rows) +
                       2 * NI * x3_tile_floats<DP>(kX3Keys));
  auto dq_kernel = dq_3xtf32_kernel<DP, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
  if (err != cudaSuccess) return err;
  dq_kernel<<<dim3(a.B * a.Hq, (a.S + kX3Rows - 1) / kX3Rows), kX3Threads,
              dq_smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr int BQ = x3_item_rows<DP>();
  const int kv_smem = (int)sizeof(float) *
                      (2 * x3_tile_floats<DP>(kX3Rows) +
                       2 * NI * (x3_tile_floats<DP>(BQ) + BQ));
  auto kv_kernel = dkdv_3xtf32_kernel<DP, CAP>;
  err = cudaFuncSetAttribute(kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return err;
  kv_kernel<<<dim3(a.B * a.Hkv, (a.T + kX3Rows - 1) / kX3Rows), kX3Threads,
              kv_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_x3(const Args& a, bool backward, cudaStream_t stream) {
  if (a.cap != 0.f)
    return backward ? launch_x3_backward<DP, 1>(a, stream)
                    : launch_x3_forward<DP, 1>(a, stream);
  return backward ? launch_x3_backward<DP, 0>(a, stream)
                  : launch_x3_forward<DP, 0>(a, stream);
}

// The route's instance for the head dim, forward or backward.
cudaError_t dispatch(const Args& a, int route, bool backward,
                     cudaStream_t stream) {
  if (route == kWgmma) {
    if (a.D != 64 && a.D != 128) return cudaErrorInvalidValue;
#ifdef TRAIN_ATTN_FORCE_MMA
    route = kMma;   // the old route at this shape, counted there
#else
    const bool cap = a.cap != 0.f;
    if (a.D == 64) {
      if (backward)
        return cap ? launch_wg_backward<64, 1>(a, stream)
                   : launch_wg_backward<64, 0>(a, stream);
      return cap ? launch_wg_forward<64, 1>(a, stream)
                 : launch_wg_forward<64, 0>(a, stream);
    }
    if (backward)
      return cap ? launch_wg_backward<128, 1>(a, stream)
                 : launch_wg_backward<128, 0>(a, stream);
    return cap ? launch_wg_forward<128, 1>(a, stream)
               : launch_wg_forward<128, 0>(a, stream);
#endif
  }
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
  if (route == kX3) {
    if (a.D % 8 || a.D > 128) return cudaErrorInvalidValue;
#ifdef TRAIN_ATTN_FORCE_SCALAR
    route = kF32;   // the old route at this shape, counted there
#else
    if (a.D <= 32) return launch_x3<32>(a, backward, stream);
    if (a.D <= 64) return launch_x3<64>(a, backward, stream);
    return launch_x3<128>(a, backward, stream);
#endif
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
// (qs, ks, vs: three each); route 0 (mma_bf16: bf16, rows 16-byte aligned),
// 1 (scalar_f32: f32), 2 (wgmma_bf16: bf16 at D = 64 or 128, the base and
// the strides 16-byte aligned; mma_bf16 in a -DTRAIN_ATTN_FORCE_MMA build)
// or 3 (mma_3xtf32: f32 at D % 8 == 0, D <= 128, the base and the strides
// 16-byte aligned; scalar_f32 in a -DTRAIN_ATTN_FORCE_SCALAR build).
// Writes o (B, S, Hq, D) in the inputs' dtype, o32 (f32; on routes 1 and 3
// pass o) and lse (B, Hq, S), all contiguous.  cap 0 is no cap; inv_cap and
// inv_sqrt_d are the f32 reciprocals of cap and sqrt(D).  The wrapper
// checks shapes, Hq % Hkv == 0 and S == T where causal or window > 0.
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
// contiguous, in the inputs' dtype.  Three launches: delta, dQ, dK dV (two
// on mma_3xtf32, whose dQ kernel computes delta).
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
// mma_bf16, 1 scalar_f32, 2 wgmma_bf16, 3 mma_3xtf32) counted on the device since the
// library was loaded; ~0 on a bad argument or a failed copy.
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
