// f32-accurate products on the tensor cores (3xTF32), shared by the f32
// attention routes of flash_attention.cu and train_attention.cu
// (mma_3xtf32): the split, the mma.sync fragments of f32 tiles in shared
// memory, the two tile products, the online softmax and the forward's key
// tile.
//
// One TF32 rounding keeps 11 significant bits, which moves an attention
// result by ~1e-4 of its range: past the f32 tolerance (1e-5 of the range).
// Each f32 operand x is split into big = tf32(x) (round to nearest, ties
// away: cvt.rna.tf32.f32's rounding) and small = tf32(x - big), the
// remainder being exact in f32; then a b ~ big_a big_b + big_a small_b +
// small_a big_b (the dropped small_a small_b is ~2^-22 of the product):
// three mma.sync m16n8k8.tf32 products, f32 accumulation, small terms
// first, ~21 bits a product, about the f32 route's accuracy
// (tests/test_torch_train_attention.py emulates it against JAX; a single
// TF32 rounding misses).
//
// m16n8k8.tf32 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major): a0 = A[g][t]  a1 = A[g+8][t]  a2 = A[g][t+4]
//                          a3 = A[g+8][t+4]
//   B (8 x 8, k x n):      b0 = B[t][g]  b1 = B[t+4][g]
//   C (16 x 8, f32):       c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// A C tile is the A operand of the next product with its k order permuted
// (A's column t is C's 2t, column t + 4 is 2t + 1): a = {c0, c2, c1, c3},
// and B's rows are read in the same order (b0 = row 2t, b1 = row 2t + 1),
// so P and dS never leave the registers.
//
// Tiles are f32, row-major, DP columns (a multiple of 32, zero past the
// head dim) with row stride DP + 4 (= 4 mod 32 words): every fragment load
// (A and n-major B at 4 g + t, k-major B at 8 t + g) hits 32 distinct
// banks, and rows stay 16-byte aligned for cp.async.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace x3 {

// keys a tile (forward, dQ) and query rows a tile (dK dV)
constexpr int kKeys = 32;

template <int DP>
__host__ __device__ constexpr int ld() { return DP + 4; }

// A finite x rounded to TF32 (10 mantissa bits, to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds; the low 13 bits cleared, so the
// remainder x - big is exact).  Two integer ops on the full-rate ALU: cvt
// issues at a quarter of the rate, and the splits are most of these
// kernels' non-tensor work.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b from f32 fragments a (4) and b (2), each split here.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float b0,
                                     float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split(b0, bb0, bs0);
  split(b1, bb1, bs1);
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], big[i], small[i]);
}

// Rows [r0, r0 + ROWS) of a head of a strided f32 tensor whose rows are
// `stride` elements apart, columns [0, DP), into a shared tile of row
// stride ld<DP>() by cp.async, 16 bytes at a time; rows at or past n and
// columns at or past D (a multiple of 4) are zero.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* head,
                                          long long stride, int r0, int n,
                                          int D) {
  constexpr int kVecs = DP / 4;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVecs; i += THREADS) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 4;
    const bool ok = r0 + r < n && c < D;
    tc::cp_async16(dst + r * ld<DP>() + c,
                   ok ? head + (r0 + r) * stride + c : head, ok);
  }
}

// 4 bytes from global to shared memory (cp.async, through L1); zero where
// !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// s (16 x 8 NB, C layout) = A B^T over k = DP: A rows [row0, row0 + 16) of
// tile ta, B rows [0, 8 NB) of tile tb (n-major: B[k][n] = tb[n][k]).  At
// DP <= 64 the three split products of each n-block go to three
// accumulators, summed at the end (small terms first): three independent
// chains of DP / 8 products in place of one of 3 DP / 8 (a warp here is
// bound by its chains' latency), and the small terms summed at their own
// magnitude.  At DP = 128 their registers would spill (dK dV holds dK and
// dV beside S and dP), so one accumulator takes all three.
template <int DP, int NB>
__device__ __forceinline__ void product_nt(float (&s)[NB][4], const float* ta,
                                           int row0, const float* tb,
                                           int lane) {
  constexpr int LD = ld<DP>();
  constexpr int NACC = DP <= 64 ? 3 : 1;
  const int g = lane >> 2, t = lane & 3;
  float part[NACC][NB][4];
#pragma unroll
  for (int i = 0; i < NACC; ++i)
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 8) {
    const float* a = ta + (row0 + g) * LD + kk + t;
    const float af[4] = {a[0], a[8 * LD], a[4], a[8 * LD + 4]};
    uint32_t ab[4], as[4];
    split4(af, ab, as);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* b = tb + (j * 8 + g) * LD + kk + t;
      uint32_t bb0, bs0, bb1, bs1;
      split(b[0], bb0, bs0);
      split(b[4], bb1, bs1);
      mma_tf32(part[NACC - 1][j], as, bb0, bb1);
      mma_tf32(part[NACC > 1 ? 1 : 0][j], ab, bs0, bs1);
      mma_tf32(part[0][j], ab, bb0, bb1);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = NACC > 1 ? part[0][j][e] + (part[1][j][e] +
                                            part[NACC - 1][j][e])
                         : part[0][j][e];
}

// acc (16 x DP, C layout) += A B: A the f32 C tile c (16 x 8 KB), B rows
// [0, 8 KB) of tile tb (k-major: B[k][n] = tb[k][n]), A's k order permuted
// as the header says.  Each n-block's product over a chunk of KC k-blocks
// is summed in a fresh accumulator and then added to acc: the tensor
// cores' f32 sums truncate, which over a long walk (dK dV over G heads x
// query tiles) drifts by more than the tolerance; an f32 add rounds to
// nearest.  KC = KB (the whole tile) at DP <= 64; at DP = 128, 2, so that
// the split A fragments held across the n-blocks do not spill.
template <int DP, int KB>
__device__ __forceinline__ void product_nn(float (&acc)[DP / 8][4],
                                           const float (&c)[KB][4],
                                           const float* tb, int lane) {
  constexpr int LD = ld<DP>();
  constexpr int KC = DP <= 64 || KB < 2 ? KB : 2;
  const int g = lane >> 2, t = lane & 3;
  const float* b = tb + 2 * t * LD + g;
#pragma unroll
  for (int k0 = 0; k0 < KB; k0 += KC) {
    uint32_t ab[KC][4], as[KC][4];
#pragma unroll
    for (int kb = 0; kb < KC; ++kb) {
      const float af[4] = {c[k0 + kb][0], c[k0 + kb][2], c[k0 + kb][1],
                           c[k0 + kb][3]};
      split4(af, ab[kb], as[kb]);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KC; ++kb)
        mma3(part, ab[kb], as[kb], b[(k0 + kb) * 8 * LD + j * 8],
             b[((k0 + kb) * 8 + 1) * LD + j * 8]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e];
    }
  }
}

// One key tile of the online softmax for a warp's 16-row strip: x holds
// the tile's scores (scaled, capped, masked; C layout), m and l the running
// max and this thread's part of the denominator of its rows g and g + 8;
// leaves p = exp(x - m) in x and rescales acc by exp(m_old - m_new).
template <int NB, int OB>
__device__ __forceinline__ void online_softmax(float (&x)[NB][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[OB][4]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
  float corr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = expf(m[h] - mx[h]);   // 0 on a first tile from m = -inf
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] = expf(x[j][e] - m[e >> 1]);
      l[e >> 1] += x[j][e];
    }
#pragma unroll
  for (int j = 0; j < OB; ++j) {
    acc[j][0] *= corr[0];
    acc[j][1] *= corr[0];
    acc[j][2] *= corr[1];
    acc[j][3] *= corr[1];
  }
}

// The forward's work on one key tile for a warp's 16 rows [row0, row0 +
// 16) of sQ: S = Q K^T, score(s, h, c) for the raw product s of the
// thread's row g + 8 h and the tile's column c, the online softmax, and
// acc += P V.  cK and cV hold the tile's kKeys keys.
template <int DP, class Score>
__device__ __forceinline__ void forward_tile(float (&acc)[DP / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             const float* sQ, int row0,
                                             const float* cK, const float* cV,
                                             int lane, Score score) {
  constexpr int NB = kKeys / 8;
  const int t = lane & 3;
  float s[NB][4];
  product_nt<DP, NB>(s, sQ, row0, cK, lane);
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = score(s[j][e], e >> 1, j * 8 + 2 * t + (e & 1));
  online_softmax<NB, DP / 8>(s, m, l, acc);
  product_nn<DP, NB>(acc, s, cV, lane);
}

// Blocks split a strip's key tiles (dK dV: its items) between two warps,
// kSplit halves taking turns, which halves the chain of tiles the heaviest
// warp walks (one and four warps a strip measured slower at lm100m's and
// whisper's shapes); at the end half 1 hands its state to half 0 through
// shared memory, thread by thread (the same lane holds the same rows and
// columns in both), and half 0 merges it in a fixed order: the same bits
// on every run.  scratch: the state of each lane of each strip's half-1
// warp.
constexpr int kSplit = 2;
static_assert(kSplit == 2, "the merges hand over one warp's state");

// The forward's state (acc, m, l) of half 1 merged into half 0's: the
// online softmax of the two halves' keys.
template <int OB>
__device__ __forceinline__ void merge_softmax(float (&acc)[OB][4],
                                              float (&m)[2], float (&l)[2],
                                              const float* scratch, int strip,
                                              int lane) {
  const float* p = scratch + (strip * 32 + lane) * (OB * 4 + 4);
  float c0[2], c1[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m1 = p[OB * 4 + h];
    const float mx = fmaxf(m[h], m1);
    c0[h] = expf(m[h] - mx);
    c1[h] = expf(m1 - mx);
    l[h] = l[h] * c0[h] + p[OB * 4 + 2 + h] * c1[h];
    m[h] = mx;
  }
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[j][e] = acc[j][e] * c0[e >> 1] + p[j * 4 + e] * c1[e >> 1];
}

template <int OB>
__device__ __forceinline__ void hand_over_softmax(float* scratch,
                                                  const float (&acc)[OB][4],
                                                  const float (&m)[2],
                                                  const float (&l)[2],
                                                  int strip, int lane) {
  float* p = scratch + (strip * 32 + lane) * (OB * 4 + 4);
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j * 4 + e] = acc[j][e];
  p[OB * 4] = m[0];
  p[OB * 4 + 1] = m[1];
  p[OB * 4 + 2] = l[0];
  p[OB * 4 + 3] = l[1];
}

// acc (a C-layout sum) += half 1's, read back from scratch.
template <int OB>
__device__ __forceinline__ void merge_sum(float (&acc)[OB][4],
                                          const float* scratch, int strip,
                                          int lane) {
  const float* p = scratch + (strip * 32 + lane) * (OB * 4);
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += p[j * 4 + e];
}

template <int OB>
__device__ __forceinline__ void hand_over_sum(float* scratch,
                                              const float (&acc)[OB][4],
                                              int strip, int lane) {
  float* p = scratch + (strip * 32 + lane) * (OB * 4);
#pragma unroll
  for (int j = 0; j < OB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j * 4 + e] = acc[j][e];
}

// l summed over the quad that shares its rows.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace x3
