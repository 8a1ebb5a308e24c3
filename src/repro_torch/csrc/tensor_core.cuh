// Warp-level tensor-core and asynchronous-copy helpers for sm_90a, shared by
// the hand-written kernels of this directory.
//
// mma.sync m16n8k16 (bf16 in, f32 accumulate) fragment layout, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of two bf16 each:
//     a0 = A[g][2t, 2t+1]   a1 = A[g+8][2t, 2t+1]
//     a2 = A[g][2t+8, +9]   a3 = A[g+8][2t+8, +9]
//   B (16 x 8, k x n), 2 registers:  b0 = B[2t, 2t+1][g]  b1 = B[2t+8, +9][g]
//   C/D (16 x 8, f32):  c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// The low 16 bits of a register hold the element of the smaller index.
//
// Shared-memory tiles are bf16, row-major, with rows padded by 8 elements
// (16 bytes): every row starts 16-byte aligned, and the 8 row addresses of
// one ldmatrix phase fall in 8 distinct groups of 4 banks for the widths
// used here (64, 80, 128 and 256 columns).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; zeros where !valid
// (src-size 0 reads nothing, so src only has to be some valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's committed groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Rows [0, ROWS) x columns [0, COLS) of a row-major bf16 matrix with row
// stride src_ld into a shared tile with row stride LD, by cp.async, THREADS
// threads sharing the copy.  Entries at rows >= rows or columns >= cols are
// zero.  COLS, cols and src_ld are multiples of 8 and src is 16-byte aligned.
template <int ROWS, int COLS, int LD, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int src_ld, int rows,
                                                int cols) {
  constexpr int kVecs = COLS / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * kVecs; i += THREADS) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    const bool ok = r < rows && c < cols;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)r * src_ld + c : src, ok);
  }
}

// Four 8 x 8 bf16 matrices; lanes 8m .. 8m+7 give the row addresses of
// matrix m, and register m receives it.  .trans delivers each transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The 8 x 8 bf16 matrix whose row lane / 4, columns 2 (lane % 4) and + 1
// this lane holds in a (the fragment layout of C above, packed), transposed
// across the warp into the same layout.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// d += a b, one m16n8k16 product.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two floats as hi + lo bf16 pairs (hi = bf16(v), lo = bf16(v - hi)): about
// 16 mantissa bits, for operands that one bf16 rounding would spoil.
__device__ __forceinline__ void pack_split_bf16(float v0, float v1,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Row-major 16 x 16 A fragment at (row0, col0) of a shared tile (stride ld).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int col0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + (lane >> 4) * 8);
}

// A fragment of the transpose: A[m][k] = tile[k0 + k][m0 + m] (the tile
// holds A^T row-major, e.g. B of the SSD stored (q, n) used as (n, q)).
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const bf16* tile, int ld, int m0,
                                             int k0, int lane) {
  ldmatrix_x4_trans(a, tile + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                           m0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two neighbouring n-blocks n0, n0 + 8 over k0 .. k0 + 15 from
// a tile stored n-major (B[k][n] = tile[n][k], e.g. K in Q K^T):
// b[0], b[1] for n0 and b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b_nmajor(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                     ((lane >> 3) & 1) * 8);
}

// The same from a tile stored k-major (B[k][n] = tile[k][n], e.g. V in P V).
__device__ __forceinline__ void load_b_kmajor(uint32_t (&b)[4],
                                              const bf16* tile, int ld,
                                              int n0, int k0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8);
}

}  // namespace tc
