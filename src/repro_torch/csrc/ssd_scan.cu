// Mamba2 SSD chunk scan for Hopper (sm_90a): y and the final state of the
// selective-SSM recurrence from a zero state, computed chunk by chunk in the
// SSD dual form.  f32 or bf16 x, B, C; f32 dt and a; f32 accumulation; y and
// the state in x's type.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan_bhsd,
// body _ssd_kernel).  Same function, per (b, h) and chunk of Q rows:
//   cum    = cumsum(dt * a)
//   y      = ((C B^T) o L o dt_j) x + (C o exp(cum)) state,
//            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_Q) state + B^T (x o dt o exp(cum_Q - cum))
// exp(cum_i - cum_j) is computed only where i >= j (selected, never
// multiplied by a mask: for i < j it can overflow, and inf * 0 is NaN).
//
// Bound.  At the mamba2-1.3b serve shape (B=4, H=64, S=512, P=64, N=128,
// G=1, chunk 256, bf16) the function must read x, dt, B, C and write y and
// the state once (39 MB, 11.7 us at 3.35 TB/s).  Its products are about
// 6.5 GFLOP once C B^T is formed once per (b, group, chunk) and not per
// head: about 10 us at mma.sync rates, so bytes bound it.  The hi + lo
// splits of the rounding plan below double three of the products (about
// 12 GFLOP of mma work, some 20 us), the price of the f32 tolerance.
//
// bf16 route: two kernels, both on tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulate, ldmatrix fragments from padded bf16 tiles).
// 1. ssd_cbt_kernel: S = C B^T does not depend on the head, so it is formed
//    once per (b, group, chunk): one block per lower-triangular 64 x 64 tile
//    (i >= j) writes its f32 accumulator fragments, in fragment order, into
//    a scratch buffer that the wrapper allocates (1.3 MB at the mamba2
//    shape; it stays in L2).
// 2. ssd_mma_kernel: one block per (b, h) (and per 64 columns of P, of which
//    the serve paths have one) walks the chunks in order, 8 warps.  The f32
//    N x 64 state lives in registers, as the accumulators of the state
//    update.  Per chunk: cum is a warp scan; per 128-row query tile (16 rows
//    a warp) y = exp(cum) o (C state) plus, over key tiles j <= i,
//    (S_ij o L o dt_j) x_j, where S_ij comes from the scratch straight into
//    registers and is weighted there; x tiles come through a 2-stage
//    cp.async ring.  Last, state = exp(cum_Q) state + B^T (x o w), B and x
//    tiles again through the ring.  B and C are read by group index, never
//    repeated per head.
//    Rounding plan: inputs are bf16 already; the three f32 operands that
//    meet the tensor cores (the state, the weighted score tile, x o w) go
//    in as hi + lo bf16 pairs, two mmas each, about 16 mantissa bits.  One
//    bf16 rounding of the weighted scores or of x o w puts errors of 2^-9
//    of the typical |y| (tens at these shapes) on every element, which
//    breaks the 2e-2 tolerance where y is near 0 (weak decay); the split
//    keeps the error within a fifth of it.
//
// f32 route (ssd_f32_kernel): scalar f32 FMAs, one block per (b * H,
// 32-column slice of P), kept for f32 inputs (tests and f32 checks).  The
// dtype alone chooses the route.
//
// C interface (loaded with ctypes): ssd_scan(...) returns the cudaError_t
// of the launches, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

// Blocks an SM of the bf16 scan for N <= 128 (its register cap is
// 65536 / (256 threads x this)); rebuilt with other values by
// repro_torch/kernels/tune.py.
#ifndef SSD_MIN_BLOCKS
#define SSD_MIN_BLOCKS 2
#endif

namespace {

using tc::bf16;

constexpr int kTile = 64;        // rows of a score tile, a key tile, an x tile
constexpr int kPW = 64;          // columns of P per block (bf16 route)
constexpr int kLdP = kPW + 8;    // shared row stride of x and state tiles

// Inclusive scan of dt * a over a chunk's Q rows by one warp, 32 rows a step.
__device__ __forceinline__ void warp_cumsum(float* cum, const float* dt,
                                            float ah, int Q, int lane) {
  float carry = 0.f;
  for (int base = 0; base < Q; base += 32) {
    const int idx = base + lane;
    float v = idx < Q ? dt[idx] * ah : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (idx < Q) cum[idx] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// ------------------------------------------------------------ bf16 route

// Number of lower-triangular 64 x 64 tiles of a chunk, and the index of
// tile (i, j), i >= j.
__host__ __device__ __forceinline__ int tile_pairs(int nt) {
  return nt * (nt + 1) / 2;
}
__device__ __forceinline__ int pair_index(int i, int j) {
  return i * (i + 1) / 2 + j;
}

// Scratch layout: for each (b * G + g) * chunks + chunk, each tile pair,
// each of the 4 warps' 16-row strips and each 8-column n-block, 32 float4
// (one per lane: that lane's c0..c3 of the m16n8 accumulator).
__device__ __forceinline__ size_t scratch_index(size_t bgc, int pairs,
                                                int pair, int strip, int nb,
                                                int lane) {
  return (((bgc * pairs + pair) * 4 + strip) * 8 + nb) * 32 + lane;
}

// S = C_i B_j^T for one (b, g, chunk) and tile pair; NP = N padded to a
// multiple of 16.  4 warps, 16 rows each.
template <int NP>
__global__ void __launch_bounds__(128)
ssd_cbt_kernel(const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
               float4* __restrict__ cbt, int S, int N, int Q, int chunks) {
  constexpr int LDN = NP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sC = reinterpret_cast<bf16*>(smem_raw);   // kTile x LDN
  bf16* sB = sC + kTile * LDN;                      // kTile x LDN
  const int bgc = blockIdx.x;
  const int bg = bgc / chunks;
  const int c0 = (bgc - bg * chunks) * Q;
  const int pair = blockIdx.y;
  int i = 0;
  while (tile_pairs(i + 1) <= pair) ++i;
  const int j = pair - tile_pairs(i);
  const size_t base = (size_t)bg * S * N;
  tc::load_tile_async<kTile, NP, LDN, 128>(
      sC, cmat + base + (size_t)(c0 + i * kTile) * N, N, Q - i * kTile, N);
  tc::load_tile_async<kTile, NP, LDN, 128>(
      sB, bmat + base + (size_t)(c0 + j * kTile) * N, N, Q - j * kTile, N);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float acc[8][4];
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
    acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk) {
    uint32_t a[4];
    tc::load_a(a, sC, LDN, warp * 16, kk * 16, lane);
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      uint32_t b[4];
      tc::load_b_nmajor(b, sB, LDN, nb * 8, kk * 16, lane);
      tc::mma_bf16(acc[nb], a, b[0], b[1]);
      tc::mma_bf16(acc[nb + 1], a, b[2], b[3]);
    }
  }
  const int pairs = tile_pairs((Q + kTile - 1) / kTile);
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
    cbt[scratch_index(bgc, pairs, pair, warp, nb, lane)] =
        make_float4(acc[nb][0], acc[nb][1], acc[nb][2], acc[nb][3]);
}

// The scan.  NP = N padded to a multiple of 16 (64, 128 or 256).  8 warps;
// warp w owns state rows 16 (w + 8 u), u < MU, all 64 columns, as f32
// accumulator fragments.
template <int NP>
__global__ void __launch_bounds__(256, NP <= 128 ? SSD_MIN_BLOCKS : 1)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const bf16* __restrict__ bmat,
               const bf16* __restrict__ cmat, const float4* __restrict__ cbt,
               bf16* __restrict__ y, bf16* __restrict__ st, int H, int G,
               int S, int P, int N, int Q) {
  constexpr int kThreads = 256;
  constexpr int LDN = NP + 8;
  constexpr int MB = NP / 16;              // state m-blocks
  constexpr int MU = (MB + 7) / 8;         // m-blocks per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // sCB: the C rows of a 128-row query tile, or two B tiles (ring stages)
  bf16* sCB = reinterpret_cast<bf16*>(smem_raw);   // 2 kTile x LDN
  bf16* sX = sCB + 2 * kTile * LDN;                  // 2 stages x kTile x kLdP
  bf16* sHi = sX + 2 * kTile * kLdP;                 // NP x kLdP
  bf16* sLo = sHi + NP * kLdP;                       // NP x kLdP
  bf16* sXlo = sLo + NP * kLdP;                      // kTile x kLdP
  float* sCum = reinterpret_cast<float*>(sXlo + kTile * kLdP);   // Q
  float* sDt = sCum + Q;                                      // Q
  float* sW = sDt + Q;          // Q: dt * exp(cum_last - cum)

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;                 // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int grp = h / (H / G);
  const int p0 = blockIdx.y * kPW;
  const int pw = min(kPW, P - p0);           // columns of this block
  const float ah = a[h];
  const int chunks = S / Q;
  const int nt = (Q + kTile - 1) / kTile;    // 64-row tiles of a chunk
  const int pairs = tile_pairs(nt);
  const bf16* xp = x + (size_t)bh * S * P + p0;
  const float* dtp = dt + (size_t)bh * S;
  const bf16* bp = bmat + ((size_t)b * G + grp) * S * N;
  const bf16* cp = cmat + ((size_t)b * G + grp) * S * N;
  bf16* yp = y + (size_t)bh * S * P + p0;

  float stv[MU][8][4];                       // the f32 state
#pragma unroll
  for (int u = 0; u < MU; ++u)
#pragma unroll
    for (int nb = 0; nb < 8; ++nb)
      stv[u][nb][0] = stv[u][nb][1] = stv[u][nb][2] = stv[u][nb][3] = 0.f;

  for (int ch = 0; ch < chunks; ++ch) {
    const int c0 = ch * Q;
    const size_t bgc = ((size_t)b * G + grp) * chunks + ch;
    __syncthreads();   // the previous chunk is done with every buffer
    for (int i = threadIdx.x; i < Q; i += kThreads) sDt[i] = dtp[c0 + i];
    // the state as hi + lo bf16 for the inter-chunk term
    if (ch > 0) {
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int mb = warp + 8 * u;
        if (mb >= MB) continue;
#pragma unroll
        for (int nb = 0; nb < 8; ++nb) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int off = (mb * 16 + g + 8 * hf) * kLdP + nb * 8 + 2 * t;
            tc::pack_split_bf16(stv[u][nb][2 * hf], stv[u][nb][2 * hf + 1],
                                *reinterpret_cast<uint32_t*>(sHi + off),
                                *reinterpret_cast<uint32_t*>(sLo + off));
          }
        }
      }
    }
    __syncthreads();
    if (warp == 0) warp_cumsum(sCum, sDt, ah, Q, lane);
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kThreads)
      sW[i] = sDt[i] * expf(cum_last - sCum[i]);
    // sW is read only after the barriers of the key loops below

    // ---- y, one 128-row query tile at a time
    for (int qt = 0; qt * 2 * kTile < Q; ++qt) {
      const int rbase = qt * 2 * kTile;
      const int i = 2 * qt + (warp >> 2);     // this warp's 64-row tile
      const int strip = warp & 3;              // its 16-row strip there
      const int jmax = min(2 * qt + 1, nt - 1);
      const int r0 = rbase + warp * 16 + g;    // rows r0, r0 + 8 (chunk)
      const bool active = i < nt;
      const float cr0 = r0 < Q ? sCum[r0] : 0.f;
      const float cr1 = r0 + 8 < Q ? sCum[r0 + 8] : 0.f;

      tc::load_tile_async<2 * kTile, NP, LDN, kThreads>(
          sCB, cp + (size_t)(c0 + rbase) * N, N, Q - rbase, N);
      tc::load_tile_async<kTile, kPW, kLdP, kThreads>(
          sX, xp + (size_t)c0 * P, P, Q, pw);
      tc::cp_async_commit();

      float acc[8][4];
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
        acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;

      for (int j = 0; j <= jmax; ++j) {
        if (j < jmax) {
          const int k1 = (j + 1) * kTile;
          tc::load_tile_async<kTile, kPW, kLdP, kThreads>(
              sX + ((j + 1) & 1) * kTile * kLdP, xp + (size_t)(c0 + k1) * P,
              P, Q - k1, pw);
          tc::cp_async_commit();
          tc::cp_async_wait<1>();
        } else {
          tc::cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* cX = sX + (j & 1) * kTile * kLdP;

        if (j == 0 && ch > 0 && active) {
          // inter-chunk term: exp(cum_r) (C_r . (hi + lo))
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk) {
            uint32_t af[4];
            tc::load_a(af, sCB, LDN, warp * 16, kk * 16, lane);
#pragma unroll
            for (int nb = 0; nb < 8; nb += 2) {
              uint32_t bf[4];
              tc::load_b_kmajor(bf, sHi, kLdP, nb * 8, kk * 16, lane);
              tc::mma_bf16(acc[nb], af, bf[0], bf[1]);
              tc::mma_bf16(acc[nb + 1], af, bf[2], bf[3]);
              tc::load_b_kmajor(bf, sLo, kLdP, nb * 8, kk * 16, lane);
              tc::mma_bf16(acc[nb], af, bf[0], bf[1]);
              tc::mma_bf16(acc[nb + 1], af, bf[2], bf[3]);
            }
          }
          const float e0 = r0 < Q ? expf(cr0) : 0.f;
          const float e1 = r0 + 8 < Q ? expf(cr1) : 0.f;
#pragma unroll
          for (int nb = 0; nb < 8; ++nb) {
            acc[nb][0] *= e0;
            acc[nb][1] *= e0;
            acc[nb][2] *= e1;
            acc[nb][3] *= e1;
          }
        }

        if (active && j <= i) {
          // intra-chunk term: (S_ij o L o dt_j) x_j, the weighted score
          // split into hi + lo bf16 A fragments in registers
          const float4* sp =
              cbt + scratch_index(bgc, pairs, pair_index(i, j), strip, 0, lane);
          // not unrolled: hoisting all eight float4 loads of the tile would
          // not fit the 128 registers that two blocks an SM leave
#pragma unroll 1
          for (int kk = 0; kk < kTile / 16; ++kk) {
            const float4 f0 = sp[(2 * kk) * 32];
            const float4 f1 = sp[(2 * kk + 1) * 32];
            const int kb = j * kTile + kk * 16 + 2 * t;   // key of f0.x
            float wv[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int r = r0 + ((e >> 1) & 1) * 8;
              const int kq = kb + (e >> 2) * 8 + (e & 1);
              const float cr = (e & 2) ? cr1 : cr0;
              // select, never multiply: exp(cum_r - cum_k) overflows for r < k
              wv[e] = (r >= kq && r < Q)
                          ? wv[e] * expf(cr - sCum[kq]) * sDt[kq]
                          : 0.f;
            }
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              tc::pack_split_bf16(wv[2 * q], wv[2 * q + 1], ahi[q], alo[q]);
#pragma unroll
            for (int nb = 0; nb < 8; nb += 2) {
              uint32_t bf[4];
              tc::load_b_kmajor(bf, cX, kLdP, nb * 8, kk * 16, lane);
              tc::mma_bf16(acc[nb], ahi, bf[0], bf[1]);
              tc::mma_bf16(acc[nb + 1], ahi, bf[2], bf[3]);
              tc::mma_bf16(acc[nb], alo, bf[0], bf[1]);
              tc::mma_bf16(acc[nb + 1], alo, bf[2], bf[3]);
            }
          }
        }
        __syncthreads();   // this x stage is consumed before it is refilled
      }

      // y rows r0, r0 + 8 of this warp
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const int c = nb * 8 + 2 * t;
        if (c >= pw) continue;
        if (r0 < Q)
          *reinterpret_cast<uint32_t*>(yp + (size_t)(c0 + r0) * P + c) =
              tc::pack_bf16(acc[nb][0], acc[nb][1]);
        if (r0 + 8 < Q)
          *reinterpret_cast<uint32_t*>(yp + (size_t)(c0 + r0 + 8) * P + c) =
              tc::pack_bf16(acc[nb][2], acc[nb][3]);
      }
    }

    // ---- state = exp(cum_last) state + B^T (x o w), x o w as hi + lo
    const float decay = expf(cum_last);
#pragma unroll
    for (int u = 0; u < MU; ++u)
#pragma unroll
      for (int nb = 0; nb < 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) stv[u][nb][e] *= decay;
    tc::load_tile_async<kTile, NP, LDN, kThreads>(sCB, bp + (size_t)c0 * N, N,
                                                  Q, N);
    tc::load_tile_async<kTile, kPW, kLdP, kThreads>(sX, xp + (size_t)c0 * P,
                                                    P, Q, pw);
    tc::cp_async_commit();
    for (int j = 0; j < nt; ++j) {
      if (j + 1 < nt) {
        const int k1 = (j + 1) * kTile;
        const int s1 = (j + 1) & 1;
        tc::load_tile_async<kTile, NP, LDN, kThreads>(
            sCB + s1 * kTile * LDN, bp + (size_t)(c0 + k1) * N, N, Q - k1, N);
        tc::load_tile_async<kTile, kPW, kLdP, kThreads>(
            sX + s1 * kTile * kLdP, xp + (size_t)(c0 + k1) * P, P, Q - k1,
            pw);
        tc::cp_async_commit();
        tc::cp_async_wait<1>();
      } else {
        tc::cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* cB = sCB + (j & 1) * kTile * LDN;
      bf16* cX = sX + (j & 1) * kTile * kLdP;
      // x o w: hi in place, lo in sXlo, two columns a thread at a time
      for (int e = threadIdx.x; e < kTile * kPW / 2; e += kThreads) {
        const int r = e / (kPW / 2);
        const int c = (e - r * (kPW / 2)) * 2;
        const int kq = j * kTile + r;
        const float w = kq < Q ? sW[kq] : 0.f;
        uint32_t* hi = reinterpret_cast<uint32_t*>(cX + r * kLdP + c);
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hi));
        tc::pack_split_bf16(xv.x * w, xv.y * w, *hi,
                            *reinterpret_cast<uint32_t*>(sXlo + r * kLdP + c));
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < MU; ++u) {
        const int mb = warp + 8 * u;
        if (mb >= MB) continue;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t af[4];
          tc::load_a_trans(af, cB, LDN, mb * 16, kk * 16, lane);
#pragma unroll
          for (int nb = 0; nb < 8; nb += 2) {
            uint32_t bf[4];
            tc::load_b_kmajor(bf, cX, kLdP, nb * 8, kk * 16, lane);
            tc::mma_bf16(stv[u][nb], af, bf[0], bf[1]);
            tc::mma_bf16(stv[u][nb + 1], af, bf[2], bf[3]);
            tc::load_b_kmajor(bf, sXlo, kLdP, nb * 8, kk * 16, lane);
            tc::mma_bf16(stv[u][nb], af, bf[0], bf[1]);
            tc::mma_bf16(stv[u][nb + 1], af, bf[2], bf[3]);
          }
        }
      }
      __syncthreads();   // this stage is consumed before it is refilled
    }
  }

  // the final state: rows n, columns p0 + p of (N, P)
  bf16* sp = st + (size_t)bh * N * P + p0;
#pragma unroll
  for (int u = 0; u < MU; ++u) {
    const int mb = warp + 8 * u;
    if (mb >= MB) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int c = nb * 8 + 2 * t;
      if (c >= pw) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = mb * 16 + g + 8 * hf;
        if (n < N)
          *reinterpret_cast<uint32_t*>(sp + (size_t)n * P + c) =
              tc::pack_bf16(stv[u][nb][2 * hf], stv[u][nb][2 * hf + 1]);
      }
    }
  }
}

template <int NP>
cudaError_t launch_mma(const void* x, const float* dt, const float* a,
                       const void* bmat, const void* cmat, void* scratch,
                       void* y, void* st, int B, int H, int G, int S, int P,
                       int N, int Q, cudaStream_t stream) {
  constexpr int LDN = NP + 8;
  const int chunks = S / Q;
  const int pairs = tile_pairs((Q + kTile - 1) / kTile);
  const size_t smem1 = sizeof(bf16) * 2 * kTile * LDN;
  auto k1 = ssd_cbt_kernel<NP>;
  cudaError_t err = cudaFuncSetAttribute(
      k1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  k1<<<dim3(B * G * chunks, pairs), 128, smem1, stream>>>(
      static_cast<const bf16*>(bmat), static_cast<const bf16*>(cmat),
      static_cast<float4*>(scratch), S, N, Q, chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem2 =
      sizeof(bf16) * (2 * kTile * LDN + 3 * kTile * kLdP + 2 * NP * kLdP) +
      sizeof(float) * 3 * (size_t)Q;
  auto k2 = ssd_mma_kernel<NP>;
  err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return err;
  k2<<<dim3(B * H, (P + kPW - 1) / kPW), 256, smem2, stream>>>(
      static_cast<const bf16*>(x), dt, a, static_cast<const bf16*>(bmat),
      static_cast<const bf16*>(cmat), static_cast<const float4*>(scratch),
      static_cast<bf16*>(y), static_cast<bf16*>(st), H, G, S, P, N, Q);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* x, const float* dt, const float* a,
                          const void* bmat, const void* cmat, void* scratch,
                          void* y, void* st, int B, int H, int G, int S,
                          int P, int N, int Q, cudaStream_t stream) {
  if (N <= 64)
    return launch_mma<64>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G, S,
                          P, N, Q, stream);
  if (N <= 128)
    return launch_mma<128>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G, S,
                           P, N, Q, stream);
  return launch_mma<256>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G, S, P,
                         N, Q, stream);
}

// ------------------------------------------------------------- f32 route

constexpr int kF32Threads = 256;  // 16 x 16 thread grid over each tile
constexpr int kSlice = 32;        // columns of P per block
constexpr int kLdS = kTile + 1;   // score tile row stride

// kTile rows of a row-major f32 matrix with row stride src_ld into shared
// memory with row stride ld: the first `rows` rows and `cols` columns from
// src, zeros elsewhere in [0, kTile) x [0, width).
__device__ void load_tile_f32(float* dst, int ld, const float* src,
                              int src_ld, int rows, int cols, int width) {
  for (int i = threadIdx.x; i < kTile * width; i += kF32Threads) {
    const int r = i / width;
    const int c = i - r * width;
    dst[r * ld + c] = (r < rows && c < cols) ? src[(size_t)r * src_ld + c] : 0.f;
  }
}

// One block per (b * H, 32-column slice of P) walks the chunks with its
// N x 32 state slice in shared memory; each chunk in 64-row query tiles
// against the key tiles at or before them, C, B, x and the weighted score
// tile in shared memory (row strides N + 1 and 65 against bank conflicts).
// NS = state rows per thread (16 * NS >= N).
template <int NS>
__global__ void __launch_bounds__(kF32Threads)
ssd_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const float* __restrict__ bmat,
               const float* __restrict__ cmat, float* __restrict__ y,
               float* __restrict__ st, int H, int G, int S, int P, int N,
               int Q) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* sC = smem;                       // kTile x ldn: C of the query tile
  float* sB = sC + kTile * ldn;           // kTile x ldn: B of the key tile
  float* sX = sB + kTile * ldn;           // kTile x kSlice: x of the key tile
  float* sS = sX + kTile * kSlice;        // kTile x kLdS: weighted scores
  float* sState = sS + kTile * kLdS;      // N x kSlice
  float* sCum = sState + N * kSlice;      // Q: cumsum(dt * a) in the chunk
  float* sDt = sCum + Q;                  // Q: dt
  float* sEcum = sDt + Q;                 // Q: exp(cum)
  float* sW = sEcum + Q;                  // Q: dt * exp(cum_last - cum)

  const int bh = blockIdx.x;              // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * kSlice;
  const int pw = min(kSlice, P - p0);     // columns of this slice
  const float ah = a[h];
  const float* xp = x + (size_t)bh * S * P + p0;
  const float* dtp = dt + (size_t)bh * S;
  const float* bp = bmat + ((size_t)b * G + g) * S * N;
  const float* cp = cmat + ((size_t)b * G + g) * S * N;
  float* yp = y + (size_t)bh * S * P + p0;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  const int nt = (Q + kTile - 1) / kTile;

  for (int i = threadIdx.x; i < N * kSlice; i += kF32Threads) sState[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();   // the previous chunk is done with sDt and sCum
    for (int i = threadIdx.x; i < Q; i += kF32Threads) sDt[i] = dtp[c0 + i];
    __syncthreads();
    if (threadIdx.x < 32) warp_cumsum(sCum, sDt, ah, Q, lane);
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kF32Threads) {
      sEcum[i] = expf(sCum[i]);
      sW[i] = sDt[i] * expf(cum_last - sCum[i]);
    }

    // this thread's share of B^T (x o w): rows ty + 16 s, columns tx + 16 e
    float upd[NS][2];
#pragma unroll
    for (int s = 0; s < NS; ++s) upd[s][0] = upd[s][1] = 0.f;

    for (int ti = 0; ti < nt; ++ti) {
      const int r0 = ti * kTile;
      const int rows = min(kTile, Q - r0);
      const bool last = ti == nt - 1;
      __syncthreads();   // sC is free; sEcum and sW are written
      load_tile_f32(sC, ldn, cp + (size_t)(c0 + r0) * N, N, rows, N, N);
      __syncthreads();

      // inter-chunk term: acc = exp(cum_r) (C_r . state)
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ldn + n];
        const float s0 = sState[n * kSlice + tx];
        const float s1 = sState[n * kSlice + tx + 16];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(cv[i], s0, acc[i][0]);
          acc[i][1] = fmaf(cv[i], s1, acc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float e = r < rows ? sEcum[r0 + r] : 0.f;
        acc[i][0] *= e;
        acc[i][1] *= e;
      }

      // intra-chunk term over the key tiles at or before this query tile
      for (int tj = 0; tj <= ti; ++tj) {
        const int k0 = tj * kTile;
        const int kn = min(kTile, Q - k0);
        __syncthreads();   // the previous key tile is consumed
        load_tile_f32(sB, ldn, bp + (size_t)(c0 + k0) * N, N, kn, N, N);
        load_tile_f32(sX, kSlice, xp + (size_t)(c0 + k0) * P, P, kn, pw,
                      kSlice);
        __syncthreads();

        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sC[(ty + 16 * i) * ldn + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + 16 * j) * ldn + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + ty + 16 * i;   // row within the chunk
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            // select, never multiply: exp(cum_r - cum_k) overflows for r < k
            const float v = (r >= k && r < Q)
                                ? sc[i][j] * expf(sCum[r] - sCum[k]) * sDt[k]
                                : 0.f;
            sS[(ty + 16 * i) * kLdS + tx + 16 * j] = v;
          }
        }
        __syncthreads();

        for (int kk = 0; kk < kn; ++kk) {
          const float x0 = sX[kk * kSlice + tx];
          const float x1 = sX[kk * kSlice + tx + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float av = sS[(ty + 16 * i) * kLdS + kk];
            acc[i][0] = fmaf(av, x0, acc[i][0]);
            acc[i][1] = fmaf(av, x1, acc[i][1]);
          }
        }
        if (last) {   // state update: B_k^T (x_k w_k), every key tile once
          for (int kk = 0; kk < kn; ++kk) {
            const float w = sW[k0 + kk];
            const float x0 = sX[kk * kSlice + tx] * w;
            const float x1 = sX[kk * kSlice + tx + 16] * w;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const int n = ty + 16 * s;
              const float bv = n < N ? sB[kk * ldn + n] : 0.f;
              upd[s][0] = fmaf(bv, x0, upd[s][0]);
              upd[s][1] = fmaf(bv, x1, upd[s][1]);
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        float* row = yp + (size_t)(c0 + r0 + r) * P;
        if (tx < pw) row[tx] = acc[i][0];
        if (tx + 16 < pw) row[tx + 16] = acc[i][1];
      }
    }

    __syncthreads();   // every tile has read the old state
    const float decay = expf(cum_last);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int n = ty + 16 * s;
      if (n >= N) continue;
      float* sp = sState + n * kSlice;
      sp[tx] = fmaf(decay, sp[tx], upd[s][0]);
      sp[tx + 16] = fmaf(decay, sp[tx + 16], upd[s][1]);
    }
  }

  // the final state: each thread writes the entries it updated itself
  float* sp = st + (size_t)bh * N * P + p0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int n = ty + 16 * s;
    if (n >= N) continue;
    if (tx < pw) sp[(size_t)n * P + tx] = sState[n * kSlice + tx];
    if (tx + 16 < pw) sp[(size_t)n * P + tx + 16] = sState[n * kSlice + tx + 16];
  }
}

template <int NS>
cudaError_t launch_f32(const void* x, const float* dt, const float* a,
                       const void* bmat, const void* cmat, void* y, void* st,
                       int B, int H, int G, int S, int P, int N, int Q,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)kTile * (N + 1) + kTile * kSlice +
                       kTile * kLdS + (size_t)N * kSlice + 4 * (size_t)Q);
  auto kernel = ssd_f32_kernel<NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (P + kSlice - 1) / kSlice);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(x), dt, a, static_cast<const float*>(bmat),
      static_cast<const float*>(cmat), static_cast<float*>(y),
      static_cast<float*>(st), H, G, S, P, N, Q);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* x, const float* dt, const float* a,
                         const void* bmat, const void* cmat, void* y,
                         void* st, int B, int H, int G, int S, int P, int N,
                         int Q, cudaStream_t stream) {
  if (N <= 64)
    return launch_f32<4>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                         stream);
  if (N <= 128)
    return launch_f32<8>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                         stream);
  return launch_f32<16>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                        stream);
}

}  // namespace

// x: (B, H, S, P); dt: (B, H, S) f32; a: (H,) f32; b, c: (B, G, S, N);
// y like x; st: (B, H, N, P).  All contiguous and 16-byte aligned; x, b, c,
// y, st of one dtype: 0 = float32 (scalar route), 1 = bfloat16 (tensor-core
// route, which also needs P % 8 == N % 8 == 0 and a scratch of
// ssd_scan_scratch_floats(B, G, S, Q) f32).  H % G == 0, S % Q == 0,
// N <= 256, Q <= 1024 (checked by the Python wrapper).
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* scratch, void* y,
                        void* st, int B, int H, int G, int S, int P, int N,
                        int Q, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const cudaError_t err =
      dtype == 1 ? dispatch_bf16(x, dtf, af, b, c, scratch, y, st, B, H, G, S,
                                 P, N, Q, s)
                 : dispatch_f32(x, dtf, af, b, c, y, st, B, H, G, S, P, N, Q,
                                s);
  return static_cast<int>(err);
}

// f32 values of the bf16 route's C B^T scratch.
extern "C" long long ssd_scan_scratch_floats(int B, int G, int S, int Q) {
  const int nt = (Q + kTile - 1) / kTile;
  return (long long)B * G * (S / Q) * tile_pairs(nt) * kTile * kTile;
}
