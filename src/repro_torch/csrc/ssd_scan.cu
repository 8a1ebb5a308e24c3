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
// multiplied by a mask, never factored into exp(cum_i) exp(-cum_j): for
// i < j it can overflow, and inf * 0 is NaN).
//
// Bound.  At the mamba2-1.3b serve shape (B=4, H=64, S=512, P=64, N=128,
// G=1, chunk 256, bf16) the function must read x, dt, B, C and write y and
// the state once (39 MB, 11.7 us at 3.35 TB/s): bytes bound it.  Its
// products are about 8.6 GFLOP in the form below (C B^T once per pair of
// heads); the hi + lo splits of the rounding plan double three of the
// four, about 14.5 GFLOP of wgmma work (14.7 us at 989 TFLOP/s;
// chip_smoke.ssd_wgmma_flops), so the split work, not the bytes, is the
// floor this design can reach.  Beside it the y kernel weighs every score
// (an ex2, a multiply and the hi + lo split a value), which costs about
// as long as its products, and the state kernel moves the chunk states
// through L2 (8.4 MB written, read back by the y kernel).
//
// Three routes, fixed by dtype, P and N before the launch:
//
// wgmma_bf16 (bf16, P = 64, N = 64 or 128; the serve paths' shapes): two
// kernels, TMA into mbarrier rings, a producer warp, wgmma consumer
// warpgroups (hopper.cuh).  The old route walked each (b, h)'s chunks in
// one block (256 / 320 blocks at the two path shapes, zamba2's leaving a
// second wave), so the state's chain set its time.  Here the chain is cut:
// 1. ssd_wg_state_kernel: one block per (b, h) (all in one wave), a
//    consumer warpgroup per 64 state rows, carries the f32 state S over
//    the chunks in registers (S = exp(cum_Q) S + (B o w)^T x), about a
//    third of the products; a scan warp computes each chunk's cum, w and
//    the y kernel's exponents a chunk ahead.  The state entering each
//    later chunk goes out as hi and lo bf16 tiles and the final state in
//    bf16, staged in the swizzle and stored by TMA.
// 2. ssd_wg_y_kernel: every (64-row query tile, chunk, b, 2 heads) is an
//    independent work item (1,024 at mamba2, 1,280 at zamba2), walked
//    heaviest first by as many blocks as fit the card, the next item's
//    loads issued under this one's tail: y_i = exp(cum_i) o (C_i S_c)
//    plus, over the key tiles j <= i, (C_i B_j^T o L o dt_j) x_j, the
//    weight exp(cum_r - cum_k) dt_k one ex2 of two exponents the state
//    kernel wrote (cum_r log2 e, cum_k log2 e - log2 dt_k).  C B^T is
//    formed on the tensor cores next to its use, once for the item's heads,
//    and never leaves the registers (no scratch round trip); B and C are
//    read by group index, never repeated per head.
// Rounding plan (tests/test_torch_kernel_rounding.py emulates it): x, B
// and C stay bf16 shared tiles (x as the MN-major B operand through the
// transpose bit).  The f32-valued factors go in as hi + lo bf16 pairs on
// the side wgmma takes from registers: the weighted score tile (from the
// C B^T accumulators, as flash feeds P) and (B o w)^T in place of
// B^T (x o w), so x is never split.  The state S_c of C_i S_c has no
// register form: C_i, the A operand, comes from shared memory, and wgmma
// takes B only from shared memory, so S_c is a hi and a lo bf16 tile
// (MN-major).  Each split is needed: one bf16 rounding of any one of the
// three misses 2e-2 with weak decay.
//
// mma_bf16 (other bf16 shapes; all bf16 with -DSSD_FORCE_MMA, for timing
// the old route): two kernels on mma.sync m16n8k16 from ldmatrix
// fragments.
// 1. ssd_cbt_kernel: S = C B^T does not depend on the head, so it is formed
//    once per (b, group, chunk): one block per lower-triangular 64 x 64 tile
//    (i >= j) writes its f32 accumulator fragments, in fragment order, into
//    a scratch buffer that the wrapper allocates.
// 2. ssd_mma_kernel: one block per (b, h) (and per 64 columns of P) walks
//    the chunks in order, 8 warps, the f32 N x 64 state in registers; the
//    state, the weighted score tile and x o w enter as hi + lo bf16 pairs.
//
// scalar_f32 (ssd_f32_kernel): scalar f32 FMAs, one block per (b * H,
// 32-column slice of P), kept for f32 inputs (tests and f32 checks).
//
// C interface (loaded with ctypes): ssd_scan(...) returns the cudaError_t
// of the launches, 0 on success.  ssd_scan_launches(kernel) is how many
// launches of that kernel (0 ssd_cbt_kernel, 1 ssd_mma_kernel,
// 2 ssd_wg_state_kernel, 3 ssd_wg_y_kernel, 4 ssd_f32_kernel) this
// library's kernels have counted on the device, so a caller can see which
// kernels the dispatch below chose.  Each kernel adds one to its device
// counter from one thread a launch, so a CUDA graph's replays are counted
// too; ssd_scan_launches copies it to the host (a synchronous copy: call
// it outside a capture), ~0 on error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

// Blocks an SM of the mma_bf16 scan for N <= 128 (its register cap is
// 65536 / (256 threads x this)).
constexpr int kMmaMinBlocks = 2;

using tc::bf16;

// Launches by kernel, in the order of ssd_scan_launches.
enum Kernel { kCbt, kMma, kWgState, kWgY, kF32, kKernels };
__device__ unsigned long long g_launches[kKernels];

// One launch of ``kernel``, counted by the grid's first thread.
__device__ __forceinline__ void count_launch(Kernel kernel) {
  if ((threadIdx.x | blockIdx.x | blockIdx.y | blockIdx.z) == 0)
    atomicAdd(&g_launches[kernel], 1ull);
}

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
  count_launch(kCbt);
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
__global__ void __launch_bounds__(256, NP <= 128 ? kMmaMinBlocks : 1)
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
  // counted last: at N = 128 the kernel sits at its 128-register cap, and
  // a count at the top spilled
  count_launch(kMma);
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
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

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

// ----------------------------------------------------------- wgmma_bf16 route

constexpr int kWgStages = 3;       // ring stages of the state kernel
constexpr int kYSlots = 8;         // ring slots of the y kernel, a box each
constexpr int kMaxChunk = 1024;    // rows of a chunk (the wrapper's MAX_CHUNK)
constexpr int kMaxDevices = 64;
// y blocks an SM the registers allow, by heads a work item (HB y tiles)
__host__ __device__ constexpr int y_blocks_per_sm(int HB) {
  return HB >= 4 ? 1 : HB == 2 ? 2 : 3;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled
// tile (64 bf16 a row).
__device__ __forceinline__ int sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// One chunk's cum = cumsum(dt * a) over its Q rows by one warp, 256 rows
// (8 loads a lane, issued together) a step: cum into `cum` (shared), and
// for the y kernel (global) each row's exponent cum log2(e) into `rows`
// and each key's cum log2(e) - log2(dt) into `keys`, so that a weight
// exp(cum_r - cum_k) dt_k is ex2(rows_r - keys_k), never formed for
// r < k; returns the last sum.
__device__ __forceinline__ float warp_chunk_cumsum(float* cum, float* rows,
                                                   float* keys,
                                                   const float* dt, float ah,
                                                   int Q, int lane) {
  float carry = 0.f;
  for (int base = 0; base < Q; base += 256) {
    float d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + 32 * u + lane;
      d[u] = idx < Q ? dt[idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int idx = base + 32 * u + lane;
      float v = d[u] * ah;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      v += carry;
      if (idx < Q) {
        cum[idx] = v;
        rows[idx] = v * kLog2e;
        keys[idx] = v * kLog2e - log2f(d[u]);
      }
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  return carry;
}

// Shared memory of the state kernel: kWgStages stages of an x tile (64 rows
// x 64 columns of P) and a B tile (64 rows x N, NB boxes of 64 columns),
// each warpgroup's staging of its state rows (a hi and a lo 64 x 64 tile),
// the mbarriers (the ring's, then w's full and empty of two buffers), then
// w of two chunks (QP floats each) and two decays.
template <int NB>
struct StateSmem {
  static constexpr int kXBytes = 64 * 64 * 2;
  static constexpr int kStage = kXBytes + NB * 64 * 64 * 2;
  static constexpr int kOutOffset = kWgStages * kStage;
  static constexpr int kBarOffset = kOutOffset + NB * 2 * 64 * 64 * 2;
  static constexpr int kWOffset = kBarOffset + (2 * kWgStages + 4) * 8;
  static size_t bytes(int QP) {
    return 1024 + kWOffset + sizeof(float) * (2 * (size_t)QP + 2);
  }
};

// Pass 1: the state at each chunk boundary.  One block per (b, h); NB
// consumer warpgroups (N = 64 NB), warpgroup wg owning state rows
// 64 wg .. + 63 as f32 accumulators; one producer warp issues every TMA
// load, and one more scans dt * a into cum, w and pass 2's exponents a
// chunk ahead of the consumers (w in two buffers behind full / empty
// mbarriers).
// Per chunk: S = exp(cum_last) S, then S += (B o w)^T x over the
// chunk's 64-row tiles, w = dt exp(cum_last - cum): (B o w)^T is the
// register A operand, hi + lo bf16 (ldmatrix.trans of the B tile, times
// w), x the MN-major B operand as TMA delivered it.  The state entering
// chunk c + 1 goes out as hi and lo bf16 (N, P) tiles for pass 2, after
// the last chunk the final state in bf16, each staged in the swizzle and
// stored by TMA.
template <int NB>
__global__ void __launch_bounds__(NB * 128 + 64, NB == 1 ? 3 : 2)
ssd_wg_state_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tb,
                    const __grid_constant__ CUtensorMap ts,
                    const __grid_constant__ CUtensorMap tst,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    float* __restrict__ exps, int H, int G, int S, int Q) {
  count_launch(kWgState);
  using L = StateSmem<NB>;
  constexpr int kConsumers = NB * 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* empty = full + kWgStages;
  uint64_t* w_full = empty + kWgStages;
  uint64_t* w_empty = w_full + 2;
  float* sW = reinterpret_cast<float*>(base + L::kWOffset);
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int bg = b * G + h / (H / G);
  const int chunks = S / Q;
  const int nt = (Q + 63) / 64;
  const int QP = nt * 64;
  float* sDecay = sW + 2 * QP;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * NB);   // one arrival a consumer warp
    }
    for (int u = 0; u < 2; ++u) {
      hopper::mbar_init(&w_full[u], 1);
      hopper::mbar_init(&w_empty[u], 4 * NB);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const float* dtp = dt + (size_t)bh * S;
  if (threadIdx.x >= kConsumers + 32) {
    // the scan warp: w of chunk c into buffer c % 2 once chunk c - 2 is
    // done with it
    const float ah = a[h];
    for (int c = 0; c < chunks; ++c) {
      float* w = sW + (c & 1) * QP;
      if (c >= 2) hopper::mbar_wait(&w_empty[c & 1], ((c - 2) >> 1) & 1);
      const float* dtc = dtp + (size_t)c * Q;
      const size_t row0 = (size_t)bh * S + (size_t)c * Q;
      const float last = warp_chunk_cumsum(w, exps + row0,
                                           exps + (size_t)gridDim.x * S + row0,
                                           dtc, ah, Q, lane);
      __syncwarp();
#pragma unroll 8
      for (int q = lane; q < QP; q += 32)   // dt is in L1 from the scan
        w[q] = q < Q ? dtc[q] * expf(last - w[q]) : 0.f;
      if (lane == 0) sDecay[c & 1] = expf(last);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&w_full[c & 1]);
    }
    return;
  }
  if (threadIdx.x >= kConsumers) {
    if (lane == 0) {                          // the producer
      int k = 0;
      for (int c = 0; c < chunks; ++c)
        for (int j = 0; j < nt; ++j, ++k) {
          const int s = k % kWgStages;
          unsigned char* stage = base + s * L::kStage;
          hopper::mbar_wait(&empty[s], ((k / kWgStages) & 1) ^ 1);
          hopper::mbar_expect_tx(&full[s], L::kStage);
          hopper::tma_load_4d(stage, &tx, &full[s], 0, 64 * j, c, bh);
#pragma unroll
          for (int bx = 0; bx < NB; ++bx)
            hopper::tma_load_4d(stage + L::kXBytes + bx * 8192, &tb,
                                &full[s], 64 * bx, 64 * j, c, bg);
        }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  int k = 0;
  for (int c = 0; c < chunks; ++c) {
    const float* w = sW + (c & 1) * QP;
    hopper::mbar_wait(&w_full[c & 1], (c >> 1) & 1);
    const float decay = sDecay[c & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= decay;

    for (int j = 0; j < nt; ++j, ++k) {
      const int s = k % kWgStages;
      const unsigned char* stage = base + s * L::kStage;
      const unsigned char* bt = stage + L::kXBytes + wg * 8192;
      hopper::mbar_wait(&full[s], (k / kWgStages) & 1);
      // (B o w)^T fragments: rows n = 16 warp + (g, g + 8) of this
      // warpgroup's box, columns q = 16 kk + (2t, 2t + 1, 2t + 8, 2t + 9)
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int row = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int chunk = 2 * warp + ((lane >> 3) & 1);
        uint32_t r[4];
        tc::ldmatrix_x4_trans(
            r, reinterpret_cast<const bf16*>(bt + sw128(row, chunk)));
        const float2 w0 =
            *reinterpret_cast<const float2*>(w + 64 * j + 16 * kk + 2 * t);
        const float2 w8 =
            *reinterpret_cast<const float2*>(w + 64 * j + 16 * kk + 2 * t + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&r[q]));
          const float2 wq = q < 2 ? w0 : w8;
          tc::pack_split_bf16(v.x * wq.x, v.y * wq.y, hi[4 * kk + q],
                              lo[4 * kk + q]);
        }
      }
      hopper::fence_regs(acc);
      hopper::fence_regs(hi);
      hopper::fence_regs(lo);
      hopper::wgmma_fence();
      const bf16* xt = reinterpret_cast<const bf16*>(stage);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hopper::desc_sw128(xt + kk * 16 * 64, 64 * 128,
                                               1024);
        const uint32_t ah[4] = {hi[4 * kk], hi[4 * kk + 1], hi[4 * kk + 2],
                                hi[4 * kk + 3]};
        const uint32_t al[4] = {lo[4 * kk], lo[4 * kk + 1], lo[4 * kk + 2],
                                lo[4 * kk + 3]};
        hopper::wgmma_rs_tb<64>(acc, ah, dx);
        hopper::wgmma_rs_tb<64>(acc, al, dx);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(hi);       // read by the products until the wait
      hopper::fence_regs(lo);
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }
    if (lane == 0) hopper::mbar_arrive(&w_empty[c & 1]);

    // acc is the state after chunk c (rows n, columns p of (N, P = 64)):
    // this warpgroup's 64 rows, staged in the swizzle once its previous
    // stores have read the staging, then stored by TMA
    unsigned char* stg = base + L::kOutOffset + wg * 16384;
    const bool lead = (threadIdx.x & 127) == 0;
    const bool last = c + 1 == chunks;
    if (lead) hopper::tma_store_wait_read();
    hopper::bar_sync(1 + wg, 128);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int off = sw128(16 * warp + g + 8 * hf, jj) + 4 * t;
        const float v0 = acc[4 * jj + 2 * hf], v1 = acc[4 * jj + 2 * hf + 1];
        if (last) {
          *reinterpret_cast<uint32_t*>(stg + off) = tc::pack_bf16(v0, v1);
        } else {
          tc::pack_split_bf16(v0, v1, *reinterpret_cast<uint32_t*>(stg + off),
                              *reinterpret_cast<uint32_t*>(stg + 8192 + off));
        }
      }
    hopper::fence_async_shared();
    hopper::bar_sync(1 + wg, 128);
    if (lead) {
      if (last) {
        hopper::tma_store_3d(&tst, stg, 0, 64 * wg, bh);
      } else {
        const int plane = gridDim.x * (chunks - 1);
        hopper::tma_store_3d(&ts, stg, 0, 64 * wg, bh * (chunks - 1) + c);
        hopper::tma_store_3d(&ts, stg + 8192, 0, 64 * wg,
                             plane + bh * (chunks - 1) + c);
      }
      hopper::tma_store_commit();
    }
  }
  if ((threadIdx.x & 127) == 0) hopper::tma_store_wait_all();
}

// Shared memory of the y kernel: the C tile of a work item's query rows
// (64 x N, NB boxes), kYSlots ring slots of one 64 x 64 bf16 box each (a B
// tile or a state tile takes NB, an x tile one), HB output tiles, the
// mbarriers, then the row and key exponents of HB heads (QP floats each)
// for two work items.
template <int NB, int HB>
struct YSmem {
  static constexpr int kTile = NB * 64 * 64 * 2;
  static constexpr int kRingOffset = kTile;
  static constexpr int kOutOffset = kRingOffset + kYSlots * 8192;
  static constexpr int kBarOffset = kOutOffset + HB * 64 * 64 * 2;
  // 128-byte aligned: the TMA destination of the exponents
  static constexpr int kExOffset =
      kBarOffset + ((2 + 2 * kYSlots) * 8 + 127) / 128 * 128;
  static size_t bytes(int QP) {
    return 1024 + kExOffset + sizeof(float) * 4 * HB * (size_t)QP;
  }
};

// A y work item: 64-row query tile i of chunk c, heads bh0 .. bh0 + HB - 1
// (one group, bg).  Items count from the last query tile and the last
// chunk, so the heaviest come first.
struct YItem {
  int i, c, bh0, bg;
};

__device__ __forceinline__ YItem y_item(int w, int B, int H, int G,
                                        int chunks, int nt, int HB) {
  const int groups = B * H / HB;            // (b, head group) pairs
  const int per_tile = chunks * groups;
  const int tile_rank = w / per_tile;
  const int rem = w - tile_rank * per_tile;
  const int bhg = rem % groups;
  const int b = bhg / (H / HB);
  const int h0 = (bhg - b * (H / HB)) * HB;
  return {nt - 1 - tile_rank, chunks - 1 - rem / groups, b * H + h0,
          b * G + h0 / (H / G)};
}

// The work item of this block in round r (gridDim.x items a round), in
// zigzag: forward in even rounds, backward in odd ones, so the blocks'
// sums of heavy-first items come out even.
__device__ __forceinline__ int y_round_item(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// Pass 2: y.  Each block walks its work items (y_round_item); one consumer
// warpgroup, one producer warp that keeps the loads a work item ahead (C
// and the exponents of the next item once this one's last C B^T is done,
// the ring's boxes as slots free up).  For each head:
//   y = exp(cum_r) o (C_i S_hi + C_i S_lo)       (c > 0; wgmma SS, the
//       state tiles MN-major, the transpose bit)
// then for each key tile j <= i, C_i B_j^T once for the HB heads (wgmma
// SS, K-major), and per head its weights o exp(cum_r - cum_k) dt_k,
// selected where r >= k on the diagonal tile, packed hi + lo into register
// A fragments half a tile at a time: y += W_hi x_j + W_lo x_j (wgmma RS, x
// MN-major), the heads' halves in turn, so each unit's products run while
// the next is weighted and the units in flight feed different
// accumulators.  y is staged in swizzled tiles and stored by TMA, clipped
// at the chunk's end.
template <int NB, int HB>
__global__ void __launch_bounds__(160, y_blocks_per_sm(HB))
ssd_wg_y_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tb,
                const __grid_constant__ CUtensorMap tc_,
                const __grid_constant__ CUtensorMap ts,
                const __grid_constant__ CUtensorMap ty,
                const __grid_constant__ CUtensorMap trow,
                const __grid_constant__ CUtensorMap tkey, int B, int H, int G,
                int S, int Q, int n_items) {
  count_launch(kWgY);
  using L = YSmem<NB, HB>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  const bf16* sC = reinterpret_cast<const bf16*>(base);
  unsigned char* ring = base + L::kRingOffset;
  unsigned char* sOut = base + L::kOutOffset;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* c_empty = c_full + 1;
  uint64_t* full = c_full + 2;
  uint64_t* empty = full + kYSlots;
  const int chunks = S / Q;
  const int nt = (Q + 63) / 64;
  const int QP = nt * 64;
  float* sEx = reinterpret_cast<float*>(base + L::kExOffset);
  const int rounds = (n_items + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    hopper::mbar_init(c_full, 1);
    hopper::mbar_init(c_empty, 4);            // one arrival a consumer warp
#pragma unroll
    for (int s = 0; s < kYSlots; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {                 // the producer
      int k = 0;
      auto slot = [&]() {                     // the next free slot, armed
        const int s = k % kYSlots;
        hopper::mbar_wait(&empty[s], ((k / kYSlots) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 8192);
        ++k;
        return s;
      };
      for (int r = 0; r < rounds; ++r) {
        const int w = y_round_item(r);
        if (w >= n_items) break;              // only in a last, partial round
        const YItem it = y_item(w, B, H, G, chunks, nt, HB);
        float* ex = sEx + (r & 1) * 2 * HB * QP;
        hopper::mbar_wait(c_empty, (r & 1) ^ 1);
        hopper::mbar_expect_tx(c_full,
                               L::kTile + 2 * HB * (it.i + 1) * 64 * 4);
#pragma unroll
        for (int bx = 0; bx < NB; ++bx)
          hopper::tma_load_4d(base + bx * 8192, &tc_, c_full, 64 * bx,
                              64 * it.i, it.c, it.bg);
        for (int hh = 0; hh < HB; ++hh)
          for (int t = 0; t <= it.i; ++t) {
            hopper::tma_load_3d(ex + hh * QP + 64 * t, &trow, c_full, 64 * t,
                                it.c, it.bh0 + hh);
            hopper::tma_load_3d(ex + (HB + hh) * QP + 64 * t, &tkey, c_full,
                                64 * t, it.c, it.bh0 + hh);
          }
        if (it.c > 0)
          for (int hh = 0; hh < HB; ++hh)
            for (int hl = 0; hl < 2; ++hl)
              for (int bx = 0; bx < NB; ++bx) {
                const int s = slot();
                hopper::tma_load_3d(
                    ring + s * 8192, &ts, &full[s], 0, 64 * bx,
                    ((hl * B * H) + it.bh0 + hh) * (chunks - 1) + it.c - 1);
              }
        for (int j = 0; j <= it.i; ++j) {
          for (int bx = 0; bx < NB; ++bx) {
            const int s = slot();
            hopper::tma_load_4d(ring + s * 8192, &tb, &full[s], 64 * bx,
                                64 * j, it.c, it.bg);
          }
          for (int hh = 0; hh < HB; ++hh) {
            const int s = slot();
            hopper::tma_load_4d(ring + s * 8192, &tx, &full[s], 0, 64 * j,
                                it.c, it.bh0 + hh);
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  auto desc_c = [&](int kk) {       // C_i, K-major: k16 slice kk of N
    return hopper::desc_sw128(sC + (kk / 4) * 64 * 64 + (kk % 4) * 16, 16,
                              1024);
  };
  int k = 0;
  auto wait_slot = [&]() {
    const int s = k % kYSlots;
    hopper::mbar_wait(&full[s], (k / kYSlots) & 1);
    ++k;
    return s;
  };
  auto box = [&](int s) {
    return reinterpret_cast<const bf16*>(ring + s * 8192);
  };
  auto release = [&](uint64_t* bar) {
    if (lane == 0) hopper::mbar_arrive(bar);
  };

  for (int r = 0; r < rounds; ++r) {
    const int w = y_round_item(r);
    if (w >= n_items) break;
    const YItem it = y_item(w, B, H, G, chunks, nt, HB);
    const int i = it.i;
    const float* rows = sEx + (r & 1) * 2 * HB * QP;   // cum log2(e)
    const float* keys = rows + HB * QP;                 // - log2(dt)
    hopper::mbar_wait(c_full, r & 1);
    // this thread's rows 16 warp + g (+ 8) of the tile (rows past the chunk
    // are never stored)
    const int row0 = 16 * warp + g;
    float cr[HB][2];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh) {
      cr[hh][0] = rows[hh * QP + 64 * i + row0];
      cr[hh][1] = rows[hh * QP + 64 * i + row0 + 8];
    }
    float y[HB][32];
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int e = 0; e < 32; ++e) y[hh][e] = 0.f;

    if (it.c > 0) {
      // GH heads' state products in one group, their kk steps in turn
      // (their 2 GH NB boxes fit the ring)
      constexpr int GH = 2 * HB * NB <= kYSlots ? HB : kYSlots / (2 * NB);
#pragma unroll
      for (int h1 = 0; h1 < HB; h1 += GH) {
        int sl[GH][2][NB];
#pragma unroll
        for (int u = 0; u < GH; ++u) {
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int bx = 0; bx < NB; ++bx) sl[u][hl][bx] = wait_slot();
          hopper::fence_regs(y[h1 + u]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NB * 4; ++kk)
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int u = 0; u < GH; ++u)
              hopper::wgmma_ss_n64_tb(
                  y[h1 + u], desc_c(kk),
                  hopper::desc_sw128(
                      box(sl[u][hl][kk / 4]) + (kk % 4) * 16 * 64, 64 * 128,
                      1024),
                  1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int u = 0; u < GH; ++u) {
          const int hh = h1 + u;
          hopper::fence_regs(y[hh]);
#pragma unroll
          for (int hl = 0; hl < 2; ++hl)
#pragma unroll
            for (int bx = 0; bx < NB; ++bx) release(&empty[sl[u][hl][bx]]);
          const float e0 = ex2_approx(cr[hh][0]);
          const float e1 = ex2_approx(cr[hh][1]);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            y[hh][4 * jj] *= e0;
            y[hh][4 * jj + 1] *= e0;
            y[hh][4 * jj + 2] *= e1;
            y[hh][4 * jj + 3] *= e1;
          }
        }
      }
    }

    for (int j = 0; j <= i; ++j) {
      float sc[32];
      {
        int sb[NB];
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) sb[bx] = wait_slot();
        hopper::fence_regs(sc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NB * 4; ++kk)
          hopper::wgmma_ss<64>(
              sc, desc_c(kk),
              hopper::desc_sw128(box(sb[kk / 4]) + (kk % 4) * 16, 16, 1024),
              kk > 0);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
#pragma unroll
        for (int bx = 0; bx < NB; ++bx) release(&empty[sb[bx]]);
        if (j == i) release(c_empty);       // the producer loads the next C
      }
      const bool diag = j == i;
      int xs[HB];
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) xs[hh] = wait_slot();
      // units u: part u / HB of the key tile (k16 steps UK part ..
      // UK part + UK - 1) of head u % HB; unit u's A fragments in buffer
      // u % 2, built while unit u - 1's products run
      constexpr int UK = 2;   // 1 and 4 were no faster (tune.py)
      uint32_t hi[2][4 * UK], lo[2][4 * UK];
#pragma unroll
      for (int u = 0; u < 4 / UK * HB; ++u) {
        const int hh = u % HB;
        const int part = u / HB;
        const int bf = u & 1;
        if (u >= 2) {                        // unit u - 2 has read buffer bf
          hopper::wgmma_wait<1>();
          hopper::fence_regs(y[(u - 2) % HB]);
          hopper::fence_regs(hi[bf]);
          hopper::fence_regs(lo[bf]);
        }
        const float* kh = keys + hh * QP + 64 * j;
        // the weights exp(cum_r - cum_k) dt_k o C B^T, hi + lo; on the
        // diagonal tile selected where r >= k, never multiplied by a mask
        // (it overflows for r < k); below it every r > k
        auto weigh = [&](auto on_diag) {
#pragma unroll
          for (int q = 0; q < 2 * UK; ++q) {
            const int jj = 2 * UK * part + q;
            const int col = 8 * jj + 2 * t;        // key 64 j + col (+ 1)
            const float2 ck = *reinterpret_cast<const float2*>(kh + col);
            float v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hf = e >> 1;
              const float ckv = (e & 1) ? ck.y : ck.x;
              const bool keep = !decltype(on_diag)::value ||
                                row0 + 8 * hf >= col + (e & 1);
              v[e] = keep ? sc[4 * jj + e] * ex2_approx(cr[hh][hf] - ckv)
                          : 0.f;
            }
            tc::pack_split_bf16(v[0], v[1], hi[bf][2 * q], lo[bf][2 * q]);
            tc::pack_split_bf16(v[2], v[3], hi[bf][2 * q + 1],
                                lo[bf][2 * q + 1]);
          }
        };
        if (diag)
          weigh(std::true_type{});
        else
          weigh(std::false_type{});
        hopper::fence_regs(y[hh]);
        hopper::fence_regs(hi[bf]);
        hopper::fence_regs(lo[bf]);
        hopper::wgmma_fence();
#pragma unroll
        for (int q = 0; q < UK; ++q) {
          const uint64_t dx = hopper::desc_sw128(
              box(xs[hh]) + (UK * part + q) * 16 * 64, 64 * 128, 1024);
          const uint32_t ah[4] = {hi[bf][4 * q], hi[bf][4 * q + 1],
                                  hi[bf][4 * q + 2], hi[bf][4 * q + 3]};
          const uint32_t al[4] = {lo[bf][4 * q], lo[bf][4 * q + 1],
                                  lo[bf][4 * q + 2], lo[bf][4 * q + 3]};
          hopper::wgmma_rs_tb<64>(y[hh], ah, dx);
          hopper::wgmma_rs_tb<64>(y[hh], al, dx);
        }
        hopper::wgmma_commit();
      }
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int hh = 0; hh < HB; ++hh) {
        hopper::fence_regs(y[hh]);
        release(&empty[xs[hh]]);
      }
      hopper::fence_regs(hi[0]);
      hopper::fence_regs(lo[0]);
      hopper::fence_regs(hi[1]);
      hopper::fence_regs(lo[1]);
    }

    // stage each head's 64 x 64 tile in the 128-byte swizzle (once the
    // previous item's stores have read it), then one TMA store a head,
    // rows past the chunk clipped
    if (tid == 0) hopper::tma_store_wait_read();
    hopper::bar_sync(1, 128);
#pragma unroll
    for (int hh = 0; hh < HB; ++hh)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<uint32_t*>(sOut + hh * 8192 +
                                       sw128(row0 + 8 * hf, jj) + 4 * t) =
              tc::pack_bf16(y[hh][4 * jj + 2 * hf],
                            y[hh][4 * jj + 2 * hf + 1]);
    hopper::fence_async_shared();
    hopper::bar_sync(1, 128);
    if (tid == 0) {
#pragma unroll
      for (int hh = 0; hh < HB; ++hh)
        hopper::tma_store_4d(&ty, sOut + hh * 8192, 0, 64 * i, it.c,
                             it.bh0 + hh);
      hopper::tma_store_commit();
    }
  }
  if (tid == 0) hopper::tma_store_wait_all();
}

// A 4-D map of a contiguous bf16 (outer, chunks, Q, inner) tensor as
// (inner, Q, chunks, outer), boxes of 64 x 64: a box never crosses into the
// next chunk, and rows past Q read as zeros (a store clips them).
bool chunk_map(CUtensorMap* map, const void* ptr, int outer, int chunks,
               int Q, int inner) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)Q,
                              (cuuint64_t)chunks, (cuuint64_t)outer};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)Q * inner * 2,
                                 (cuuint64_t)chunks * Q * inner * 2};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return hopper::tensor_map_bf16(map, ptr, 4, dims, strides, box);
}

// The wgmma route's scratch: the states entering chunks 1 .. chunks - 1,
// hi then lo bf16 (2 B H (chunks - 1), N, 64), then the row and the key
// exponents, f32 (2, B H, S).
size_t state_scratch_bytes(int B, int H, int S, int P, int N, int Q) {
  return 2 * sizeof(bf16) * B * H * (size_t)(S / Q - 1) * N * P +
         2 * sizeof(float) * B * H * (size_t)S;
}

// A 3-D map of a contiguous f32 (outer, chunks, Q) tensor as (Q, chunks,
// outer), boxes of 64 rows of one chunk, no swizzle: rows past Q read as
// zeros.  Q % 4 == 0 (16-byte strides).
bool row_map_f32(CUtensorMap* map, const void* ptr, int outer, int chunks,
                 int Q) {
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Q, (cuuint64_t)chunks,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)Q * 4,
                                 (cuuint64_t)chunks * Q * 4};
  const cuuint32_t box[3] = {64, 1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NB, int HB>
cudaError_t launch_wgmma(const void* x, const float* dt, const float* a,
                         const void* bmat, const void* cmat, void* scratch,
                         void* y, void* st, int B, int H, int G, int S, int N,
                         int Q, cudaStream_t stream) {
  const int chunks = S / Q;
  const int nt = (Q + 63) / 64;
  bf16* states = static_cast<bf16*>(scratch);
  float* exps = reinterpret_cast<float*>(
      static_cast<unsigned char*>(scratch) +
      2 * sizeof(bf16) * B * H * (size_t)(chunks - 1) * N * 64);
  CUtensorMap mx, mb, mc, my, ms;
  if (!chunk_map(&mx, x, B * H, chunks, Q, 64) ||
      !chunk_map(&mb, bmat, B * G, chunks, Q, N) ||
      !chunk_map(&mc, cmat, B * G, chunks, Q, N) ||
      !chunk_map(&my, y, B * H, chunks, Q, 64))
    return cudaErrorInvalidValue;
  // the states, 64-row boxes; one chunk has none (the map is then never
  // read, and is made of y's rows)
  const int planes = 2 * B * H * (chunks - 1);
  const cuuint64_t sdims[3] = {64, (cuuint64_t)N,
                               (cuuint64_t)(planes > 0 ? planes : 1)};
  const cuuint64_t sstrides[2] = {64 * 2, (cuuint64_t)N * 64 * 2};
  const cuuint32_t sbox[3] = {64, 64, 1};
  if (!hopper::tensor_map_bf16(&ms, planes > 0 ? states : y, 3, sdims,
                               sstrides, sbox))
    return cudaErrorInvalidValue;

  const size_t smem1 = StateSmem<NB>::bytes(nt * 64);
  const size_t smem2 = YSmem<NB, HB>::bytes(nt * 64);
  auto k1 = ssd_wg_state_kernel<NB>;
  auto k2 = ssd_wg_y_kernel<NB, HB>;
  // each kernel's shared memory grant, once a device at its largest (a
  // chunk of kMaxChunk rows; the state kernel is shared by the y kernel's
  // instances), and the y kernel's blocks an SM by chunk size: asked of
  // the runtime once, not every call
  static std::mutex mu;
  static bool granted[kMaxDevices] = {};
  static int cached_dev = -1, cached_qp = 0, cached_sms = 0, cached_per_sm = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!granted[dev]) {
      if ((err = cudaFuncSetAttribute(
               k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)StateSmem<NB>::bytes(kMaxChunk))) != cudaSuccess ||
          (err = cudaFuncSetAttribute(
               k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
               (int)YSmem<NB, HB>::bytes(kMaxChunk))) != cudaSuccess)
        return err;
      granted[dev] = true;
    }
    if (dev != cached_dev || nt * 64 != cached_qp) {
      if ((err = cudaDeviceGetAttribute(&cached_sms,
                                        cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &cached_per_sm, k2, 160, smem2)) != cudaSuccess) {
        cached_dev = -1;
        return err;
      }
      cached_dev = dev;
      cached_qp = nt * 64;
    }
    sms = cached_sms;
    per_sm = cached_per_sm;
  }
  // the final state (B H, N, 64) as (64, N, B H), 64-row boxes
  CUtensorMap mst;
  const cuuint64_t tdims[3] = {64, (cuuint64_t)N, (cuuint64_t)B * H};
  if (!hopper::tensor_map_bf16(&mst, st, 3, tdims, sstrides, sbox))
    return cudaErrorInvalidValue;
  k1<<<B * H, NB * 128 + 64, smem1, stream>>>(mx, mb, ms, mst, dt, a, exps, H,
                                              G, S, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  CUtensorMap mrow, mkey;
  if (!row_map_f32(&mrow, exps, B * H, chunks, Q) ||
      !row_map_f32(&mkey, exps + (size_t)B * H * S, B * H, chunks, Q))
    return cudaErrorInvalidValue;
  // as many blocks as fit the card at once, each walking its work items
  // (faster at both path shapes than one block an item: tune.py)
  const int n_items = nt * chunks * (B * H / HB);
  const int grid = min(n_items, max(per_sm, 1) * sms);
  k2<<<grid, 160, smem2, stream>>>(mx, mb, mc, ms, my, mrow, mkey, B, H, G,
                                   S, Q, n_items);
  return cudaGetLastError();
}

// Heads a y work item of the wgmma route: SSD_WG_HEADS (default 2), or
// fewer where the heads of a group do not divide by it.
#ifndef SSD_WG_HEADS
#define SSD_WG_HEADS 2
#endif

template <int NB>
cudaError_t dispatch_wgmma(const void* x, const float* dt, const float* a,
                           const void* bmat, const void* cmat, void* scratch,
                           void* y, void* st, int B, int H, int G, int S,
                           int N, int Q, cudaStream_t stream) {
  const int per_group = H / G;
  if constexpr (SSD_WG_HEADS >= 4)
    if (per_group % 4 == 0)
      return launch_wgmma<NB, 4>(x, dt, a, bmat, cmat, scratch, y, st, B, H,
                                 G, S, N, Q, stream);
  if constexpr (SSD_WG_HEADS >= 2)
    if (per_group % 2 == 0)
      return launch_wgmma<NB, 2>(x, dt, a, bmat, cmat, scratch, y, st, B, H,
                                 G, S, N, Q, stream);
  return launch_wgmma<NB, 1>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G, S,
                             N, Q, stream);
}

// The bf16 routes; `scratch` is the mma route's C B^T scratch or the wgmma
// route's chunk states.
cudaError_t dispatch_bf16(const void* x, const float* dt, const float* a,
                          const void* bmat, const void* cmat, void* scratch,
                          void* y, void* st, int B, int H, int G, int S,
                          int P, int N, int Q, cudaStream_t stream) {
#ifndef SSD_FORCE_MMA
  if (P == 64 && N == 64)
    return dispatch_wgmma<1>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G,
                             S, N, Q, stream);
  if (P == 64 && N == 128)
    return dispatch_wgmma<2>(x, dt, a, bmat, cmat, scratch, y, st, B, H, G,
                             S, N, Q, stream);
#endif
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
  count_launch(kF32);
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
// y, st of one dtype: 0 = float32 (scalar route), 1 = bfloat16: P = 64 and
// N = 64 or 128 take the wgmma route (Q % 4 == 0), with a scratch of
// ssd_scan_state_scratch_bytes(B, H, S, P, N, Q) bytes;
// other shapes (and all with -DSSD_FORCE_MMA) the mma route, which needs
// P % 8 == N % 8 == 0 and a scratch of ssd_scan_scratch_floats(B, G, S, Q)
// f32.  H % G == 0, S % Q == 0, N <= 256, Q <= 1024 (checked by the Python
// wrapper).
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

// Bytes of the wgmma route's scratch: the state entering each chunk but the
// first as hi and lo bf16 (N, P) tiles, and each chunk's cum.
extern "C" long long ssd_scan_state_scratch_bytes(int B, int H, int S, int P,
                                                  int N, int Q) {
  return (long long)state_scratch_bytes(B, H, S, P, N, Q);
}

extern "C" unsigned long long ssd_scan_launches(int kernel) {
  if (kernel < 0 || kernel >= kKernels) return ~0ull;
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n),
                           kernel * sizeof(n)) != cudaSuccess)
    return ~0ull;
  return n;
}
