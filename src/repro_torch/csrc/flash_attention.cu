// Fused attention forward for Hopper (sm_90a): GQA, causal, sliding window,
// tanh logit soft-cap, ragged lengths; f32 or bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel).  Same function: online softmax
// over kv tiles, scale 1/sqrt(D), the tanh soft-cap in f32 before the mask,
// masked scores set to -1e30 (so a row that sees no key averages V over
// every key), keys past Sk weighted exactly 0, denominator clamped at 1e-30,
// kv head = q head / (Hq / Hkv) so K/V are never repeated.
//
// Bound.  At the codeqwen1.5-7b serve shape (B=4, H=32, S=512, D=128, bf16,
// causal) the function must move q, k, v and o once (67 MB, 20 us at
// 3.35 TB/s) against 8.6 GFLOP over the visible pairs (9 us at 989
// TFLOP/s): bytes bound it.  At gemma2-27b's 8192 tokens the FLOPs do
// (0.42 / 0.56 ms windowed / global), and the capped softmax's two MUFU
// results a score (tanh, ex2) take about as long again: there the softmax
// has to run under the products.
//
// Three routes, fixed by dtype and head dim before the launch:
//
// wgmma_bf16 (flash_wgmma_kernel; bf16, D = 64, 80 or 128): warp-specialised.
// A work item is (b * Hq, tile of 128 query rows); a block of 384 threads
// walks its share of them (one block an SM while there are at most 8 items
// an SM, else one block an item): a producer warpgroup whose one thread
// issues every TMA load (each item's Q, then K and V
// tiles of BK keys through rings of ST stages, each stage with a full and
// an empty mbarrier, so the next item's loads run under this one's tail),
// and two consumer warpgroups of 64 query rows each (setmaxnreg moves
// registers from the producer to them).  Tensor maps are 3-D, (D, S,
// B * H), so rows past Sq or Sk read as zeros and a tile never crosses
// into the next head; a row of D = 128 is two 64-column boxes in the
// 128-byte swizzle, and a row of zamba2's D = 80 one such box plus a
// 16-column box in the 32-byte swizzle (a second tensor map an operand),
// so D = 80 moves and multiplies no padding: Q K^T takes a fifth k16 step
// on the 16-column boxes and P V an m64n16k16 product beside the
// m64n64k16 one (120 KB of shared memory at BK = 128, ST = 2; 40 f32 of O
// a thread).  S = Q K^T is wgmma m64nBKk16 with Q and K from
// shared memory (a row-major K tile is the K-major B operand); the scale,
// cap (tanh.approx), mask, online softmax (ex2.approx) and rescale run on
// the accumulator registers; P, packed to bf16 pairs in place, is the
// register A operand of O += P V (wgmma m64nDk16, V MN-major through the
// transpose bit).  Within a warpgroup tile j + 1's Q K^T and tile j's P V
// are in flight while tile j + 1's softmax runs; the two warpgroups take
// turns to issue (named barriers), so one's softmax runs under the other's
// products.  The output is staged in its own tile and stored by TMA,
// clipped at Sq.  The heavy causal tiles come first, dealt to the blocks
// in zigzag rounds so that each block's sum of work comes out even.
//
// mma_bf16 (flash_mma_kernel; bf16, any other D): tensor cores through
// mma.sync m16n8k16.  One block per (b * Hq, tile of BQ query rows); each
// warp owns 16 or 32 query rows (one or two m16 tiles, which then share
// every K and V fragment).  Q, K and V sit in shared memory as bf16 with D
// zero-padded to DP (a multiple of 16; zero columns leave Q K^T exact), K
// and V in a 2-stage cp.async ring; S = Q K^T from ldmatrix fragments into
// f32 registers; the scale, cap, mask, row max, row sum and the online
// rescale run on those registers (quad shuffles); P is rounded to bf16 in
// registers and is the A operand of P V directly (V through
// ldmatrix.trans).  Kept for D other than 64, 80 and 128 (the test dims
// 8..256), and for timing at 64, 80 and 128 (-DFLASH_FORCE_MMA).
//
// Every route skips kv tiles that the causal mask or the window hide
// entirely, except in a q tile that holds a row seeing no key (that row
// needs every key): kv_tiles.
//
// mma_3xtf32 (flash_3xtf32_kernel; f32, D <= 128): both products on the
// tensor cores as split-f32 products (f32_split.cuh, shared with the
// training attention: each f32 operand a TF32 big part plus its TF32
// remainder, three mma.sync m16n8k8.tf32 products, ~21 bits a product,
// where one TF32 rounding keeps 11 and would miss the f32 tolerance).  One
// block per (b * Hq, tile of 32 query rows), so whisper's encoder (B 4 x
// 20 heads x 64 rows) runs on 160 blocks; two warps a 16-row strip split
// its 32-key tiles (by cp.async) and merge at the end; the score, mask
// and online softmax as scalar_f32's on the mma registers.
// -DFLASH_FORCE_SCALAR runs scalar_f32 in its place (the old route, for
// timing in turns).
//
// scalar_f32 (flash_f32_kernel): scalar f32 FMAs from f32 shared-memory
// tiles, kept for f32 at D > 128.
//
// C interface (loaded with ctypes): flash_attention_bhsd(...) returns the
// cudaError_t of the launch, 0 on success.  The tensor maps are encoded on
// the host per call through cuTensorMapEncodeTiled, a driver-API function
// reached by cudaGetDriverEntryPoint (no libcuda link).
// flash_attention_launches(kernel) is how many launches of that kernel
// (0 flash_wgmma_kernel, 1 flash_mma_kernel, 2 flash_f32_kernel, 3
// flash_3xtf32_kernel) this library's kernels have counted on the device,
// so a caller can see which kernel the dispatch below chose.  Each kernel
// adds one to its device counter from one thread a launch, so a CUDA
// graph's replays are counted too; flash_attention_launches copies it to
// the host (a synchronous copy: call it outside a capture), ~0 on error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


#include "f32_split.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

// (BQ, BK, MW) of the mma_bf16 route by padded head dim, measured at the
// serve shapes by repro_torch/kernels/tune.py (PERF.md has the times): at
// D = 128 two m-tiles a warp with 32-key tiles are the fastest that do not
// spill; at D <= 80 one m-tile a warp with 64-key tiles.  A build with
// -DFLASH_BQ=.. -DFLASH_BK=.. -DFLASH_MW=.. (tune.py) takes one triple for
// every D <= 128; with -DFLASH_FORCE_MMA (tune.py, chip_smoke.py's timing of
// the old route) D = 64, 80 and 128 run this route too.
#if defined(FLASH_BQ) && defined(FLASH_BK) && defined(FLASH_MW)
#define FLASH_TILE_D64 FLASH_BQ, FLASH_BK, FLASH_MW
#define FLASH_TILE_D80 FLASH_BQ, FLASH_BK, FLASH_MW
#define FLASH_TILE_D128 FLASH_BQ, FLASH_BK, FLASH_MW
#else
#define FLASH_TILE_D64 64, 64, 1
#define FLASH_TILE_D80 64, 64, 1
#define FLASH_TILE_D128 128, 32, 2
#endif

namespace {

using tc::bf16;

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value

// Launches by kernel, in the order of flash_attention_launches.
enum Kernel { kWgmma, kMma, kF32, kX3, kKernels };
__device__ unsigned long long g_launches[kKernels];

// One launch of ``kernel``, counted by the grid's first thread.
__device__ __forceinline__ void count_launch(Kernel kernel) {
  if ((threadIdx.x | blockIdx.x | blockIdx.y | blockIdx.z) == 0)
    atomicAdd(&g_launches[kernel], 1ull);
}
constexpr float kLog2e = 1.4426950408889634f;

// The kv tiles of BK keys that can hold a visible key for some row of the
// query tile [q0, q0 + rows): the first and how many.  A row that sees no
// key at all (window shorter than its distance to the last key) averages V
// over every key, as the oracle does, so a tile holding such a row keeps
// the whole range.  Every route walks these tiles.
struct KvTiles {
  int begin, count;
};

__device__ __forceinline__ KvTiles kv_tiles(int q0, int rows, int Sq, int Sk,
                                            int causal, int window, int BK) {
  const int q_last = min(q0 + rows, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window) kv_begin = max(0, q0 - window + 1);
  const int begin = kv_begin / BK;
  return {begin, (kv_end + BK - 1) / BK - begin};
}

// ------------------------------------------------------- mma_bf16 route

// DP: padded head dim (multiple of 16, >= D); BQ query rows and BK keys per
// tile; MW 16-row m-tiles per warp (BQ / (16 MW) warps).  A warp with two
// m-tiles uses each K and V fragment it loads for both.
template <int DP, int BQ, int BK, int MW>
__global__ void __launch_bounds__(BQ * 2 / MW)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                 int group, int Sq, int Sk, int D, int causal, int window,
                 float cap, float scale) {
  count_launch(kMma);
  constexpr int kThreads = BQ * 2 / MW;
  constexpr int WR = 16 * MW;      // query rows per warp
  constexpr int LD = DP + 8;       // shared row stride (elements)
  constexpr int NB = BK / 8;       // score n-blocks per m-tile
  constexpr int OB = DP / 8;       // output n-blocks per m-tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);   // BQ x LD
  bf16* sK = sQ + BQ * LD;                          // 2 stages x BK x LD
  bf16* sV = sK + 2 * BK * LD;                      // 2 stages x BK x LD

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.x;                        // b * Hq + h
  const int b = bh / Hq;
  const int hkv = (bh - b * Hq) / group;
  const int Hkv = Hq / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy tiles first
  const bf16* qp = q + (size_t)bh * Sq * D;
  const bf16* kp = k + ((size_t)b * Hkv + hkv) * Sk * D;
  const bf16* vp = v + ((size_t)b * Hkv + hkv) * Sk * D;
  bf16* op = o + (size_t)bh * Sq * D;

  const KvTiles tiles = kv_tiles(q0, BQ, Sq, Sk, causal, window, BK);
  const int t_begin = tiles.begin;
  const int t_end = tiles.begin + tiles.count;

  tc::load_tile_async<BQ, DP, LD, kThreads>(sQ, qp + (size_t)q0 * D, D,
                                            Sq - q0, D);
  tc::load_tile_async<BK, DP, LD, kThreads>(sK, kp + (size_t)t_begin * BK * D,
                                            D, Sk - t_begin * BK, D);
  tc::load_tile_async<BK, DP, LD, kThreads>(sV, vp + (size_t)t_begin * BK * D,
                                            D, Sk - t_begin * BK, D);
  tc::cp_async_commit();

  float acc[MW][OB][4];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int j = 0; j < OB; ++j)
      acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  // rows wr0 + 16 mi + g (h = 0) and + 8 (h = 1): running max (log2
  // domain) and this thread's part of the running denominator
  float m[MW][2], l[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    m[mi][0] = m[mi][1] = kNegInf;
    l[mi][0] = l[mi][1] = 0.f;
  }
  const int wr0 = q0 + warp * WR;
  const float sl2 = scale * kLog2e;

  for (int it = t_begin; it < t_end; ++it) {
    const int st = (it - t_begin) & 1;
    const int k0 = it * BK;
    if (it + 1 < t_end) {   // next tile into the other stage
      const int k1 = k0 + BK;
      tc::load_tile_async<BK, DP, LD, kThreads>(
          sK + (st ^ 1) * BK * LD, kp + (size_t)k1 * D, D, Sk - k1, D);
      tc::load_tile_async<BK, DP, LD, kThreads>(
          sV + (st ^ 1) * BK * LD, vp + (size_t)k1 * D, D, Sk - k1, D);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + st * BK * LD;
    const bf16* cV = sV + st * BK * LD;

    // S = Q K^T for this warp's rows
    float s[MW][NB][4];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        tc::load_a(a[mi], sQ, LD, warp * WR + mi * 16, kk * 16, lane);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t bk[4];
        tc::load_b_nmajor(bk, cK, LD, nb * 8, kk * 16, lane);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          tc::mma_bf16(s[mi][nb], a[mi], bk[0], bk[1]);
          tc::mma_bf16(s[mi][nb + 1], a[mi], bk[2], bk[3]);
        }
      }
    }

    // scale, cap, mask; scores in the log2 domain from here on
    const bool full = k0 + BK <= Sk &&
                      (!causal || k0 + BK - 1 <= wr0) &&
                      (window <= 0 || wr0 + WR - 1 - k0 < window);
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x;
          if (cap != 0.f) {
            x = cap * tanhf(s[mi][nb][e] * scale / cap) * kLog2e;
          } else {
            x = s[mi][nb][e] * sl2;
          }
          if (!full) {
            const int r = wr0 + mi * 16 + g + (e >> 1) * 8;
            const int c = k0 + nb * 8 + 2 * t + (e & 1);
            bool visible = true;
            if (causal) visible = visible && c <= r;
            if (window > 0) visible = visible && (r - c) < window;
            x = visible ? x : kNegInf;
            if (c >= Sk) x = -INFINITY;   // past the end: weight exactly 0
          }
          s[mi][nb][e] = x;
        }
      }
    }

    // online softmax on the registers, per row (quad shuffles)
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      float mx[2] = {m[mi][0], m[mi][1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][nb][0], s[mi][nb][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][nb][2], s[mi][nb][3]));
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[mi][h] - mx[h]);
        m[mi][h] = mx[h];
        l[mi][h] *= corr[h];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mi][nb][e] = exp2f(s[mi][nb][e] - m[mi][e >> 1]);
          l[mi][e >> 1] += s[mi][nb][e];
        }
      }
#pragma unroll
      for (int j = 0; j < OB; ++j) {
        acc[mi][j][0] *= corr[0];
        acc[mi][j][1] *= corr[0];
        acc[mi][j][2] *= corr[1];
        acc[mi][j][3] *= corr[1];
      }
    }

    // acc += P V, P rounded to bf16 as the A operand
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MW][4];
#pragma unroll
      for (int mi = 0; mi < MW; ++mi) {
        a[mi][0] = tc::pack_bf16(s[mi][2 * kk][0], s[mi][2 * kk][1]);
        a[mi][1] = tc::pack_bf16(s[mi][2 * kk][2], s[mi][2 * kk][3]);
        a[mi][2] = tc::pack_bf16(s[mi][2 * kk + 1][0], s[mi][2 * kk + 1][1]);
        a[mi][3] = tc::pack_bf16(s[mi][2 * kk + 1][2], s[mi][2 * kk + 1][3]);
      }
#pragma unroll
      for (int j = 0; j < OB; j += 2) {
        uint32_t bv[4];
        tc::load_b_kmajor(bv, cV, LD, j * 8, kk * 16, lane);
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          tc::mma_bf16(acc[mi][j], a[mi], bv[0], bv[1]);
          tc::mma_bf16(acc[mi][j + 1], a[mi], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is consumed before it is refilled
  }

  // normalise; stage the warp's rows through its own rows of sQ and write
  // them out 16 bytes a lane
  bf16* wq = sQ + warp * WR * LD;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[mi][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      inv[h] = 1.f / fmaxf(lh, 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(wq + (mi * 16 + g) * LD + c) =
          tc::pack_bf16(acc[mi][j][0] * inv[0], acc[mi][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(wq + (mi * 16 + g + 8) * LD + c) =
          tc::pack_bf16(acc[mi][j][2] * inv[1], acc[mi][j][3] * inv[1]);
    }
  }
  __syncwarp();
  constexpr int kVecs = DP / 8;
  for (int i = lane; i < WR * kVecs; i += 32) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    if (wr0 + r < Sq && c < D)
      *reinterpret_cast<uint4*>(op + (size_t)(wr0 + r) * D + c) =
          *reinterpret_cast<const uint4*>(wq + r * LD + c);
  }
}

template <int DP, int BQ, int BK, int MW>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float cap, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(BQ + 4 * BK) * (DP + 8);
  auto kernel = flash_mma_kernel<DP, BQ, BK, MW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kernel<<<grid, BQ * 2 / MW, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hq / Hkv, Sq,
      Sk, D, causal, window, cap, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------- wgmma_bf16 route

// (BK, ST, PINGPONG) of the wgmma route, the same at D = 64, 80 and 128,
// measured at the serve shapes by repro_torch/kernels/tune.py (PERF.md has
// the times).  A build with -DFLASH_WG_BK=.. -DFLASH_WG_ST=..
// -DFLASH_WG_PINGPONG=.. (tune.py) takes others, and -DFLASH_WG_PERSISTENT=0
// or 1 forces one block a work item or one block an SM at every grid size.
#ifndef FLASH_WG_BK
#define FLASH_WG_BK 128
#endif
#ifndef FLASH_WG_ST
#define FLASH_WG_ST 2
#endif
#ifndef FLASH_WG_PINGPONG
#define FLASH_WG_PINGPONG 1
#endif

constexpr int kWgBQ = 128;        // query rows a work item, 64 a warpgroup
constexpr int kWgThreads = 384;   // producer + two consumer warpgroups
// One block an SM walks the work items in zigzag rounds while there are at
// most this many items an SM; past that, one block an item, and the block
// scheduler hands the heavy-first items to the SMs as they free up
// (tune.py: persistent is faster at the 512-token shapes, 3-8 items an
// SM, and slower at gemma2's 8192 tokens, 16-31).
constexpr int kPersistentItemsPerSm = 8;

// Shared memory of the wgmma route: Q, ST stages of K and of V, the output
// staging tile, the mbarriers.  A tile of R rows holds D / 64 boxes of R
// rows x 64 columns in the 128-byte swizzle and, at D = 80, one box of R
// rows x the last 16 columns in the 32-byte swizzle after them.
template <int D, int BK, int ST>
struct WgSmem {
  static constexpr int kBoxes = D / 64;
  static constexpr int kTail = D % 64;            // 0 or 16 columns
  static_assert(kTail == 0 || kTail == 16, "D = 64 n or 64 n + 16");
  static constexpr int kQBytes = kWgBQ * D * 2;   // also the output tile
  static constexpr int kKVBytes = BK * D * 2;     // one K or V stage
  static constexpr int kOOffset = kQBytes + 2 * ST * kKVBytes;
  static constexpr int kBarOffset = kOOffset + kQBytes;
  // + 1024: the base is rounded up to the swizzle's 1024-byte atom
  static constexpr int kBytes = kBarOffset + (2 + 4 * ST) * 8 + 1024;
};

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Scale (and cap), mask and online softmax of one BK-key score tile in the
// accumulator registers s: this thread's rows r0 + g and r0 + g + 8 (r0 the
// warp's first row), keys k0 + 8j + 2t + e.  Leaves exp2(x - m) in s,
// updates the running max m (log2 domain) and this thread's part of the
// row sums l, and returns the rescale factors of the two rows in corr.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int r0, int k0, int g, int t,
                                             int Sk, int causal, int window,
                                             float cap, float sl2,
                                             float cap_in, float cap_out) {
  if (cap != 0.f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      s[i] = cap_out * tanh_approx(s[i] * cap_in);
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
  }
  const bool full = k0 + BK <= Sk && (!causal || k0 + BK - 1 <= r0) &&
                    (window <= 0 || r0 + 15 - k0 < window);
  if (!full) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + g + (e >> 1) * 8;
        const int c = k0 + j * 8 + 2 * t + (e & 1);
        const bool visible = (!causal || c <= r) &&
                             (window <= 0 || r - c < window);
        const float x = visible ? s[4 * j + e] : kNegInf;
        s[4 * j + e] = c >= Sk ? -INFINITY : x;   // past the end: weight 0
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    corr[h] = ex2_approx(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2_approx(s[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

// A work item: one (b * Hq + h, tile of 128 query rows).  Items count from
// the last query tile of every head, so the long causal tiles come first.
struct WgItem {
  int bh, bkv, q0, t_begin, n_tiles;
};

template <int BK>
__device__ __forceinline__ WgItem wg_item(int w, int BH, int Hq, int group,
                                          int Sq, int Sk, int causal,
                                          int window) {
  WgItem it;
  const int n_q = (Sq + kWgBQ - 1) / kWgBQ;
  it.bh = w % BH;
  it.q0 = (n_q - 1 - w / BH) * kWgBQ;
  const int b = it.bh / Hq;
  it.bkv = b * (Hq / group) + (it.bh - b * Hq) / group;
  const KvTiles tiles = kv_tiles(it.q0, kWgBQ, Sq, Sk, causal, window, BK);
  it.t_begin = tiles.begin;
  it.n_tiles = tiles.count;
  return it;
}

// The work item of this block in round r (gridDim.x items a round), in
// zigzag: forward in even rounds, backward in odd ones, so the blocks'
// sums of heavy-first items come out even; n_items or more: none.
__device__ __forceinline__ int wg_round_item(int r) {
  const int g = gridDim.x, b = blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - b : b);
}

// D = 64, 80 or 128; BK keys a kv tile (64 or 128); ST stages of K and of
// V; PINGPONG: the consumer warpgroups take turns to issue their products.
// tq, tk, tv, to: the 64-column boxes; tqt, tkt, tvt, tot: at D = 80 the
// 16-column boxes of columns 64-79 (unused at 64 and 128).  Each block
// walks its work items round by round (wg_round_item); a grid of one block
// a work item is the non-persistent launch.
template <int D, int BK, int ST, bool PINGPONG>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tqt,
                   const __grid_constant__ CUtensorMap tkt,
                   const __grid_constant__ CUtensorMap tvt,
                   const __grid_constant__ CUtensorMap tot, int BH, int Hq,
                   int group, int Sq, int Sk, int causal, int window,
                   float cap, float scale, int n_items) {
  count_launch(kWgmma);
  using L = WgSmem<D, BK, ST>;
  constexpr int NB = L::kBoxes;
  constexpr bool kTail = L::kTail != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sQ = reinterpret_cast<bf16*>(base);
  bf16* sK = reinterpret_cast<bf16*>(base + L::kQBytes);
  bf16* sV = reinterpret_cast<bf16*>(base + L::kQBytes + ST * L::kKVBytes);
  bf16* sO = reinterpret_cast<bf16*>(base + L::kOOffset);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + ST;
  uint64_t* v_full = k_empty + ST;
  uint64_t* v_empty = v_full + ST;

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
  if (wg == 0) {
    // producer: one thread issues every load; the rings' counters run on
    // across work items
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
      int kv = 0, n = 0;
      for (int r = 0; r < rounds; ++r, ++n) {
        const int w = wg_round_item(r);
        if (w >= n_items) break;      // only in a last, partial round
        const WgItem it =
            wg_item<BK>(w, BH, Hq, group, Sq, Sk, causal, window);
        hopper::mbar_wait(q_empty, (n & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::tma_load_3d(sQ + j * kWgBQ * 64, &tq, q_full, 64 * j, it.q0,
                              it.bh);
        if constexpr (kTail)
          hopper::tma_load_3d(sQ + NB * kWgBQ * 64, &tqt, q_full, 64 * NB,
                              it.q0, it.bh);
        for (int i = 0; i < it.n_tiles; ++i, ++kv) {
          const int s = kv % ST;
          const uint32_t ph = (kv / ST) & 1;
          const int k0 = (it.t_begin + i) * BK;
          hopper::mbar_wait(&k_empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&k_full[s], L::kKVBytes);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_3d(sK + s * BK * D + j * BK * 64, &tk,
                                &k_full[s], 64 * j, k0, it.bkv);
          if constexpr (kTail)
            hopper::tma_load_3d(sK + s * BK * D + NB * BK * 64, &tkt,
                                &k_full[s], 64 * NB, k0, it.bkv);
          hopper::mbar_wait(&v_empty[s], ph ^ 1);
          hopper::mbar_expect_tx(&v_full[s], L::kKVBytes);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            hopper::tma_load_3d(sV + s * BK * D + j * BK * 64, &tv,
                                &v_full[s], 64 * j, k0, it.bkv);
          if constexpr (kTail)
            hopper::tma_load_3d(sV + s * BK * D + NB * BK * 64, &tvt,
                                &v_full[s], 64 * NB, k0, it.bkv);
        }
      }
    }
  } else {
    // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63 of each
    // work item
    hopper::reg_alloc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    const float sl2 = scale * kLog2e;
    const float cap_in = cap != 0.f ? scale / cap : 0.f;
    const float cap_out = cap * kLog2e;
    const bf16* q_wg = sQ + cw * 64 * 64;      // in box 0; box j: + j*128*64
    const bf16* q_wg_tail = sQ + NB * kWgBQ * 64 + cw * 64 * 16;

    float o[D / 2], s[BK / 2], m[2], l[2], corr[2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) p[i] = 0u;

    // S = Q K^T of the K tile in stage st into s (overwritten): four k16
    // steps a 64-column box, and at D = 80 one on the 16-column box
    auto issue_s = [&](int st) {
      const bf16* kt = sK + st * BK * D;
#pragma unroll
      for (int kk = 0; kk < NB * 4; ++kk)
        hopper::wgmma_ss<BK>(
            s,
            hopper::desc_sw128(q_wg + (kk / 4) * kWgBQ * 64 + (kk % 4) * 16,
                               16, 1024),
            hopper::desc_sw128(kt + (kk / 4) * BK * 64 + (kk % 4) * 16, 16,
                               1024),
            kk > 0);
      if constexpr (kTail)
        hopper::wgmma_ss<BK>(s, hopper::desc_sw32(q_wg_tail, 16, 256),
                             hopper::desc_sw32(kt + NB * BK * 64, 16, 256),
                             1);
      hopper::wgmma_commit();
    };
    // O += P V of the V tile in stage st: m64n(64 NB)k16 on the 64-column
    // boxes into o[0 .. 32 NB), and at D = 80 m64n16k16 on the 16-column
    // box into o[32 NB ..) (the accumulator layout continues along N)
    auto issue_pv = [&](int st) {
      const bf16* vt = sV + st * BK * D;
      auto& o_boxes = *reinterpret_cast<float(*)[NB * 32]>(&o[0]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        hopper::wgmma_rs_tb<NB * 64>(
            o_boxes, a,
            hopper::desc_sw128(vt + kk * 16 * 64, BK * 128, 1024));
        if constexpr (kTail)
          hopper::wgmma_rs_n16_tb(
              *reinterpret_cast<float(*)[8]>(&o[NB * 32]), a,
              hopper::desc_sw32(vt + NB * BK * 64 + kk * 16 * 16, BK * 32,
                                256));
      }
      hopper::wgmma_commit();
    };
    // registers written by other instructions before the next products
    auto fence_all = [&]() {
      hopper::fence_regs(o);
      hopper::fence_regs(s);
      hopper::fence_regs(p);
      hopper::wgmma_fence();
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < BK / 4; ++j)
        p[j] = tc::pack_bf16(s[2 * j], s[2 * j + 1]);
    };

    if (PINGPONG && cw == 1) hopper::bar_arrive(1, 256);  // 0 issues first
    const int rounds = (n_items + gridDim.x - 1) / gridDim.x;
    int kv = 0, n = 0;
    for (int r = 0; r < rounds; ++r, ++n) {
      const int w = wg_round_item(r);
      if (w >= n_items) break;      // only in a last, partial round
      const bool last = r + 1 >= rounds || wg_round_item(r + 1) >= n_items;
      const WgItem it = wg_item<BK>(w, BH, Hq, group, Sq, Sk, causal, window);
      const int r0 = it.q0 + 64 * cw + 16 * warp;   // this warp's first row
      auto softmax = [&](int i) {
        softmax_tile<BK>(s, m, l, corr, r0, (it.t_begin + i) * BK, g, t, Sk,
                         causal, window, cap, sl2, cap_in, cap_out);
      };
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;
      hopper::mbar_wait(q_full, n & 1);

      // first tile: S_0 and its softmax
      int ks = kv % ST;
      hopper::mbar_wait(&k_full[ks], (kv / ST) & 1);
      if (PINGPONG) hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_s(ks);
      if (PINGPONG) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);
      if (lane == 0) {
        hopper::mbar_arrive(&k_empty[ks]);
        if (it.n_tiles == 1) hopper::mbar_arrive(q_empty);   // Q is read
      }
      softmax(0);
      pack_p();

      // tile i: S_i and P_{i-1} V_{i-1} in flight, then S_i's softmax runs
      // while P V finishes; the rescale waits for it
      for (int i = 1; i < it.n_tiles; ++i) {
        ks = (kv + i) % ST;
        const int vs = (kv + i - 1) % ST;
        hopper::mbar_wait(&k_full[ks], ((kv + i) / ST) & 1);
        hopper::mbar_wait(&v_full[vs], ((kv + i - 1) / ST) & 1);
        if (PINGPONG) hopper::bar_sync(1 + cw, 256);
        fence_all();
        issue_s(ks);
        issue_pv(vs);
        if (PINGPONG) hopper::bar_arrive(2 - cw, 256);
        hopper::wgmma_wait<1>();
        hopper::fence_regs(s);
        if (lane == 0) {
          hopper::mbar_arrive(&k_empty[ks]);
          if (i == it.n_tiles - 1) hopper::mbar_arrive(q_empty);
        }
        softmax(i);
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
        pack_p();
      }

      // last P V; warpgroup 1's very last turn has no follower
      const int vs = (kv + it.n_tiles - 1) % ST;
      hopper::mbar_wait(&v_full[vs], ((kv + it.n_tiles - 1) / ST) & 1);
      if (PINGPONG) hopper::bar_sync(1 + cw, 256);
      fence_all();
      issue_pv(vs);
      if (PINGPONG && !(cw == 1 && last)) hopper::bar_arrive(2 - cw, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      if (lane == 0) hopper::mbar_arrive(&v_empty[vs]);
      kv += it.n_tiles;

      // normalise; stage this warpgroup's rows of the output tile in the
      // boxes' swizzles (once the previous item's store has read them),
      // then one TMA store a box, clipped at Sq
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float lh = l[h];
        lh += __shfl_xor_sync(0xffffffffu, lh, 1);
        lh += __shfl_xor_sync(0xffffffffu, lh, 2);
        inv[h] = 1.f / fmaxf(lh, 1e-30f);
      }
      if (tid == 0) hopper::tma_store_wait_read();
      hopper::bar_sync(3 + cw, 128);
      unsigned char* o_bytes = reinterpret_cast<unsigned char*>(sO);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 64 * cw + 16 * warp + g + 8 * h;   // row of the tile
          // 128-byte swizzle: chunk j % 8 of a 128-byte row at
          // (j % 8) ^ (r % 8); 32-byte swizzle (the last 16 columns):
          // chunk j - 8 NB of a 32-byte row at (j - 8 NB) ^ ((r / 4) % 2)
          const int at =
              j < NB * 8 ? (j / 8) * kWgBQ * 128 + r * 128 +
                               (((j % 8) ^ (r & 7)) << 4)
                         : NB * kWgBQ * 128 + r * 32 +
                               (((j - NB * 8) ^ ((r >> 2) & 1)) << 4);
          *reinterpret_cast<uint32_t*>(o_bytes + at + 4 * t) =
              tc::pack_bf16(o[4 * j + 2 * h] * inv[h],
                            o[4 * j + 2 * h + 1] * inv[h]);
        }
      }
      hopper::fence_async_shared();
      hopper::bar_sync(3 + cw, 128);
      if (tid == 0) {
#pragma unroll
        for (int j = 0; j < NB; ++j)
          hopper::tma_store_3d(&to, sO + j * kWgBQ * 64 + cw * 64 * 64,
                               64 * j, it.q0 + 64 * cw, it.bh);
        if constexpr (kTail)
          hopper::tma_store_3d(&tot, sO + NB * kWgBQ * 64 + cw * 64 * 16,
                               64 * NB, it.q0 + 64 * cw, it.bh);
        hopper::tma_store_commit();
      }
    }
    if (tid == 0) hopper::tma_store_wait_all();
  }
}

// The TMA map of a contiguous bf16 (BH, S, D) tensor as (D, S, BH),
// innermost first: boxes of `cols` columns x `rows` rows x 1 (64 columns
// in the 128-byte swizzle, 16 in the 32-byte one), zeros outside.
bool tensor_map(CUtensorMap* map, const void* ptr, int BH, int S, int D,
                int rows, int cols = 64) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  return hopper::tensor_map_bf16(map, ptr, 3, dims, strides, box,
                                 cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int D, int BK, int ST, bool PINGPONG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Sq, int Sk, int causal,
                         int window, float cap, float scale,
                         cudaStream_t stream) {
  static_assert(D == 64 || D == 80 || D == 128,
                "the wgmma route takes D = 64, 80 or 128");
  static_assert(BK == 64 || BK == 128, "BK = 64 or 128");
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(&mq, q, B * Hq, Sq, D, kWgBQ) ||
      !tensor_map(&mk, k, B * Hkv, Sk, D, BK) ||
      !tensor_map(&mv, v, B * Hkv, Sk, D, BK) ||
      !tensor_map(&mo, o, B * Hq, Sq, D, 64))
    return cudaErrorInvalidValue;
  // D = 80: columns 64-79 as 16-column boxes; else unused copies
  CUtensorMap mqt = mq, mkt = mk, mvt = mv, mot = mo;
  if (D % 64 != 0 && (!tensor_map(&mqt, q, B * Hq, Sq, D, kWgBQ, 16) ||
                      !tensor_map(&mkt, k, B * Hkv, Sk, D, BK, 16) ||
                      !tensor_map(&mvt, v, B * Hkv, Sk, D, BK, 16) ||
                      !tensor_map(&mot, o, B * Hq, Sq, D, 64, 16)))
    return cudaErrorInvalidValue;
  constexpr int smem = WgSmem<D, BK, ST>::kBytes;
  auto kernel = flash_wgmma_kernel<D, BK, ST, PINGPONG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_items = B * Hq * ((Sq + kWgBQ - 1) / kWgBQ);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
#ifdef FLASH_WG_PERSISTENT
  const bool persistent = FLASH_WG_PERSISTENT != 0;
#else
  const bool persistent = n_items <= kPersistentItemsPerSm * sms;
#endif
  const int grid = persistent ? min(n_items, sms) : n_items;
  kernel<<<grid, kWgThreads, smem, stream>>>(
      mq, mk, mv, mo, mqt, mkt, mvt, mot, B * Hq, Hq, Hq / Hkv, Sq, Sk,
      causal, window, cap, scale, n_items);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                          int D, int causal, int window, float cap,
                          float scale, cudaStream_t stream) {
#ifndef FLASH_FORCE_MMA
  constexpr bool kPingPong = FLASH_WG_PINGPONG != 0;
  if (D == 64)
    return launch_wgmma<64, FLASH_WG_BK, FLASH_WG_ST, kPingPong>(
        q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, cap, scale, stream);
  if (D == 80)
    return launch_wgmma<80, FLASH_WG_BK, FLASH_WG_ST, kPingPong>(
        q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, cap, scale, stream);
  if (D == 128)
    return launch_wgmma<128, FLASH_WG_BK, FLASH_WG_ST, kPingPong>(
        q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, window, cap, scale, stream);
#endif
  if (D <= 64)
    return launch_mma<64, FLASH_TILE_D64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                          causal, window, cap, scale, stream);
  if (D <= 80)
    return launch_mma<80, FLASH_TILE_D80>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                          causal, window, cap, scale, stream);
  if (D <= 128)
    return launch_mma<128, FLASH_TILE_D128>(q, k, v, o, B, Hq, Hkv, Sq, Sk,
                                            D, causal, window, cap, scale,
                                            stream);
  return launch_mma<256, 64, 32, 1>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                    causal, window, cap, scale, stream);
}

// ------------------------------------------------------------- f32 route

constexpr int kF32Threads = 256;   // 16 x 16 thread grid over each tile

// Rows [row0, row0 + rows) of a row-major (S, D) f32 matrix into shared
// memory with row stride D + 1; rows at or past S are zero.  D % 8 == 0.
__device__ void load_tile_f32(float* dst, const float* src, int row0,
                              int rows, int S, int D) {
  const int vecs = D / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kF32Threads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < S) {
      const float4* s = reinterpret_cast<const float4*>(
          src + (size_t)(row0 + r) * D + c);
      a = s[0];
      b = s[1];
    }
    float* d = dst + r * (D + 1) + c;
    d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
    d[4] = b.x; d[5] = b.y; d[6] = b.z; d[7] = b.w;
  }
}

// BQ query rows and BK keys per tile; NJ = output columns per thread, so
// the kernel takes D <= 16 * NJ.  Q, K, V and the score tile in shared
// memory as f32 (row stride D + 1), m and l per row there too, the output
// accumulator in registers (thread owns rows ty + 16 i, columns tx + 16 j).
template <int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Hq,
                 int group, int Sq, int Sk, int D, int causal, int window,
                 float cap, float scale) {
  count_launch(kF32);
  constexpr int RI = BQ / 16;        // rows per thread
  constexpr int CJ = BK / 16;        // score columns per thread
  constexpr int TPR = kF32Threads / BQ;  // threads per row in the softmax
  constexpr int LS = BK + 1;         // score tile row stride
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;                  // BQ x ld
  float* sK = sQ + BQ * ld;          // BK x ld
  float* sV = sK + BK * ld;          // BK x ld
  float* sS = sV + BK * ld;          // BQ x LS: scores, then probabilities
  float* sM = sS + BQ * LS;          // running max per row
  float* sL = sM + BQ;               // running denominator per row
  float* sC = sL + BQ;               // this tile's rescale factor per row

  const int bh = blockIdx.x;         // b * Hq + h
  const int b = bh / Hq;
  const int hkv = (bh - b * Hq) / group;
  const int Hkv = Hq / group;
  const int q0 = blockIdx.y * BQ;
  const float* qp = q + (size_t)bh * Sq * D;
  const float* kp = k + ((size_t)b * Hkv + hkv) * Sk * D;
  const float* vp = v + ((size_t)b * Hkv + hkv) * Sk * D;
  float* op = o + (size_t)bh * Sq * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile_f32(sQ, qp, q0, BQ, Sq, D);
  for (int r = threadIdx.x; r < BQ; r += kF32Threads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const KvTiles tiles = kv_tiles(q0, BQ, Sq, Sk, causal, window, BK);
  for (int k0 = tiles.begin * BK; k0 < (tiles.begin + tiles.count) * BK;
       k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile_f32(sK, kp, k0, BK, Sk, D);
    load_tile_f32(sV, vp, k0, BK, Sk, D);
    __syncthreads();

    // S = scale * Q K^T, capped and masked
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool visible = true;
        if (causal) visible = visible && c <= r;
        if (window > 0) visible = visible && (r - c) < window;
        x = visible ? x : kNegInf;
        if (c >= Sk) x = -INFINITY;   // past the end: weight exactly 0
        sS[(ty + 16 * i) * LS + tx + 16 * j] = x;
      }
    }
    __syncthreads();

    // online softmax: TPR threads per row, reduced with warp shuffles
    {
      const int r = threadIdx.x / TPR;
      const int g = threadIdx.x % TPR;
      float* row = sS + r * LS;
      float mx = -INFINITY;
      for (int c = g; c < BK; c += TPR) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = g; c < BK; c += TPR) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (g == 0) {
        const float corr = expf(m_prev - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    const int kn = min(BK, Sk - k0);
    for (int c = 0; c < kn; ++c) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sS[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < D ? sV[c * ld + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float inv = 1.f / fmaxf(sL[ty + 16 * i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) op[(size_t)r * D + col] = acc[i][j] * inv;
    }
  }
}

template <int BQ, int BK, int NJ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int D,
                       int causal, int window, float cap, float scale,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
  auto kernel = flash_f32_kernel<BQ, BK, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kernel<<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hq / Hkv, Sq,
      Sk, D, causal, window, cap, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------ mma_3xtf32 route

// As the training attention's forward (train_attention.cu, mma_3xtf32): a
// block owns 32 query rows, two strips of 16, each worked by two warps
// that split the strip's kv tiles between them and merge at the end
// (x3::merge_softmax); a step's two tiles come by cp.async into one
// stage.
constexpr int kX3Threads = 64 * x3::kSplit;
constexpr int kX3Rows = 32;

// One block a (b * Hq, tile of 32 query rows), the heavy causal tiles
// first; each warp runs x3::forward_tile over its half of the strip's kv
// tiles with this route's score (scalar_f32's: scale, tanh cap, -1e30
// where masked, -inf past Sk) from a running max of -1e30, so a row that
// sees no key averages V over every key, as the oracle does.  CAP: the cap
// compiled in (1) or out (0), so the uncapped kernel carries no tanhf in
// its unrolled tiles.
template <int DP, int CAP>
__global__ void __launch_bounds__(kX3Threads)
flash_3xtf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int Hq, int group, int Sq, int Sk, int D, int causal,
                    int window, float cap, float scale) {
  count_launch(kX3);
  constexpr int OB = DP / 8;
  constexpr int TK = x3::kKeys * x3::ld<DP>();
  extern __shared__ __align__(16) float x3_smem[];
  float* sQ = x3_smem;                        // kX3Rows rows
  float* sK = sQ + kX3Rows * x3::ld<DP>();    // kSplit tiles, one a half
  float* sV = sK + x3::kSplit * TK;           // kSplit tiles, one a half

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strip = warp & 1, half = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;                  // b * Hq + h
  const int b = bh / Hq;
  const int hkv = (bh - b * Hq) / group;
  const int Hkv = Hq / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kX3Rows;
  const float* qp = q + (size_t)bh * Sq * D;
  const float* kp = k + ((size_t)b * Hkv + hkv) * Sk * D;
  const float* vp = v + ((size_t)b * Hkv + hkv) * Sk * D;
  const KvTiles tiles = kv_tiles(q0, kX3Rows, Sq, Sk, causal, window,
                                 x3::kKeys);
  const int tb = tiles.begin, te = tiles.begin + tiles.count;
  const int steps = (tiles.count + x3::kSplit - 1) / x3::kSplit;
  auto load_step = [&](int p) {   // step p's kv tiles, one a half
#pragma unroll
    for (int hf = 0; hf < x3::kSplit; ++hf) {
      const int it = tb + p * x3::kSplit + hf;
      if (it < te) {
        x3::load_rows<x3::kKeys, DP, kX3Threads>(sK + hf * TK, kp, D,
                                                 it * x3::kKeys, Sk, D);
        x3::load_rows<x3::kKeys, DP, kX3Threads>(sV + hf * TK, vp, D,
                                                 it * x3::kKeys, Sk, D);
      }
    }
    tc::cp_async_commit();
  };

  x3::load_rows<kX3Rows, DP, kX3Threads>(sQ, qp, D, q0, Sq, D);

  float acc[OB][4];
#pragma unroll
  for (int j = 0; j < OB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row[2] = {q0 + strip * 16 + g, q0 + strip * 16 + g + 8};

  for (int p = 0; p < steps; ++p) {
    load_step(p);   // Q joins step 0
    tc::cp_async_wait<0>();
    __syncthreads();
    const int it = tb + p * x3::kSplit + half;
    if (it < te) {
      const int k0 = it * x3::kKeys;
      x3::forward_tile<DP>(
          acc, m, l, sQ, strip * 16, sK + half * TK, sV + half * TK, lane,
          [&](float s, int hh, int cc) {
            const int r = row[hh], c = k0 + cc;
            float x = s * scale;
            if (CAP) x = cap * tanhf(x / cap);
            bool visible = true;
            if (causal) visible = visible && c <= r;
            if (window > 0) visible = visible && (r - c) < window;
            x = visible ? x : kNegInf;
            return c >= Sk ? -INFINITY : x;
          });
    }
    __syncthreads();   // this step's tiles are consumed before the next
  }
  if (half == 1) x3::hand_over_softmax(sK, acc, m, l, strip, lane);
  __syncthreads();
  if (half == 1) return;
  x3::merge_softmax(acc, m, l, sK, strip, lane);

  float* op = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv = 1.f / fmaxf(x3::quad_sum(l[hh]), 1e-30f);
    if (row[hh] >= Sq) continue;
#pragma unroll
    for (int j = 0; j < OB; ++j) {
      const int c = j * 8 + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(op + (size_t)row[hh] * D + c) =
            make_float2(acc[j][2 * hh] * inv, acc[j][2 * hh + 1] * inv);
    }
  }
}

template <int DP, int CAP>
cudaError_t launch_x3_cap(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                          int D, int causal, int window, float cap,
                          float scale, cudaStream_t stream) {
  const int smem = (int)sizeof(float) *
                   (kX3Rows + 2 * x3::kSplit * x3::kKeys) *
                   x3::ld<DP>();
  auto kernel = flash_3xtf32_kernel<DP, CAP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + kX3Rows - 1) / kX3Rows);
  kernel<<<grid, kX3Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, Hq / Hkv, Sq,
      Sk, D, causal, window, cap, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_x3(const void* q, const void* k, const void* v, void* o,
                      int B, int Hq, int Hkv, int Sq, int Sk, int D,
                      int causal, int window, float cap, float scale,
                      cudaStream_t stream) {
  return cap != 0.f
             ? launch_x3_cap<DP, 1>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                    causal, window, cap, scale, stream)
             : launch_x3_cap<DP, 0>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D,
                                    causal, window, cap, scale, stream);
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                         int D, int causal, int window, float cap,
                         float scale, cudaStream_t stream) {
#ifndef FLASH_FORCE_SCALAR
  if (D <= 32)
    return launch_x3<32>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                         cap, scale, stream);
  if (D <= 64)
    return launch_x3<64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                         cap, scale, stream);
  if (D <= 128)
    return launch_x3<128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                          cap, scale, stream);
#endif
  if (D <= 64)
    return launch_f32<64, 64, 4>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                 window, cap, scale, stream);
  if (D <= 128)
    return launch_f32<64, 64, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                 window, cap, scale, stream);
  return launch_f32<32, 32, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                window, cap, scale, stream);
}

}  // namespace

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), o like q; all contiguous, 16-byte
// aligned.  dtype 0 = float32 (mma_3xtf32 at D <= 128, else scalar_f32;
// scalar_f32 at every D with -DFLASH_FORCE_SCALAR), 1 = bfloat16
// (wgmma_bf16 at D = 64, 80 and 128, else mma_bf16).  8 <= D <= 256,
// D % 8 == 0, Hq % Hkv == 0 (checked by the Python wrapper).
extern "C" int flash_attention_bhsd(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D, int causal,
                                    int window, float cap, float scale,
                                    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch_bf16(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                 window, cap, scale, s)
                 : dispatch_f32(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                window, cap, scale, s);
  return static_cast<int>(err);
}

extern "C" unsigned long long flash_attention_launches(int kernel) {
  if (kernel < 0 || kernel >= kKernels) return ~0ull;
  unsigned long long n = 0;
  if (cudaMemcpyFromSymbol(&n, g_launches, sizeof(n),
                           kernel * sizeof(n)) != cudaSuccess)
    return ~0ull;
  return n;
}
