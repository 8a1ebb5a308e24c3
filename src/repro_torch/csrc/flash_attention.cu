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
// 3.35 TB/s) and do 8.6 GFLOP over the visible pairs (13 us at two thirds of
// the 989 TFLOP/s peak, about what mma.sync reaches): bytes bound it, so the
// kernel has to keep the tensor cores fed from tiles that are loaded once.
//
// bf16 route (flash_mma_kernel): tensor cores for both products.  One block
// per (b * Hq, tile of BQ query rows); each warp owns 16 or 32 query rows
// (one or two m16 tiles, which then share every K and V fragment).  Q, K and V sit in shared memory as bf16 with D zero-padded to
// DP (a multiple of 16; zero columns leave Q K^T exact), K and V in a
// 2-stage cp.async ring so that the next kv tile loads while this one is
// computed.  S = Q K^T is an mma.sync m16n8k16 product from ldmatrix
// fragments into f32 registers; the scale, cap, mask, row max, row sum and
// the online rescale of the output run on those registers (quad shuffles),
// so S never goes to shared memory; P is rounded to bf16 in registers and
// is the A operand of P V directly (V through ldmatrix.trans).  Work order:
// blockIdx.y counts q tiles from the last, so the long causal tiles start
// first and the last wave holds short ones.  kv tiles that the causal mask
// or the window hide entirely are skipped, except in a q tile that holds a
// row seeing no key (that row needs every key).
//
// f32 route (flash_f32_kernel): scalar f32 FMAs from f32 shared-memory
// tiles, kept for f32 inputs (tests and f32 checks), where TF32 tensor cores
// would miss the 1e-4 tolerance.  The dtype alone chooses the route.
//
// C interface (loaded with ctypes): flash_attention_bhsd(...) returns the
// cudaError_t of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

// (BQ, BK, MW) of the bf16 route by padded head dim, measured at the serve
// shapes by repro_torch/kernels/tune.py (PERF.md has the times): at D = 128
// two m-tiles a warp with 32-key tiles are the fastest that do not spill;
// at D <= 80 one m-tile a warp with 64-key tiles.  A build
// with -DFLASH_BQ=.. -DFLASH_BK=.. -DFLASH_MW=.. (tune.py) takes one triple
// for every D <= 128.
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
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------ bf16 route

// DP: padded head dim (multiple of 16, >= D); BQ query rows and BK keys per
// tile; MW 16-row m-tiles per warp (BQ / (16 MW) warps).  A warp with two
// m-tiles uses each K and V fragment it loads for both.
template <int DP, int BQ, int BK, int MW>
__global__ void __launch_bounds__(BQ * 2 / MW)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                 int group, int Sq, int Sk, int D, int causal, int window,
                 float cap, float scale) {
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

  // kv range that can hold a visible key for some row of this tile.  A row
  // that sees no key at all (window shorter than its distance to the last
  // key) averages V over every key, as the oracle does; a tile holding such
  // a row keeps the whole range.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window) kv_begin = max(0, q0 - window + 1);
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

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

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                          int D, int causal, int window, float cap,
                          float scale, cudaStream_t stream) {
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

  // the kv range, as in the bf16 route
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window) kv_begin = max(0, q0 - window + 1);

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
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

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* o, int B, int Hq, int Hkv, int Sq, int Sk,
                         int D, int causal, int window, float cap,
                         float scale, cudaStream_t stream) {
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
// aligned.  dtype 0 = float32 (scalar route), 1 = bfloat16 (tensor-core
// route).  8 <= D <= 256, D % 8 == 0, Hq % Hkv == 0 (checked by the Python
// wrapper).
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
