// Fused attention forward for Hopper (sm_90a): GQA, causal, sliding window,
// tanh logit soft-cap, ragged lengths, f32 or bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_bhsd, body _flash_kernel).  Same function: online softmax
// over kv tiles, scale 1/sqrt(D), masked scores set to -1e30, denominator
// clamped at 1e-30, kv head = q head / (Hq / Hkv) so K/V are never repeated.
//
// Design.  One block per (b * Hq, q tile of BQ rows), 256 threads.  The
// TPU walked kv blocks as a sequential grid axis with the running max m,
// denominator l and accumulator in VMEM scratch; blocks on a GPU run in no
// order, so here one block loops over the kv tiles itself.  The Q tile and
// the current K and V tiles sit in shared memory as f32 (row stride D + 1,
// so the column walks hit distinct banks), the score tile too; m and l per
// row sit in shared memory, the output accumulator in registers (each thread
// owns rows ty + 16 i and columns tx + 16 j).  kv tiles that the causal mask
// or the window hide entirely are skipped.
//
// Bound.  At the serve path's shape (B=4, H=32, S=512, D=128, bf16, causal)
// the function must move q, k, v and o once (67 MB) and do about 8.6 GFLOP;
// on an H100 that is memory-bound (bytes take longer than the tensor-core
// FLOPs).  This first kernel computes with scalar f32 FMAs from shared
// memory, not with tensor cores, so it runs well above that bound: moving
// the products onto wgmma/mma and the loads onto TMA is later work.
//
// C interface (loaded with ctypes): flash_attention_bhsd(...) returns the
// cudaError_t of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the TPU kernel's mask value
constexpr int kThreads = 256;       // 16 x 16 thread grid over each tile

__device__ __forceinline__ void load8(const float* src, float* dst) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
  dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows [row0, row0 + rows) of a row-major (S, D) matrix into shared memory
// as f32 with row stride D + 1; rows at or past S are zero.  D % 8 == 0 and
// the source is 16-byte aligned, so each thread moves 8 elements at a time.
template <typename T>
__device__ void load_tile(float* dst, const T* src, int row0, int rows,
                          int S, int D) {
  const int vecs = D / 8;
  for (int i = threadIdx.x; i < rows * vecs; i += kThreads) {
    const int r = i / vecs;
    const int c = (i - r * vecs) * 8;
    float vals[8];
    if (row0 + r < S) {
      load8(src + (size_t)(row0 + r) * D + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = vals[e];
  }
}

// BQ query rows and BK keys per tile; NJ = output columns per thread, so
// the kernel takes D <= 16 * NJ.
template <typename T, int BQ, int BK, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq,
                 int group, int Sq, int Sk, int D, int causal, int window,
                 float cap, float scale) {
  constexpr int RI = BQ / 16;        // rows per thread
  constexpr int CJ = BK / 16;        // score columns per thread
  constexpr int TPR = kThreads / BQ; // threads per row in the softmax step
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
  const T* qp = q + (size_t)bh * Sq * D;
  const T* kp = k + ((size_t)b * Hkv + hkv) * Sk * D;
  const T* vp = v + ((size_t)b * Hkv + hkv) * Sk * D;
  T* op = o + (size_t)bh * Sq * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(sQ, qp, q0, BQ, Sq, D);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // kv range that can hold a visible key for some row of this tile.  A row
  // that sees no key at all (window shorter than its distance to the last
  // key) averages V over every key, as the oracle does; a tile holding such
  // a row keeps the whole range.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = 0;
  if (window > 0 && q_last < Sk - 1 + window) kv_begin = max(0, q0 - window + 1);

  for (int k0 = (kv_begin / BK) * BK; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's K, V and P are consumed
    load_tile(sK, kp, k0, BK, Sk, D);
    load_tile(sV, vp, k0, BK, Sk, D);
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
      if (col < D) store(op + (size_t)r * D + col, acc[i][j] * inv);
    }
  }
}

template <typename T, int BQ, int BK, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                   int window, float cap, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
  auto kernel = flash_fwd_kernel<T, BQ, BK, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hq / Hkv, Sq, Sk, D,
      causal, window, cap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                     int window, float cap, float scale, cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 64, 64, 4>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                window, cap, scale, stream);
  if (D <= 128)
    return launch<T, 64, 64, 8>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                window, cap, scale, stream);
  return launch<T, 32, 32, 16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                               window, cap, scale, stream);
}

}  // namespace

// q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), o like q; all contiguous, 16-byte
// aligned.  dtype 0 = float32, 1 = bfloat16.  8 <= D <= 256, D % 8 == 0,
// Hq % Hkv == 0 (checked by the Python wrapper).
extern "C" int flash_attention_bhsd(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int D, int causal,
                                    int window, float cap, float scale,
                                    int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1
          ? dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal,
                                    window, cap, scale, s)
          : dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, D, causal, window,
                            cap, scale, s);
  return static_cast<int>(err);
}
