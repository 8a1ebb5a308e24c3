// Mamba2 SSD chunk scan for Hopper (sm_90a): y and the final state of the
// selective-SSM recurrence from a zero state, computed chunk by chunk in the
// SSD dual form.  f32 or bf16 x, B, C; f32 dt and a; f32 arithmetic inside;
// y and the state in x's type.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_scan_bhsd,
// body _ssd_kernel).  Same function, per (b, h) and chunk of Q rows:
//   cum    = cumsum(dt * a)
//   y      = ((C B^T) o L o dt_j) x + (C o exp(cum)) state,
//            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_Q) state + B^T (x o dt o exp(cum_Q - cum))
//
// Design.  The TPU walked the chunks as a sequential grid axis with the state
// in VMEM scratch.  GPU blocks run in no order, so one block per (b * H,
// 32-column slice of P) loops over the chunks itself; column p of y and of
// the state depends only on column p of x, so the slices are independent.
// The block keeps its N x 32 slice of the state in shared memory as f32.  A
// chunk's Q x Q score matrix and its C and B rows do not fit in 227 KB, so
// the chunk is walked in 64-row query tiles i against key tiles j <= i:
// S_ij = C_i B_j^T, weighted by exp(cum_i - cum_j) dt_j where i >= j (the
// exponential is computed only there: for i < j it can overflow, and
// inf * 0 is NaN), then y_i += S_ij x_j; y_i starts as exp(cum_i) C_i state.
// The last query tile meets every key tile, so it also gathers the chunk's
// state update in registers; the state is updated when the chunk's tiles
// are done.  B and C are read by group index (head h reads group
// h / (H / G)), never repeated per head.  C, B, x and the score tile sit in
// shared memory as f32 (row stride N + 1 for C and B, 64 + 1 for the scores,
// so the column walks hit distinct banks); cum is a warp scan per chunk.
//
// Bound.  At the mamba2-1.3b serve shape (B=4, H=64, S=512, P=64, N=128,
// G=1, chunk 256, bf16) the function must read x, dt, B, C and write y and
// the state once (about 39 MB) and do about 10.8 GFLOP: both take about
// 11 us on an H100.  This first kernel computes with scalar f32 FMAs from
// shared memory and recomputes C B^T for every head and P slice, so it runs
// well above that bound: tensor cores (mma/wgmma on C B^T and on S x) and
// sharing C B^T across the heads of a group are later work.
//
// C interface (loaded with ctypes): ssd_scan(...) returns the cudaError_t
// of the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 thread grid over each tile
constexpr int kTile = 64;       // rows of a query tile and of a key tile
constexpr int kSlice = 32;      // columns of P per block
constexpr int kLdS = kTile + 1; // score tile row stride

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// kTile rows of a row-major matrix with row stride src_ld into shared memory
// as f32 with row stride ld: the first `rows` rows and `cols` columns from
// src, zeros elsewhere in [0, kTile) x [0, width).
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* src, int src_ld,
                          int rows, int cols, int width) {
  for (int i = threadIdx.x; i < kTile * width; i += kThreads) {
    const int r = i / width;
    const int c = i - r * width;
    dst[r * ld + c] =
        (r < rows && c < cols) ? to_f32(src[(size_t)r * src_ld + c]) : 0.f;
  }
}

// NS = state rows per thread (16 * NS >= N).
template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bmat,
                const T* __restrict__ cmat, T* __restrict__ y,
                T* __restrict__ st, int H, int G, int S, int P, int N,
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
  const T* xp = x + (size_t)bh * S * P + p0;
  const float* dtp = dt + (size_t)bh * S;
  const T* bp = bmat + ((size_t)b * G + g) * S * N;
  const T* cp = cmat + ((size_t)b * G + g) * S * N;
  T* yp = y + (size_t)bh * S * P + p0;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31;
  const int nt = (Q + kTile - 1) / kTile;

  for (int i = threadIdx.x; i < N * kSlice; i += kThreads) sState[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();   // the previous chunk is done with sDt and sCum
    for (int i = threadIdx.x; i < Q; i += kThreads) sDt[i] = dtp[c0 + i];
    __syncthreads();
    if (threadIdx.x < 32) {   // inclusive scan of dt * a, 32 rows a step
      float carry = 0.f;
      for (int base = 0; base < Q; base += 32) {
        const int idx = base + lane;
        float v = idx < Q ? sDt[idx] * ah : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float t = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += t;
        }
        v += carry;
        if (idx < Q) sCum[idx] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cum_last = sCum[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kThreads) {
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
      load_tile(sC, ldn, cp + (size_t)(c0 + r0) * N, N, rows, N, N);
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
        load_tile(sB, ldn, bp + (size_t)(c0 + k0) * N, N, kn, N, N);
        load_tile(sX, kSlice, xp + (size_t)(c0 + k0) * P, P, kn, pw, kSlice);
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
        T* row = yp + (size_t)(c0 + r0 + r) * P;
        if (tx < pw) store(row + tx, acc[i][0]);
        if (tx + 16 < pw) store(row + tx + 16, acc[i][1]);
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
  T* sp = st + (size_t)bh * N * P + p0;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int n = ty + 16 * s;
    if (n >= N) continue;
    if (tx < pw) store(sp + (size_t)n * P + tx, sState[n * kSlice + tx]);
    if (tx + 16 < pw)
      store(sp + (size_t)n * P + tx + 16, sState[n * kSlice + tx + 16]);
  }
}

size_t smem_bytes(int N, int Q) {
  return sizeof(float) * (2 * (size_t)kTile * (N + 1) + kTile * kSlice +
                          kTile * kLdS + (size_t)N * kSlice + 4 * (size_t)Q);
}

template <typename T, int NS>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bmat, const void* cmat, void* y, void* st,
                   int B, int H, int G, int S, int P, int N, int Q,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(N, Q);
  auto kernel = ssd_scan_kernel<T, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (P + kSlice - 1) / kSlice);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<T*>(y), static_cast<T*>(st), H,
      G, S, P, N, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* dt, const float* a,
                     const void* bmat, const void* cmat, void* y, void* st,
                     int B, int H, int G, int S, int P, int N, int Q,
                     cudaStream_t stream) {
  if (N <= 64)
    return launch<T, 4>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                        stream);
  if (N <= 128)
    return launch<T, 8>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                        stream);
  return launch<T, 16>(x, dt, a, bmat, cmat, y, st, B, H, G, S, P, N, Q,
                       stream);
}

}  // namespace

// x: (B, H, S, P); dt: (B, H, S) f32; a: (H,) f32; b, c: (B, G, S, N);
// y like x; st: (B, H, N, P).  All contiguous; x, b, c, y, st of one dtype
// (0 = float32, 1 = bfloat16).  H % G == 0, S % Q == 0, N <= 256,
// Q <= 1024 (checked by the Python wrapper).
extern "C" int ssd_scan(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y, void* st, int B,
                        int H, int G, int S, int P, int N, int Q, int dtype,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(x, dtf, af, b, c, y, st, B, H, G, S,
                                           P, N, Q, s)
                 : dispatch<float>(x, dtf, af, b, c, y, st, B, H, G, S, P, N,
                                   Q, s);
  return static_cast<int>(err);
}
