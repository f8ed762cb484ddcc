// Mamba2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan` / `_kernel` in
// src/repro/kernels/ssd_scan.py (pallas_call at :80).  Inputs: x (B,L,H,P),
// dt (B,L,H) f32, A (H,) f32, Bm and Cm (B,L,N) shared by all heads, D (H,).
// Per chunk of Q positions and head h, with a = dt * A and cum its running
// sum inside the chunk:
//   y[q]   = sum_{s<=q} (C[q].B[s]) exp(cum[q]-cum[s]) dt[s] x[s]
//            + exp(cum[q]) C[q].state_in + D x[q]
//   state <- state exp(cum[Q-1]) + sum_q exp(cum[Q-1]-cum[q]) dt[q] x[q] B[q]^T
// Outputs: y (B,L,H,P) in x's dtype, the final state (B,H,P,N) in f32.
//
// Design: the chunked decomposition of the Mamba2 paper (arXiv 2405.21060)
// in three launches, so that every (b, h, chunk) is a block of its own
// rather than one block walking all the chunks of a (b, h) as the TPU grid
// does (that gives B*H blocks: 192 at the model's B=8, 24 at B=1, on 132
// SMs):
//   1. chunk_state_kernel, grid (chunks, H, B): cum of the chunk (a warp
//      scan), written out, and the chunk's own (P,N) contribution to the
//      state at its end.
//   2. state_pass_kernel, grid (P*N/256, H, B): one thread per state
//      element walks the chunks in order, replacing each contribution by
//      the state entering that chunk, and writes the final state.
//   3. chunk_scan_kernel, grid (chunks * Q/64, H, B): 64 query rows of one
//      chunk and head.  The carried-state term, then the intra-chunk term
//      over 64-row key tiles up to the diagonal (tiles above it are
//      skipped), then D x.  The (Q,Q) matrix is never whole: at Q = 256 it
//      would take 256 KB in f32, above a block's 227 KB of shared memory;
//      one (64,64) tile of it lives in shared memory at a time.
// exp(cum[q]-cum[s]) above the diagonal overflows (cum reaches about -500
// across a 256-chunk in the model), so it is selected away, never
// multiplied by a 0/1 mask (inf * 0 = NaN).
// x, Bm and Cm are read through their strides (the model passes slices of
// its conv output, row stride d_inner + 2N); every sum is f32 on CUDA cores.
//
// What bounds it, at the model's shape (B=8, L=4096, H=24, P=64, N=128,
// Q=256, bf16 x/B/C, on an H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 with
// f32 sums, 67 TFLOP/s f32 without tensor cores): the bytes are x and y
// 100.7 MB each, dt 3.1 MB, B and C 8.4 MB each, the state 6.3 MB: about
// 228 MB, 68 us.  The least work is C.B^T's lower triangle once per
// (b, chunk), 1.08 GFLOP of bf16 x bf16 products (1.1 us at the bf16
// rate), and 37.9 GFLOP of products with an f32 operand: the intra-chunk
// term's lower triangle per head (12.9), the carried-state term over the
// 15 chunks whose incoming state is not zero (12.1) and each chunk's own
// state (12.9), 0.566 ms at the f32 rate.  So the function is bound by
// operations, at 0.567 ms, some eight times above the bytes bound.  The
// Pallas kernel computes about 103 GFLOP (full (Q,Q) tiles, C.B^T per
// head), this kernel about 74 GFLOP (C.B^T per head, lower-triangle tiles
// only).  A later redesign would move the three products onto the tensor
// cores (wgmma in bf16 with f32 sums, or TF32, at a tolerance that allows
// it), compute C.B^T once per (b, chunk) for all heads, and feed the tiles
// by TMA; it would then near the bytes bound.  This first kernel uses plain loads, 4x4 or 4x8
// register tiles per thread, and CUDA-core FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;       // query rows and key rows per tile (kernel 3)
constexpr int kStateRows = 32;  // chunk rows per step (kernel 1)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxQ = 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Inclusive running sum of v[0..Q) in place, by one warp: each lane sums a
// contiguous run, a shuffle scan adds the runs before it.
__device__ void warp_cumsum(float* v, int Q, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += v[i];
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const float before = incl - run;
  for (int i = lo; i < hi; ++i) v[i] += before;
}

// Kernel 1.  grid (n_chunks, H, B).  cum_out (B,H,n_chunks,Q);
// states (B,H,n_chunks,P,N) gets each chunk's own contribution.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_state_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    float* __restrict__ cum_out, float* __restrict__ states, int P, int N,
    int Q, int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
    int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl) {
  extern __shared__ float smem[];
  float* cum_s = smem;                  // (Q,)
  float* xw_s = cum_s + Q;              // (kStateRows, P)
  float* b_s = xw_s + kStateRows * P;   // (kStateRows, N)

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x, H = gridDim.y;
  const int tid = threadIdx.x;
  const int64_t l0 = (int64_t)c * Q;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* xb = x + b * x_sb + h * x_sh;
  const T* bb = Bm + b * b_sb;

  const float Ah = A[h];
  for (int q = tid; q < Q; q += kThreads) cum_s[q] = dtb[(l0 + q) * dt_sl] * Ah;
  __syncthreads();
  if (tid < 32) warp_cumsum(cum_s, Q, tid);
  __syncthreads();
  const int64_t bhc = ((int64_t)b * H + h) * n_chunks + c;
  for (int q = tid; q < Q; q += kThreads) cum_out[bhc * Q + q] = cum_s[q];
  const float cum_end = cum_s[Q - 1];

  // this thread's outputs: rows p = tr + 16 i, columns n = tc + 16 j
  const int tr = tid >> 4, tc = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < Q; q0 += kStateRows) {
    const int rows = min(kStateRows, Q - q0);
    __syncthreads();
    for (int i = tid; i < rows * P; i += kThreads) {
      const int r = i / P, p = i % P;
      const int64_t l = l0 + q0 + r;
      const float xdt = to_float(xb[l * x_sl + p]) * dtb[l * dt_sl];
      xw_s[i] = xdt * expf(cum_end - cum_s[q0 + r]);
    }
    for (int i = tid; i < rows * N; i += kThreads) {
      const int r = i / N, n = i % N;
      b_s[i] = to_float(bb[(l0 + q0 + r) * b_sl + n]);
    }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float xv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tr + 16 * i;
        xv[i] = p < P ? xw_s[r * P + p] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tc + 16 * j;
        bv[j] = n < N ? b_s[r * N + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += xv[i] * bv[j];
    }
  }

  float* st = states + bhc * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = tr + 16 * i, n = tc + 16 * j;
      if (p < P && n < N) st[p * N + n] = acc[i][j];
    }
}

// Kernel 2.  grid (ceil(P*N / kThreads), H, B).  Replaces each chunk's
// contribution in `states` by the state entering that chunk.
__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    const float* __restrict__ cum, float* __restrict__ states,
    float* __restrict__ final_state, int n_chunks, int Q, int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  if (e >= PN) return;
  const int64_t bh = (int64_t)b * H + h;
  float s = 0.f;
  // the loads of kAhead chunks go out together, before the dependent chain
  constexpr int kAhead = 8;
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float contrib[kAhead], decay[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t bhc = bh * n_chunks + c0 + k;
      if (c0 + k < n_chunks) {
        contrib[k] = states[bhc * PN + e];
        decay[k] = expf(cum[bhc * Q + Q - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < n_chunks) {
        states[(bh * n_chunks + c0 + k) * PN + e] = s;
        s = s * decay[k] + contrib[k];
      }
    }
  }
  final_state[bh * PN + e] = s;
}

// Kernel 3.  grid (n_chunks * n_qtiles, H, B).  y (B,L,H,P) contiguous.
template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads) chunk_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const TD* __restrict__ D, const float* __restrict__ cum,
    const float* __restrict__ states, T* __restrict__ y, int L, int P,
    int N, int Q, int n_qtiles, int64_t x_sb, int64_t x_sl, int64_t x_sh,
    int64_t dt_sb, int64_t dt_sl, int64_t dt_sh, int64_t b_sb,
    int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  const int NS = N + 1;              // padded rows: no bank conflicts
  constexpr int MS = kTile + 1;
  extern __shared__ float smem[];
  float* cum_s = smem;               // (Q,)
  float* c_s = cum_s + Q;            // (kTile, NS): C rows of this tile
  float* k_s = c_s + kTile * NS;     // (kTile, NS): the state (P rows) or B
  float* xw_s = k_s + kTile * NS;    // (kTile, P): dt x of a key tile
  float* m_s = xw_s + kTile * P;     // (kTile, MS): one tile of the (Q,Q) M

  const int c = blockIdx.x / n_qtiles, qt = blockIdx.x % n_qtiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x / n_qtiles, H = gridDim.y;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = qt * kTile;
  const int rows = min(kTile, Q - q0);
  const int64_t l0 = (int64_t)c * Q;
  const int64_t bhc = ((int64_t)b * H + h) * n_chunks + c;
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* bb = Bm + b * b_sb;
  const T* cb = Cm + b * c_sb;

  for (int q = tid; q < Q; q += kThreads) cum_s[q] = cum[bhc * Q + q];
  for (int i = tid; i < rows * N; i += kThreads) {
    const int r = i / N, n = i % N;
    c_s[r * NS + n] = to_float(cb[(l0 + q0 + r) * c_sl + n]);
  }
  const float* st = states + bhc * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    k_s[p * NS + n] = st[i];
  }
  __syncthreads();

  // this thread's outputs: rows q0 + tr + 16 i, columns p = tc + 16 j
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // carried state: exp(cum[q]) * (C[q] . state[p])
  for (int n = 0; n < N; ++n) {
    float cv[4], sv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = c_s[(tr + 16 * i) * NS + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) sv[j] = k_s[(tc + 16 * j) * NS + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ql = tr + 16 * i;
    const float e = ql < rows ? expf(cum_s[q0 + ql]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= e;
  }

  // intra-chunk: key tiles up to the diagonal
  const int s_end = q0 + rows;
  for (int s0 = 0; s0 < s_end; s0 += kTile) {
    const int sn = min(kTile, s_end - s0);
    __syncthreads();               // the previous tile's readers are done
    for (int i = tid; i < sn * N; i += kThreads) {
      const int r = i / N, n = i % N;
      k_s[r * NS + n] = to_float(bb[(l0 + s0 + r) * b_sl + n]);
    }
    for (int i = tid; i < sn * P; i += kThreads) {
      const int r = i / P, p = i % P;
      const int64_t l = l0 + s0 + r;
      xw_s[i] = to_float(xb[l * x_sl + p]) * dtb[l * dt_sl];
    }
    __syncthreads();
    // M[q, s] = (C[q] . B[s]) * exp(cum[q] - cum[s]) where s <= q, else 0
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c_s[(tr + 16 * i) * NS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = k_s[(tc + 16 * j) * NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = tr + 16 * i, sl = tc + 16 * j;
        const int q = q0 + ql, s = s0 + sl;
        const bool keep = ql < rows && sl < sn && s <= q;
        m_s[ql * MS + sl] =
            keep ? g[i][j] * expf(cum_s[q] - cum_s[s]) : 0.f;
      }
    __syncthreads();
    for (int sl = 0; sl < sn; ++sl) {
      float mv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mv[i] = m_s[(tr + 16 * i) * MS + sl];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tc + 16 * j;
        xv[j] = p < P ? xw_s[sl * P + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += mv[i] * xv[j];
    }
  }

  const float Dh = to_float(D[h]);
  T* yb = y + (l0 * H + h) * P + (int64_t)b * L * H * P;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ql = tr + 16 * i, p = tc + 16 * j;
      if (ql < rows && p < P) {
        const int q = q0 + ql;
        const float xv = to_float(xb[(l0 + q) * x_sl + p]);
        store(yb + (int64_t)q * H * P + p, acc[i][j] + Dh * xv);
      }
    }
}

template <typename T, typename TD>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const void* D, void* y, float* final_state,
           float* cum, float* states, int B, int L, int H, int P, int N,
           int Q, int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
           int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
           int64_t c_sb, int64_t c_sl, cudaStream_t st) {
  const int n_chunks = L / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);

  const size_t smem1 = (size_t)(Q + kStateRows * P + kStateRows * N) * 4;
  chunk_state_kernel<T><<<dim3(n_chunks, H, B), kThreads, smem1, st>>>(
      xt, dt, A, bt, cum, states, P, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl,
      dt_sh, b_sb, b_sl);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int PN = P * N;
  state_pass_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, B), kThreads,
                      0, st>>>(cum, states, final_state, n_chunks, Q, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int n_qtiles = (Q + kTile - 1) / kTile;
  const size_t smem3 =
      (size_t)(Q + 2 * kTile * (N + 1) + kTile * P + kTile * (kTile + 1)) * 4;
  if (smem3 > 48 * 1024) {
    e = cudaFuncSetAttribute(chunk_scan_kernel<T, TD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
    if (e != cudaSuccess) return (int)e;
  }
  chunk_scan_kernel<T, TD>
      <<<dim3(n_chunks * n_qtiles, H, B), kThreads, smem3, st>>>(
          xt, dt, bt, ct, static_cast<const TD*>(D), cum, states,
          static_cast<T*>(y), L, P, N, Q, n_qtiles, x_sb, x_sl, x_sh, dt_sb,
          dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for x, Bm, Cm and y (x_dtype) and for
// D (d_dtype).  x: (B,L,H,P) with strides (x_sb, x_sl, x_sh, 1); dt: (B,L,H)
// f32 with strides (dt_sb, dt_sl, dt_sh); A: (H,) f32; Bm, Cm: (B,L,N) with
// strides (sb, sl, 1); D: (H,).  y: contiguous (B,L,H,P); final_state:
// contiguous (B,H,P,N) f32; cum: f32 scratch (B,H,L/Q,Q); states: f32
// scratch (B,H,L/Q,P,N).  L % Q == 0, P <= 64, N <= 128, Q <= 1024.
// Returns cudaGetLastError() after the launches (0 on success).
int ssd_scan_launch(int x_dtype, int d_dtype, const void* x, const float* dt,
                    const float* A, const void* Bm, const void* Cm,
                    const void* D, void* y, float* final_state, float* cum,
                    float* states, int B, int L, int H, int P, int N, int Q,
                    int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                    int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
                    int64_t c_sb, int64_t c_sl, void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      L % Q != 0 || B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_ARGS                                                      \
  x, dt, A, Bm, Cm, D, y, final_state, cum, states, B, L, H, P, N, Q, x_sb, \
      x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl, st
  if (x_dtype == 0 && d_dtype == 0)
    return launch<float, float>(REPRO_SSD_ARGS);
  if (x_dtype == 0 && d_dtype == 1)
    return launch<float, __nv_bfloat16>(REPRO_SSD_ARGS);
  if (x_dtype == 1 && d_dtype == 0)
    return launch<__nv_bfloat16, float>(REPRO_SSD_ARGS);
  if (x_dtype == 1 && d_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(REPRO_SSD_ARGS);
#undef REPRO_SSD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
