// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :93): q attends to
// k and v with an f32 online softmax over KV tiles of `bk` keys, one
// q tile of `bq` rows at a time; GQA maps query head h to KV head h / G.
//
// What bounds it: the operations.  At a prefill shape (S = 4096, D = 128)
// each (q, k) pair that the mask keeps costs 2D flops for q.k and 2D for
// p.v against a few bytes of q, k, v and o per row, so the work is far
// above the H100's balance point.  The reference keeps p in f32 for p.v,
// so that product's least time is at the f32 rate (67 TFLOP/s); q.k of
// bf16 inputs with f32 sums could run at the bf16 tensor-core rate.
//
// What this first design does about it (a simple kernel that is right;
// tensor cores, wgmma and TMA are for a later one):
//  * One block per (b, h, q tile); 256 threads as a 16 x 16 grid, each
//    holding a register tile of 2 or 4 query rows (the block walks its
//    q tile in passes of 32 or 64 rows) by D/16 output columns and by
//    4 score columns: f32 FMAs on CUDA cores, operands from shared
//    memory with rows padded to an odd stride, so no bank conflicts.
//  * KV tiles that the causal or window mask removes entirely are not
//    visited (the Pallas kernel computes them).  Skipping is exact: such
//    a tile leaves (m, l, acc) unchanged in the reference.  The one case
//    where it would not is a row whose every key is masked (Sq > Sk with
//    a window): the reference then returns the mean of v over all Sk,
//    because the finite -1e30 makes p = 1 everywhere.  A pass holding
//    such a row visits every tile, as the reference does.
//  * The softmax state is updated once per bk tile, as in the reference
//    (a tile wider than 256 keys is updated per 256-key piece); K and V
//    enter shared memory in sub-tiles of 64 keys, so every (bq, bk) of
//    the search domain fits a block's 227 KB (at most 133 KB, at D=128).
//  * q, k, v and o are read and written through strides with only the
//    last dimension contiguous: `mha` passes (B,S,H,D) tensors as views.
//  * The causal q tiles with the most keys are launched first.
//
// Semantics kept from the reference: scores are f32 dots times the scale;
// masked scores are the finite -1e30; p stays f32 for p.v (never
// rounded); the output is acc / max(l, 1e-30) in q's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPiece = 256;   // keys per softmax update at most
constexpr int kSubKeys = 64;     // keys per K or V sub-tile in shared memory

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ inline int piece_keys(int bk) {
  return bk < kMaxPiece ? bk : kMaxPiece;
}

// q rows per pass: 2 per thread row for bq <= 32, else 4
__host__ __device__ inline int rows_per_thread(int bq) { return bq <= 32 ? 2 : 4; }

__host__ __device__ inline size_t smem_floats(int D, int bq, int bk) {
  const size_t rows = 16 * rows_per_thread(bq), ld = D + 1;
  // q pass (rows, D+1); one K or V sub-tile (KT, D+1); scores of one
  // piece (rows, W+1); m, l, alpha per row
  return rows * ld + (size_t)kSubKeys * ld +
         rows * (piece_keys(bk) + 1) + 3 * rows;
}

// grid (Sq / bq, Hq, B); block kThreads.
template <typename T, int D, int RPT>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sk, int G, int bq,
    int bk, int causal, int window, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale) {
  constexpr int QR = 16 * RPT;          // q rows per pass
  constexpr int KT = kSubKeys;          // keys per K/V sub-tile
  constexpr int KPT = KT / 16;          // score columns per thread
  constexpr int DPT = D / 16;           // output columns per thread
  constexpr int LD = D + 1;
  const int W = piece_keys(bk);
  const int LP = W + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                    // (QR, LD)
  float* kv_s = q_s + QR * LD;          // (KT, LD)
  float* p_s = kv_s + KT * LD;          // (QR, LP)
  float* m_s = p_s + QR * LP;           // (QR,)
  float* l_s = m_s + QR;                // (QR,)
  float* a_s = l_s + QR;                // (QR,)

  const int qt = gridDim.x - 1 - blockIdx.x;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_kt = Sk / bk;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / G) * k_sh;
  const T* vb = v + b * v_sb + (h / G) * v_sh;
  T* ob = o + b * o_sb + h * o_sh;

  const int q_end = (qt + 1) * bq;
  for (int p0 = qt * bq; p0 < q_end; p0 += QR) {
    const int rows = min(QR, q_end - p0);
    const int last = p0 + rows - 1;
    // KV tiles [t_lo, t_hi) that hold a key some row of the pass keeps;
    // all of them if a row keeps no key at all (see the header)
    int t_lo = 0, t_hi = n_kt;
    const bool empty_row = window > 0 && last - window + 1 > Sk - 1;
    if (!empty_row) {
      if (window > 0) t_lo = max(0, p0 - window + 1) / bk;
      if (causal) t_hi = min(n_kt, last / bk + 1);
    }

    for (int i = tid; i < QR * D; i += kThreads) {
      const int r = i / D, d = i % D;
      q_s[r * LD + d] =
          r < rows ? to_float(qb[(int64_t)(p0 + r) * q_ss + d]) : 0.f;
    }
    for (int r = tid; r < QR; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
      a_s[r] = 1.f;
    }
    float acc[RPT][DPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
    __syncthreads();

    for (int t = t_lo; t < t_hi; ++t) {
      const int t_end = (t + 1) * bk;
      for (int c0 = t * bk; c0 < t_end; c0 += W) {
        const int cw = min(W, t_end - c0);
        // scores of the piece's keys [c0, c0 + cw) into p_s
        for (int s0 = 0; s0 < cw; s0 += KT) {
          const int sn = min(KT, cw - s0);
          for (int i = tid; i < KT * D; i += kThreads) {
            const int r = i / D, d = i % D;
            kv_s[r * LD + d] =
                r < sn ? to_float(kb[(int64_t)(c0 + s0 + r) * k_ss + d]) : 0.f;
          }
          __syncthreads();
          float s[RPT][KPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r)
#pragma unroll
            for (int c = 0; c < KPT; ++c) s[r][c] = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d) {
            float qv[RPT], kv[KPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) qv[r] = q_s[(ty * RPT + r) * LD + d];
#pragma unroll
            for (int c = 0; c < KPT; ++c) kv[c] = kv_s[(tx + 16 * c) * LD + d];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
              for (int c = 0; c < KPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          }
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            const int row = ty * RPT + r, qpos = p0 + row;
#pragma unroll
            for (int c = 0; c < KPT; ++c) {
              const int col = tx + 16 * c, kpos = c0 + s0 + col;
              if (col >= sn) continue;
              bool keep = true;
              if (causal) keep = kpos <= qpos;
              if (window) keep = keep && kpos > qpos - window;
              p_s[row * LP + s0 + col] = keep ? s[r][c] * scale : kNegInf;
            }
          }
          __syncthreads();
        }
        // online softmax over the piece, one warp per row
        for (int r = warp; r < rows; r += kWarps) {
          float* pr = p_s + r * LP;
          float mx = kNegInf;
          for (int c = lane; c < cw; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_old = m_s[r];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.f;
          for (int c = lane; c < cw; c += 32) {
            const float p = expf(pr[c] - m_new);
            pr[c] = p;
            sum += p;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          if (lane == 0) {
            const float alpha = expf(m_old - m_new);
            a_s[r] = alpha;
            l_s[r] = l_s[r] * alpha + sum;
            m_s[r] = m_new;
          }
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float alpha = a_s[ty * RPT + r];
#pragma unroll
          for (int c = 0; c < DPT; ++c) acc[r][c] *= alpha;
        }
        // acc += p . v over the piece's keys, V in sub-tiles
        for (int s0 = 0; s0 < cw; s0 += KT) {
          const int sn = min(KT, cw - s0);
          for (int i = tid; i < KT * D; i += kThreads) {
            const int r = i / D, d = i % D;
            kv_s[r * LD + d] =
                r < sn ? to_float(vb[(int64_t)(c0 + s0 + r) * v_ss + d]) : 0.f;
          }
          __syncthreads();
#pragma unroll 4
          for (int j = 0; j < sn; ++j) {
            float pv[RPT], vv[DPT];
#pragma unroll
            for (int r = 0; r < RPT; ++r) pv[r] = p_s[(ty * RPT + r) * LP + s0 + j];
#pragma unroll
            for (int c = 0; c < DPT; ++c) vv[c] = kv_s[j * LD + tx + 16 * c];
#pragma unroll
            for (int r = 0; r < RPT; ++r)
#pragma unroll
              for (int c = 0; c < DPT; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
          }
          __syncthreads();
        }
      }
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = ty * RPT + r;
      if (row >= rows) continue;
      const float l = fmaxf(l_s[row], 1e-30f);
      T* orow = ob + (int64_t)(p0 + row) * o_ss;
#pragma unroll
      for (int c = 0; c < DPT; ++c) store(orow + tx + 16 * c, acc[r][c] / l);
    }
    __syncthreads();   // the next pass rewrites q_s, m_s, l_s, a_s
  }
}

template <typename T, int D, int RPT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int G, int Sq, int Sk, int bq, int bk, int causal,
           int window, const int64_t* st, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats(D, bq, bk) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, RPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Sq / bq, Hq, B);
  flash_fwd_kernel<T, D, RPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sk, G, bq, bk, causal,
      window, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int G, int Sq, int Sk, int bq, int bk,
             int causal, int window, const int64_t* st, float scale,
             cudaStream_t stream) {
#define REPRO_FLASH_CASE(DD)                                                 \
  case DD:                                                                   \
    return rows_per_thread(bq) == 2                                          \
               ? launch<T, DD, 2>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk,      \
                                  causal, window, st, scale, stream)         \
               : launch<T, DD, 4>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk,      \
                                  causal, window, st, scale, stream);
  switch (D) {
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes, or -1 for an
// unsupported head dim.
long long flash_attention_smem_bytes(int D, int bq, int bk) {
  if (D != 32 && D != 64 && D != 128) return -1;
  return (long long)(smem_floats(D, bq, bk) * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).
// q: (B, Hq, Sq, D), k, v: (B, Hkv, Sk, D), o: (B, Hq, Sq, D), each with
// any strides whose last is 1; strides holds (sb, sh, ss) of q, k, v, o in
// that order.  Needs Hq = Hkv * G, Sq % bq == 0, Sk % bk == 0.  Returns
// cudaGetLastError() after the launch (0 on success).
int flash_attention_launch(int dtype, int D, const void* q, const void* k,
                           const void* v, void* o, int B, int Hq, int G,
                           int Sq, int Sk, int bq, int bk, int causal,
                           int window, const int64_t* strides, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                           window, strides, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Hq, G, Sq, Sk, bq, bk,
                                   causal, window, strides, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
