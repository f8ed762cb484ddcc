// Flash-decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_attention` / `_kernel` in
// src/repro/kernels/decode_attention.py (pallas_call at :76): one query
// token per sequence attends to its KV cache at positions < length[b],
// with an f32 online softmax; GQA folds G = Hq / Hkv query heads onto
// each KV head.
//
// What bounds it: the bytes of K and V read.  Each step reads
// 2 * sum_b min(length[b], S) * Hkv * D elements of cache and does only
// ~4 flops per element (G = 1 on the main path), far below the H100's
// ~295 flops/byte balance point, so the least time is bytes / 3.35 TB/s.
//
// What the design does about it:
//  * Reads stop at length[b]: positions past it are never loaded (the TPU
//    kernel loads every block and masks).  length == 0 keeps the
//    reference's meaning, the mean of v over all S (every score is the
//    finite -1e30, so the softmax is uniform); that case alone reads all S.
//  * K and V are read once per (b, kv head), shared by the G query heads,
//    through shared-memory tiles loaded by all threads with neighbouring
//    threads on neighbouring addresses.
//  * The cache is read through strides, so the model's (B, S, Hkv, D)
//    layout is taken as it is: no transpose, no copy.
//  * The KV sequence is cut into `n_split` chunks, one block each, so
//    that small batches still fill the 132 SMs; a second kernel combines
//    the partial (max, sum, acc) triples by log-sum-exp.  With one split
//    the first kernel writes the output itself.  The wrapper picks the
//    chunk from the SM count, or takes the reference's block size `bk`
//    as the chunk when the caller gives one (the kernel search domain).
//  * Head dims 16, 32, 64, 80, 112, 128 and 256 have instances (80 and 112
//    for hubert-xlarge and zamba2-7b); a thread strides over D, so any
//    multiple of 16 would do.
//  * The ragged last tile is masked here, so S need not be a multiple of
//    the tile (the Pallas wrapper asserts S % bk == 0).
//
// Semantics kept from the reference: NEG_INF is the finite -1e30; the
// output is acc / max(l, 1e-30), in q's dtype; accumulation is f32.
//
// A simple kernel: plain loads and CUDA-core FMAs.  wgmma/TMA come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Tile {
  // keys per shared-memory tile: 8192 floats (32 KB), at most 128 keys
  static constexpr int kKeys = (8192 / D) < 128 ? (8192 / D) : 128;
};

__host__ __device__ inline size_t smem_floats(int D, int keys, int G) {
  // q, acc: G*D each; one K-or-V tile: keys*D; scores: G*keys; m, l, alpha
  return (size_t)2 * G * D + (size_t)keys * D + (size_t)G * keys + 3 * G;
}

// grid (n_split, Hkv, B); block kThreads.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ length,
    T* __restrict__ out, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_acc, int S,
    int G, int chunk, int64_t q_sb, int64_t q_sh, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    float scale) {
  constexpr int TK = Tile<D>::kKeys;
  extern __shared__ float smem[];
  float* q_s = smem;              // (G, D)
  float* acc_s = q_s + G * D;     // (G, D)
  float* kv_s = acc_s + G * D;    // (TK, D)
  float* p_s = kv_s + TK * D;     // (G, TK)
  float* m_s = p_s + G * TK;      // (G,)
  float* l_s = m_s + G;           // (G,)
  float* a_s = l_s + G;           // (G,)

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int len = length[b];
  const bool uniform = len <= 0;          // reference: mean of v over all S
  const int n = uniform ? S : min(len, S);
  const int start = split * chunk;
  const int stop = min(n, start + chunk);

  const T* qb = q + b * q_sb + (int64_t)h * G * q_sh;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[i] = to_float(qb[g * q_sh + d]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int s0 = start; s0 < stop; s0 += TK) {
    const int tn = min(TK, stop - s0);
    for (int i = tid; i < tn * D; i += kThreads) {
      const int t = i / D, d = i % D;
      kv_s[i] = to_float(kb[(int64_t)(s0 + t) * k_ss + d]);
    }
    __syncthreads();
    // scores: one warp per (g, t), lanes split D
    for (int pr = warp; pr < G * tn; pr += kWarps) {
      const int g = pr / tn, t = pr % tn;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += q_s[g * D + d] * kv_s[t * D + d];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) p_s[g * TK + t] = uniform ? kNegInf : dot * scale;
    }
    __syncthreads();
    // V tile into the same buffer, while one warp per g updates its softmax
    for (int i = tid; i < tn * D; i += kThreads) {
      const int t = i / D, d = i % D;
      kv_s[i] = to_float(vb[(int64_t)(s0 + t) * v_ss + d]);
    }
    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * TK;
      float mx = kNegInf;
      for (int t = lane; t < tn; t += 32) mx = fmaxf(mx, pg[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tn; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = p_s + g * TK;
      float a = acc_s[i] * a_s[g];
      for (int t = 0; t < tn; ++t) a += pg[t] * kv_s[t * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  const int64_t row = ((int64_t)b * Hkv + h) * G;      // first (b, h, g) row
  if (n_split == 1) {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      store(out + row * D + i, acc_s[i] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  const int64_t prow = (((int64_t)b * Hkv + h) * n_split + split) * G;
  for (int g = tid; g < G; g += kThreads) {
    part_m[prow + g] = m_s[g];
    part_l[prow + g] = l_s[g];
  }
  for (int i = tid; i < G * D; i += kThreads) part_acc[prow * D + i] = acc_s[i];
}

// grid (Hkv, B); block kThreads.  Log-sum-exp combine of the splits.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ out, int G,
    int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int64_t bh = (int64_t)b * Hkv + h;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s)
      M = fmaxf(M, part_m[(bh * n_split + s) * G + g]);
    float L = 0.f, O = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const int64_t r = (bh * n_split + s) * G + g;
      const float w = expf(part_m[r] - M);
      L += part_l[r] * w;
      O += part_acc[r * D + d] * w;
    }
    store(out + (bh * G + g) * D + d, O / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* out, float* part_m, float* part_l, float* part_acc, int B,
           int Hkv, int G, int S, int chunk, int n_split, int64_t q_sb,
           int64_t q_sh, int64_t k_sb, int64_t k_sh, int64_t k_ss,
           int64_t v_sb, int64_t v_sh, int64_t v_ss, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(D, Tile<D>::kKeys, G) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_split_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(n_split, Hkv, B);
  decode_split_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(out), part_m, part_l,
      part_acc, S, G, chunk, q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return (int)e;
  decode_combine_kernel<T, D><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(out), G, n_split);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* length, void* out, float* part_m, float* part_l,
               float* part_acc, int B, int Hkv, int G, int S, int chunk,
               int n_split, int64_t q_sb, int64_t q_sh, int64_t k_sb,
               int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
               int64_t v_ss, float scale, cudaStream_t st) {
#define REPRO_DECODE_CASE(DD)                                               \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, length, out, part_m, part_l, part_acc, B, \
                         Hkv, G, S, chunk, n_split, q_sb, q_sh, k_sb, k_sh, \
                         k_ss, v_sb, v_sh, v_ss, scale, st);
  switch (D) {
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(80)
    REPRO_DECODE_CASE(112)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_CASE
}

}  // namespace

extern "C" {

// Keys per shared-memory tile for head dim D, or 0 for an unsupported D.
int decode_attention_tile_keys(int D) {
  switch (D) {
    case 16: return Tile<16>::kKeys;
    case 32: return Tile<32>::kKeys;
    case 64: return Tile<64>::kKeys;
    case 80: return Tile<80>::kKeys;
    case 112: return Tile<112>::kKeys;
    case 128: return Tile<128>::kKeys;
    case 256: return Tile<256>::kKeys;
    default: return 0;
  }
}

// Bytes of dynamic shared memory one split block takes.
long long decode_attention_smem_bytes(int D, int G) {
  const int keys = decode_attention_tile_keys(D);
  return keys ? (long long)(smem_floats(D, keys, G) * sizeof(float)) : -1;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q: (B, Hkv*G, D) with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, D) with
// strides (sb, sh, ss, 1); out: contiguous (B, Hkv*G, D); length: (B,)
// int32; part_*: f32 scratch for n_split > 1, shaped (B, Hkv, n_split, G)
// and (B, Hkv, n_split, G, D).  Returns cudaGetLastError() after the
// launches (0 on success).
int decode_attention_launch(int dtype, int D, const void* q, const void* k,
                            const void* v, const int* length, void* out,
                            float* part_m, float* part_l, float* part_acc,
                            int B, int Hkv, int G, int S, int chunk,
                            int n_split, int64_t q_sb, int64_t q_sh,
                            int64_t k_sb, int64_t k_sh, int64_t k_ss,
                            int64_t v_sb, int64_t v_sh, int64_t v_ss,
                            float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, length, out, part_m, part_l,
                             part_acc, B, Hkv, G, S, chunk, n_split, q_sb,
                             q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, scale,
                             st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, length, out, part_m, part_l,
                                     part_acc, B, Hkv, G, S, chunk, n_split,
                                     q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh,
                                     v_ss, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
