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
//   1. cum of the chunk (a warp scan), written out, and the chunk's own
//      (P,N) contribution to the state at its end,
//      sum_q (x[q] exp(cum[Q-1]-cum[q]) dt[q]) B[q]^T.  Two instances,
//      chosen with those of launch 3, by the same rule:
//       * chunk_state_wgmma_kernel (bf16, the shapes of
//         chunk_scan_wgmma_kernel below), grid (chunks, H/G, B): a block
//         takes a group of G = 4 heads of one (b, chunk).  Its producer
//         warp loads the chunk's Bm rows by TMA once for all of them and
//         streams each head's x in 64-row pieces through a ring on
//         mbarriers; its consumer warpgroup computes cum and w = dt
//         exp(cum[Q-1]-cum) of the group, then per k16 step builds A =
//         (x o w)^T in registers (ldmatrix.trans of the swizzled x rows,
//         times w), splits it into bf16 hi and lo, and adds A_hi.Bm +
//         A_lo.Bm into acc (P rows, zero up to 64, by N), Bm MN-major: x
//         and Bm exact bf16 operands, the f32 product kept to about 16
//         significant bits.  Two blocks share an SM.
//       * chunk_state_kernel (f32, and every other bf16 shape), grid
//         (chunks, H, B): CUDA cores, 4x8 register tiles, f32 FMAs.
//   2. state_pass_kernel, grid (P*N/256, H, B): one thread per state
//      element walks the chunks in order, replacing each contribution by
//      the state entering that chunk, and writes the final state.
//   3. each chunk's output, grid (chunks * Q/64, H, B): 64 query rows of one
//      chunk and head.  The carried-state term, then the intra-chunk term
//      over 64-row key tiles up to the diagonal (tiles above it are
//      skipped), then D x.  The (Q,Q) matrix is never whole: one (64,64)
//      tile of it at a time.  Two instances, chosen by the wrapper from
//      shape and alignment before the launch:
//       * chunk_scan_wgmma_kernel (bf16 x, Bm, Cm; P in {16, 32, 64}, N in
//         {16, 32, 64, 128}, Q % 64 == 0, 16-byte aligned bases and
//         strides): one warpgroup per block.  C's 64 rows, and per key
//         tile B and x, arrive by TMA (4-D maps over the strided views,
//         the swizzle of their rows, B and x in a ring of two slots on
//         mbarriers).  The state entering the chunk is split in the block
//         into bf16 S_hi = bf16(S) and S_lo = bf16(S - S_hi), K-major, and
//         acc = C.S_hi^T + C.S_lo^T (wgmma m64nPk16, both operands K-major)
//         is scaled per row by exp(cum[q]) (chunk 0 has no incoming state
//         and skips it).  Per key tile G = C.B^T (wgmma m64n64k16), then in
//         registers W = (s <= q) ? G exp(cum[q]-cum[s]) dt[s] : 0, split
//         into hi and lo A fragments as flash attention splits p, and
//         acc += W_hi.x + W_lo.x (x MN-major, the transpose bit).  The
//         model passes every operand in bf16 but dt, the decays and the
//         state: C.B^T of exact bf16 values has no error, folding dt into W
//         keeps x exact, and hi + lo keeps W and the state to about 16
//         significant bits (chip_smoke.py's ssd_split_gate holds it there).
//       * chunk_scan_kernel (f32, and every other bf16 shape): CUDA cores,
//         plain loads, 4x4 register tiles, f32 FMAs.
// exp(cum[q]-cum[s]) above the diagonal overflows (cum reaches about -500
// across a 256-chunk in the model), so it is selected away, never
// multiplied by a 0/1 mask (inf * 0 = NaN).
// x, Bm and Cm are read through their strides (the model passes slices of
// its conv output, row stride d_inner + 2N); dt and A are f32.
//
// What bounds it, at the model's shape (B=8, L=4096, H=24, P=64, N=128,
// Q=256, bf16 x/B/C, on an H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 with
// f32 sums, 67 TFLOP/s f32 without tensor cores): the bytes are x and y
// 100.7 MB each, dt 3.1 MB, B and C 8.4 MB each, the state 6.3 MB: about
// 228 MB, 68 us.  The least work at this precision is C.B^T's lower
// triangle once per (b, chunk), 1.08 GFLOP of bf16 products, and the three
// products with an f32 operand, 37.9 GFLOP (the intra-chunk term's lower
// triangle per head 12.9, the carried-state term over the 15 chunks whose
// incoming state is not zero 12.1, each chunk's own state 12.9), each
// twice as bf16 hi + lo: 76.9 GFLOP, 78 us at the bf16 rate.  So the
// function is bound by operations, at 78 us, near its bytes.  (Counted at
// the f32 rate, as before the tensor-core instances, the products with an
// f32 operand would take 0.566 ms.)  The chunk states (B,H,n,P,N) f32,
// 100.7 MB, go through device memory between the launches: launch 1 alone
// moves 216 MB (x and the chunk states 100.7 MB each, Bm 8.4, dt and cum
// 3.1 each), 64.5 us, against 25.8 GFLOP of hi + lo products, 26 us: it is
// bound by bytes, so chunk_state_wgmma_kernel reads x once, Bm once for a
// group of heads, and writes the states in whole 32-byte sectors.
// chunk_scan_wgmma_kernel computes C.B^T per head and visits the
// diagonal tiles whole (10 of 16 tile pairs per (b, chunk, head) at
// Q = 256): about 90 GFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// a * v[0..Q) replaced by its inclusive running sum, by one warp, Q % 32 ==
// 0: lane l holds v[32 k + l] of eight rows k at a time (no two lanes on
// one bank), scans each row with shuffles and adds the totals of the rows
// before it.
__device__ void warp_cumsum_rows(float* v, float a, int Q, int lane) {
  float carry = 0.f;
  for (int k0 = 0; k0 < Q / 32; k0 += 8) {
    float r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      r[k] = k0 + k < Q / 32 ? v[32 * (k0 + k) + lane] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float t = __shfl_up_sync(0xffffffffu, r[k], o);
        if (lane >= o) r[k] += t;
      }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float total = __shfl_sync(0xffffffffu, r[k], 31);
      r[k] += carry;
      carry += total;
      if (k0 + k < Q / 32) v[32 * (k0 + k) + lane] = r[k];
    }
  }
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

// ---------------------------------------------------------------------------
// Kernel 3, bfloat16 on the tensor cores: chunk_scan_wgmma_kernel
// ---------------------------------------------------------------------------
namespace wg {

using hopper::Wgmma;

constexpr int kRows = 64;      // query rows of a block; keys of a key tile
constexpr int kWgThreads = 128;
constexpr int kStages = 2;     // key tiles (B and x) in flight

// bytes of a swizzled row for a width of n bf16 values (128 at most: a
// wider tile is stored as 128-byte column blocks)
__host__ __device__ constexpr int row_bytes(int n) {
  return n * 2 < 128 ? n * 2 : 128;
}
__host__ __device__ constexpr uint32_t align1024(uint32_t b) {
  return (b + 1023u) & ~1023u;
}

// Shared memory of one block: 1024 bytes of alignment slack; C's 64 query
// rows; the carried state's bf16 hi and lo (P rows, N contiguous); a ring
// of kStages slots of one B key tile and one x key tile; cum and dt of
// the chunk; the barriers.
template <int P, int N>
struct Smem {
  static constexpr uint32_t C = kRows * N * 2;
  static constexpr uint32_t S = align1024(P * N * 2);
  static constexpr uint32_t X = kRows * P * 2;
  static constexpr uint32_t SLOT = C + X;
  static __host__ __device__ constexpr size_t bytes(int Q) {
    return 1024 + C + 2 * S + kStages * SLOT + (size_t)8 * Q +
           8 * (1 + kStages);
  }
};

// v = hi + lo with hi = bf16(v), lo = bf16(v - hi), for two values
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// grid (n_chunks * Q/64, H, B); block 128 threads, one warpgroup.  Maps:
// x (P, L, H, B) in boxes of (P, 64); Bm and Cm (N, L, B, 1) in boxes of
// (row_bytes(N)/2, 64).  cum (B,H,n_chunks,Q) and states
// (B,H,n_chunks,P,N), the state entering each chunk, from kernels 1 and 2.
template <int P, int N>
__global__ void __launch_bounds__(kWgThreads) chunk_scan_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap,
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const void* __restrict__ D, int d_bf16, const float* __restrict__ cum,
    const float* __restrict__ states, __nv_bfloat16* __restrict__ y, int L,
    int Q, int n_qtiles, int64_t x_sb, int64_t x_sl, int64_t x_sh,
    int64_t dt_sb, int64_t dt_sl, int64_t dt_sh) {
  using SM = Smem<P, N>;
  constexpr int SWN = row_bytes(N), SWP = row_bytes(P);
  constexpr int SWZN = hopper::desc_swizzle(SWN);
  constexpr int SWZP = hopper::desc_swizzle(SWP);
  constexpr int NBN = N * 2 / SWN;         // 128-byte column blocks of N
  constexpr int KPA = SWN / 32;            // k16 steps in one column block
  constexpr uint32_t BOX_N = kRows * SWN;  // one box of C or B
  constexpr uint32_t S_BLOCK = P * SWN;    // one column block of the state

  extern __shared__ uint8_t smem_raw[];
  uint8_t* c_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* hi_s = c_s + SM::C;
  uint8_t* lo_s = hi_s + SM::S;
  uint8_t* ring = lo_s + SM::S;             // slot s: B, then x
  float* cum_s = reinterpret_cast<float*>(ring + kStages * SM::SLOT);
  float* dt_s = cum_s + Q;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(dt_s + Q);
  uint64_t* full = c_full + 1;

  const int c = blockIdx.x / n_qtiles;
  const int qt = n_qtiles - 1 - blockIdx.x % n_qtiles;  // most tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x / n_qtiles, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * kRows, n_kt = qt + 1;   // key tiles to the diagonal
  const int l0 = c * Q;
  const int64_t bhc = ((int64_t)b * H + h) * n_chunks + c;

  // key tile j of B and x into slot j % kStages
  const CUtensorMap* bm = &bmap;
  const CUtensorMap* xm = &xmap;
  auto load_tile = [=](int j) {
    uint8_t* bs = ring + (j % kStages) * SM::SLOT;
    uint64_t* bar = full + j % kStages;
    hopper::mbar_expect_tx(bar, SM::SLOT);
    for (int cb = 0; cb < NBN; ++cb)
      hopper::tma_load_4d(bs + cb * BOX_N, bm, bar, cb * (SWN / 2),
                          l0 + j * kRows, b, 0);
    hopper::tma_load_4d(bs + SM::C, xm, bar, 0, l0 + j * kRows, h, b);
  };
  if (tid == 0) {
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(full + s, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(c_full, SM::C);
    for (int cb = 0; cb < NBN; ++cb)
      hopper::tma_load_4d(c_s + cb * BOX_N, &cmap, c_full, cb * (SWN / 2),
                          l0 + q0, b, 0);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_tile(j);
  }

  for (int i = tid; i < Q; i += kWgThreads) cum_s[i] = cum[bhc * Q + i];
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  for (int i = tid; i < q0 + kRows; i += kWgThreads)
    dt_s[i] = dtb[(int64_t)(l0 + i) * dt_sl];
  // the state entering the chunk (zero in chunk 0), as bf16 hi and lo,
  // K-major in the swizzled layout of B's rows
  if (c > 0) {
    const float4* st = reinterpret_cast<const float4*>(states + bhc * P * N);
    for (int i = tid; i < P * N / 4; i += kWgThreads) {
      const float4 v = st[i];
      const int p = 4 * i / N, n = 4 * i % N;
      const uint32_t off = (n * 2 / SWN) * S_BLOCK +
                           hopper::swizzle(p * SWN + n * 2 % SWN, SWN);
      uint2 hi, lo;
      split2(v.x, v.y, hi.x, lo.x);
      split2(v.z, v.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(hi_s + off) = hi;
      *reinterpret_cast<uint2*>(lo_s + off) = lo;
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();

  // this thread holds rows r_in and r_in + 8 of the tile, columns
  // 8 j + cq and 8 j + cq + 1 of each 8
  const int r_in = warp * 16 + lane / 4;
  const int cq = (lane % 4) * 2;
  const uint32_t c_addr = hopper::smem_u32(c_s);
  auto c_desc = [&](int kk) {
    return hopper::make_desc(c_addr + (kk / KPA) * BOX_N + (kk % KPA) * 32,
                             16, 8 * SWN, SWZN);
  };
  const float cum_q[2] = {cum_s[q0 + r_in], cum_s[q0 + r_in + 8]};

  float acc[P / 2];
#pragma unroll
  for (int e = 0; e < P / 2; ++e) acc[e] = 0.f;
  hopper::mbar_wait(c_full, 0);

  // carried state: exp(cum[q]) * (C[q] . S_hi[p] + C[q] . S_lo[p])
  if (c > 0) {
    const uint32_t hi_addr = hopper::smem_u32(hi_s);
    const uint32_t lo_addr = hopper::smem_u32(lo_s);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t so = (kk / KPA) * S_BLOCK + (kk % KPA) * 32;
      Wgmma<P>::ss(acc, c_desc(kk),
                   hopper::make_desc(hi_addr + so, 16, 8 * SWN, SWZN), 1);
      Wgmma<P>::ss(acc, c_desc(kk),
                   hopper::make_desc(lo_addr + so, 16, 8 * SWN, SWZN), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    const float e[2] = {expf(cum_q[0]), expf(cum_q[1])};
#pragma unroll
    for (int i = 0; i < P / 2; ++i) acc[i] *= e[(i / 2) % 2];
  }

  // intra-chunk, per key tile up to the diagonal
  for (int j = 0; j < n_kt; ++j) {
    const uint32_t b_addr =
        hopper::smem_u32(ring + (j % kStages) * SM::SLOT);
    const uint32_t x_addr = b_addr + SM::C;
    hopper::mbar_wait(full + j % kStages, (j / kStages) & 1);

    // G = C . B^T, both K-major
    float g[kRows / 2];
    hopper::fence_regs(g);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      Wgmma<kRows>::ss(
          g, c_desc(kk),
          hopper::make_desc(b_addr + (kk / KPA) * BOX_N + (kk % KPA) * 32, 16,
                            8 * SWN, SWZN),
          kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(g);

    // W[q, s] = G exp(cum[q] - cum[s]) dt[s] where s <= q, else 0 (a
    // select: above the diagonal the exp overflows, and inf * 0 is NaN),
    // as bf16 hi and lo A fragments; keys [16 ks, 16 ks + 16) of the
    // tile are g[8 ks .. 8 ks + 8)
    const int s0 = j * kRows;
    uint32_t w_hi[kRows / 16][4], w_lo[kRows / 16][4];
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float w[2];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int e = 8 * ks + 2 * r + cc, i = r % 2;
          const int key = s0 + (e / 4) * 8 + cq + cc;
          const int q = q0 + r_in + 8 * i;
          w[cc] = key <= q
                      ? g[e] * expf(cum_q[i] - cum_s[key]) * dt_s[key]
                      : 0.f;
        }
        split2(w[0], w[1], w_hi[ks][r], w_lo[ks][r]);
      }

    // acc += W_hi . x + W_lo . x, x MN-major (P contiguous)
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      const uint64_t xd = hopper::make_desc(x_addr + ks * 16 * SWP,
                                            kRows * SWP, 8 * SWP, SWZP);
      Wgmma<P>::rs_tb(acc, w_hi[ks], xd);
      Wgmma<P>::rs_tb(acc, w_lo[ks], xd);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      hopper::fence_regs(w_hi[ks]);
      hopper::fence_regs(w_lo[ks]);
    }
    __syncthreads();      // every warp is done with the slot: refill it
    if (tid == 0 && j + kStages < n_kt) load_tile(j + kStages);
  }

  // y = acc + D[h] x[q], two columns at a time
  const float Dh = d_bf16 ? __bfloat162float(
                                static_cast<const __nv_bfloat16*>(D)[h])
                          : static_cast<const float*>(D)[h];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t l = l0 + q0 + r_in + 8 * i;
    const __nv_bfloat16* xr = x + b * x_sb + l * x_sl + h * x_sh;
    __nv_bfloat16* yr = y + (((int64_t)b * L + l) * H + h) * P;
#pragma unroll
    for (int cb = 0; cb < P / 8; ++cb) {
      const int p = cb * 8 + cq;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(xr + p));
      *reinterpret_cast<__nv_bfloat162*>(yr + p) =
          __floats2bfloat162_rn(acc[cb * 4 + 2 * i] + Dh * xv.x,
                                acc[cb * 4 + 2 * i + 1] + Dh * xv.y);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 1, bfloat16 on the tensor cores: chunk_state_wgmma_kernel
// ---------------------------------------------------------------------------
constexpr int kStateRing = 4;    // x pieces (64 rows of one head) in flight
// heads of one block: with 4, two blocks fit an SM (of 2, 3, 4, 6 and 8
// heads timed on an H100, 4 and 6 came out best and changed places between
// runs; at 8 one block fits)
constexpr int kStateGroup = 4;
static_assert(kStateGroup <= 32, "A of the group is loaded by one warp");
// the chunk's Bm rows stay in shared memory for all the block's heads; above
// this many bytes a block takes half of the N columns (N = 128, Q > 512)
constexpr size_t kStateBmBytes = 128 * 1024;

// Shared memory of one block: 1024 bytes of alignment slack; the chunk's
// Bm (Q rows of the block's NB columns, as 128-byte column blocks); a ring
// of kStateRing x pieces; dt (then w) and cum of the group's heads; A of
// the group (two floats for each head to keep 8-byte alignment);
// the barriers.
template <int P, int NB>
struct StateSmem {
  static constexpr uint32_t X = kRows * P * 2;
  static __host__ __device__ constexpr size_t bytes(int Q) {
    return 1024 + (size_t)Q * NB * 2 + kStateRing * X +
           (size_t)8 * kStateGroup * Q + 8 * kStateGroup +
           8 * (1 + 2 * kStateRing);
  }
};

constexpr int kStateThreads = kWgThreads + 32;   // consumers, producer warp
constexpr int kDtLoads = 8;    // dt loads of a consumer thread in flight

// grid (n_chunks, n_groups * n_slices, B); block 160 threads: one consumer
// warpgroup and a producer warp, for G = kStateGroup heads of one
// (b, chunk) and NB =
// N / n_slices columns of their states.  Maps: x (P, L, H, B) in boxes of
// (P, 64); Bm (N, L, B, 1) in boxes of (row_bytes(NB)/2, 64): the maps of
// kernel 3.  Writes cum (B,H,n_chunks,Q) and each chunk's own contribution
// to the state at its end, states (B,H,n_chunks,P,N) f32:
//   states[p, n] = sum_q (x[q, p] w[q]) Bm[q, n],
//   w[q] = dt[q] exp(cum[Q-1] - cum[q]),
// as acc (P rows, zero up to 64) x NB = sum over k16 steps of A . Bm with
// A = (x o w)^T built in registers from the x piece (ldmatrix.trans of its
// swizzled rows), split into bf16 hi and lo: two wgmmas per step, Bm the
// MN-major operand, the same descriptor for both.  x and Bm are exact bf16
// operands; only the f32 product x o w is split.  The producer warp loads
// the chunk's Bm once and streams the x pieces of the group's heads
// through the ring; a slot is free again as soon as every consumer warp
// holds its A fragments.
template <int P, int NB>
__global__ void __launch_bounds__(kStateThreads) chunk_state_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap, const float* __restrict__ dt,
    const float* __restrict__ A, float* __restrict__ cum_out,
    float* __restrict__ states, int H, int N, int Q, int n_slices,
    int64_t dt_sb, int64_t dt_sl, int64_t dt_sh) {
  using SM = StateSmem<P, NB>;
  constexpr int G = kStateGroup;
  constexpr int SWN = row_bytes(NB), SWP = row_bytes(P);
  constexpr int SWZN = hopper::desc_swizzle(SWN);
  constexpr int NBN = NB * 2 / SWN;        // 128-byte column blocks of Bm
  constexpr int kWarps = kWgThreads / 32;  // consumer warps

  extern __shared__ uint8_t smem_raw[];
  uint8_t* b_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = b_s + (size_t)Q * NB * 2;
  float* w_s = reinterpret_cast<float*>(ring + kStateRing * SM::X);  // (G,Q)
  float* cum_s = w_s + G * Q;                                        // (G,Q)
  float* a_s = cum_s + G * Q;                                        // (G,)
  uint64_t* b_full = reinterpret_cast<uint64_t*>(a_s + 2 * G);
  uint64_t* full = b_full + 1;
  uint64_t* empty = full + kStateRing;

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int h0 = blockIdx.y / n_slices * G, ns = blockIdx.y % n_slices;
  const int b = blockIdx.z;
  const int nh = min(G, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l0 = c * Q;
  const int n_pieces = Q / kRows, n_items = nh * n_pieces, n_dt = nh * Q;

  // dt of the group's heads, element i = (q = i / nh, head i % nh): dt's
  // rows hold the heads side by side.  The first kDtLoads of a consumer
  // thread go out before anything else.
  const float* dtb = dt + b * dt_sb + h0 * dt_sh;
  auto dt_at = [&](int i) {
    return dtb[(int64_t)(l0 + i / nh) * dt_sl + i % nh * dt_sh];
  };
  float dv[kDtLoads];
  if (warp < kWarps) {
#pragma unroll
    for (int u = 0; u < kDtLoads; ++u) {
      const int i = u * kWgThreads + tid;
      dv[u] = i < n_dt ? dt_at(i) : 0.f;
    }
  }
  if (warp == kWarps && lane < nh) a_s[lane] = A[h0 + lane];
  if (tid == kWgThreads) {
    hopper::prefetch_map(&xmap);
    hopper::prefetch_map(&bmap);
    hopper::mbar_init(b_full, 1);
    for (int s = 0; s < kStateRing; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The producer: Bm once, then item i (rows [64 (i % n_pieces), +64) of
  // the chunk for head i / n_pieces) into slot i % kStateRing once the
  // consumers have taken item i - kStateRing from it.
  if (warp == kWarps) {
    if (lane == 0) {
      hopper::mbar_expect_tx(b_full, (uint32_t)Q * NB * 2);
      for (int cb = 0; cb < NBN; ++cb)
        for (int j = 0; j < n_pieces; ++j)
          hopper::tma_load_4d(b_s + ((size_t)cb * Q + j * kRows) * SWN,
                              &bmap, b_full, ns * NB + cb * (SWN / 2),
                              l0 + j * kRows, b, 0);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % kStateRing;
        if (i >= kStateRing)
          hopper::mbar_wait(empty + s, (i / kStateRing - 1) & 1);
        hopper::mbar_expect_tx(full + s, SM::X);
        hopper::tma_load_4d(ring + s * SM::X, &xmap, full + s, 0,
                            l0 + (i % n_pieces) * kRows, h0 + i / n_pieces,
                            b);
      }
    }
    return;
  }

  // cum of each head (a warp scan), then w = dt exp(cum[Q-1] - cum) in
  // place of dt
#pragma unroll
  for (int u = 0; u < kDtLoads; ++u) {
    const int i = u * kWgThreads + tid;
    if (i < n_dt) w_s[i % nh * Q + i / nh] = cum_s[i % nh * Q + i / nh] = dv[u];
  }
  for (int i = kDtLoads * kWgThreads + tid; i < n_dt; i += kWgThreads)
    w_s[i % nh * Q + i / nh] = cum_s[i % nh * Q + i / nh] = dt_at(i);
  hopper::named_sync<1, kWgThreads>();
  for (int g = warp; g < nh; g += kWarps)
    warp_cumsum_rows(cum_s + g * Q, a_s[g], Q, lane);
  hopper::named_sync<1, kWgThreads>();
  for (int g = 0; g < nh; ++g) {
    const float end = cum_s[g * Q + Q - 1];
    for (int q = tid; q < Q; q += kWgThreads)
      w_s[g * Q + q] *= expf(end - cum_s[g * Q + q]);
  }
  hopper::named_sync<1, kWgThreads>();

  // A fragments: warp w holds rows p in [16 w, 16 w + 16) (zero at p >= P);
  // ldmatrix matrix m = lane / 8 is rows k + 8 (m / 2) of the step and
  // columns p + 8 (m % 2) of the piece
  const bool live = warp * 16 < P;
  const int m = lane / 8;
  const uint32_t row_off = ((m / 2) * 8 + lane % 8) * SWP;
  const uint32_t col_off = (warp * 16 + (m % 2) * 8) * 2;
  const int kq = 2 * (lane % 4);
  const uint32_t b_addr = hopper::smem_u32(b_s);
  const uint32_t ring_addr = hopper::smem_u32(ring);
  const int r_in = warp * 16 + lane / 4;   // acc rows r_in, r_in + 8

  hopper::mbar_wait(b_full, 0);
  for (int g = 0; g < nh; ++g) {
    const float* w = w_s + g * Q;
    float acc[NB / 2];
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[e] = 0.f;
    for (int j = 0; j < n_pieces; ++j) {
      const int i = g * n_pieces + j, s = i % kStateRing;
      hopper::mbar_wait(full + s, (i / kStateRing) & 1);
      const uint32_t x_addr = ring_addr + s * SM::X;

      // A = (x o w)^T for the piece's four k16 steps, as hi and lo
      uint32_t a_hi[kRows / 16][4], a_lo[kRows / 16][4];
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        if (!live) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a_hi[ks][r] = a_lo[ks][r] = 0u;
          continue;
        }
        uint32_t xr[4];
        hopper::ldmatrix_x4_trans(
            x_addr + hopper::swizzle(ks * 16 * SWP + row_off + col_off, SWP),
            xr);
        const int k = j * kRows + ks * 16 + kq;
        const float2 wk[2] = {*reinterpret_cast<const float2*>(w + k),
                              *reinterpret_cast<const float2*>(w + k + 8)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv =
              __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&xr[r]));
          split2(xv.x * wk[r / 2].x, xv.y * wk[r / 2].y, a_hi[ks][r],
                 a_lo[ks][r]);
        }
      }
      __syncwarp();       // the warp's ldmatrix reads are done: free the slot
      if (lane == 0) hopper::mbar_arrive(empty + s);

      // acc += A_hi . Bm + A_lo . Bm, Bm MN-major (N contiguous)
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        const uint64_t bd =
            hopper::make_desc(b_addr + (j * kRows + ks * 16) * SWN, Q * SWN,
                              8 * SWN, SWZN);
        Wgmma<NB>::rs_tb(acc, a_hi[ks], bd);
        Wgmma<NB>::rs_tb(acc, a_lo[ks], bd);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < kRows / 16; ++ks) {
        hopper::fence_regs(a_hi[ks]);
        hopper::fence_regs(a_lo[ks]);
      }
    }

    // rows r_in and r_in + 8, columns 8 jj + kq and + 1: 8-byte stores, a
    // warp's 32-byte row segments whole sectors
    float* st = states +
                (((int64_t)b * H + h0 + g) * n_chunks + c) * P * N + ns * NB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = r_in + 8 * i;
      if (p >= P) continue;
#pragma unroll
      for (int jj = 0; jj < NB / 8; ++jj)
        *reinterpret_cast<float2*>(st + p * N + jj * 8 + kq) =
            make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
    }
  }

  // cum, written out by slice 0 once the products are done
  if (ns == 0)
    for (int i = tid; i < n_dt; i += kWgThreads)
      cum_out[(((int64_t)b * H + h0 + i / Q) * n_chunks + c) * Q + i % Q] =
          cum_s[i];
}

template <int P, int NB>
int launch_state(const CUtensorMap maps[3], const float* dt, const float* A,
                 float* cum, float* states, int B, int L, int H, int N, int Q,
                 int n_slices, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                 cudaStream_t st) {
  auto kernel = chunk_state_wgmma_kernel<P, NB>;
  const size_t smem = StateSmem<P, NB>::bytes(Q);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_groups = (H + kStateGroup - 1) / kStateGroup;
  if ((int64_t)n_groups * n_slices > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(L / Q, n_groups * n_slices, B), kStateThreads, smem, st>>>(
      maps[0], maps[1], dt, A, cum, states, H, N, Q, n_slices, dt_sb, dt_sl,
      dt_sh);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_state(int NB, const CUtensorMap maps[3], const float* dt,
                   const float* A, float* cum, float* states, int B, int L,
                   int H, int N, int Q, int n_slices, int64_t dt_sb,
                   int64_t dt_sl, int64_t dt_sh, cudaStream_t st) {
  switch (NB) {
#define REPRO_SSD_ST_N(NN)                                                  \
  case NN:                                                                  \
    return launch_state<P, NN>(maps, dt, A, cum, states, B, L, H, N, Q,     \
                               n_slices, dt_sb, dt_sl, dt_sh, st);
    REPRO_SSD_ST_N(16)
    REPRO_SSD_ST_N(32)
    REPRO_SSD_ST_N(64)
    REPRO_SSD_ST_N(128)
#undef REPRO_SSD_ST_N
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first launch for bf16 on the tensor cores.  The maps are make_maps'.
int chunk_state(const CUtensorMap maps[3], const float* dt, const float* A,
                float* cum, float* states, int B, int L, int H, int P, int N,
                int Q, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                cudaStream_t st) {
  const int n_slices = (size_t)Q * N * 2 <= kStateBmBytes ? 1 : 2;
  const int NB = N / n_slices;
#define REPRO_SSD_ST_ARGS                                                   \
  NB, maps, dt, A, cum, states, B, L, H, N, Q, n_slices, dt_sb, dt_sl, \
      dt_sh, st
  if (P == 16) return dispatch_state<16>(REPRO_SSD_ST_ARGS);
  if (P == 32) return dispatch_state<32>(REPRO_SSD_ST_ARGS);
  return dispatch_state<64>(REPRO_SSD_ST_ARGS);
#undef REPRO_SSD_ST_ARGS
}

template <int P, int N>
int launch_scan(const CUtensorMap maps[3], const void* x, const float* dt,
                const void* D, int d_bf16, const float* cum,
                const float* states, void* y, int B, int L, int H, int Q,
                int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                int64_t dt_sl, int64_t dt_sh, cudaStream_t st) {
  auto kernel = chunk_scan_wgmma_kernel<P, N>;
  const size_t smem = Smem<P, N>::bytes(Q);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = Q / kRows;
  kernel<<<dim3((L / Q) * n_qtiles, H, B), kWgThreads, smem, st>>>(
      maps[0], maps[1], maps[2], static_cast<const __nv_bfloat16*>(x), dt, D,
      d_bf16, cum, states, static_cast<__nv_bfloat16*>(y), L, Q, n_qtiles,
      x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_scan(int N, const CUtensorMap maps[3], const void* x,
                  const float* dt, const void* D, int d_bf16, const float* cum,
                  const float* states, void* y, int B, int L, int H, int Q,
                  int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                  int64_t dt_sl, int64_t dt_sh, cudaStream_t st) {
  switch (N) {
#define REPRO_SSD_WG_N(NN)                                                  \
  case NN:                                                                  \
    return launch_scan<P, NN>(maps, x, dt, D, d_bf16, cum, states, y, B, L, \
                              H, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,  \
                              st);
    REPRO_SSD_WG_N(16)
    REPRO_SSD_WG_N(32)
    REPRO_SSD_WG_N(64)
    REPRO_SSD_WG_N(128)
#undef REPRO_SSD_WG_N
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The third launch for bf16 on the tensor cores.  The maps are make_maps'.
int chunk_scan(const CUtensorMap maps[3], const void* x, const float* dt,
               const void* D, int d_bf16, const float* cum,
               const float* states, void* y, int B, int L, int H, int P,
               int N, int Q, int64_t x_sb, int64_t x_sl, int64_t x_sh,
               int64_t dt_sb, int64_t dt_sl, int64_t dt_sh, cudaStream_t st) {
#define REPRO_SSD_WG_ARGS                                                   \
  N, maps, x, dt, D, d_bf16, cum, states, y, B, L, H, Q, x_sb, x_sl, x_sh,  \
      dt_sb, dt_sl, dt_sh, st
  if (P == 16) return dispatch_scan<16>(REPRO_SSD_WG_ARGS);
  if (P == 32) return dispatch_scan<32>(REPRO_SSD_WG_ARGS);
  return dispatch_scan<64>(REPRO_SSD_WG_ARGS);
#undef REPRO_SSD_WG_ARGS
}

// The tensor-core instances take P in {16, 32, 64}, N in {16, 32, 64, 128},
// Q % 64 == 0, x, Bm and Cm at 16-byte aligned bases and strides (the
// wrapper decides this before any launch).  Their TMA maps: x (P, L, H, B)
// in boxes of (P, 64); Bm and Cm (N, L, B, 1) in boxes of
// (row_bytes(N)/2, 64).
int make_maps(CUtensorMap maps[3], const void* x, const void* Bm,
              const void* Cm, int B, int L, int H, int P, int N, int Q,
              int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t b_sb,
              int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  if (Q % kRows || (P != 16 && P != 32 && P != 64) ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return (int)cudaErrorInvalidValue;
  const int64_t xdims[4] = {P, L, H, B}, xs[3] = {x_sl, x_sh, x_sb};
  const int64_t ndims[4] = {N, L, B, 1};
  const int64_t bs[3] = {b_sl, b_sb, b_sb * B}, cs[3] = {c_sl, c_sb, c_sb * B};
  int rc = hopper::make_map_bf16_4d(&maps[0], x, xdims, xs, P, kRows);
  if (!rc) rc = hopper::make_map_bf16_4d(&maps[1], Bm, ndims, bs,
                                         row_bytes(N) / 2, kRows);
  if (!rc) rc = hopper::make_map_bf16_4d(&maps[2], Cm, ndims, cs,
                                         row_bytes(N) / 2, kRows);
  return rc;
}

}  // namespace wg

template <typename T, typename TD>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const void* D, void* y, float* final_state,
           float* cum, float* states, int B, int L, int H, int P, int N,
           int Q, int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
           int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
           int64_t c_sb, int64_t c_sl, int tensor_core, cudaStream_t st) {
  const int n_chunks = L / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  cudaError_t e;

  CUtensorMap maps[3];
  if (tensor_core) {
    if (sizeof(T) != 2) return (int)cudaErrorInvalidValue;
    int rc = wg::make_maps(maps, x, Bm, Cm, B, L, H, P, N, Q, x_sb, x_sl,
                           x_sh, b_sb, b_sl, c_sb, c_sl);
    if (!rc)
      rc = wg::chunk_state(maps, dt, A, cum, states, B, L, H, P, N, Q, dt_sb,
                           dt_sl, dt_sh, st);
    if (rc) return rc;
  } else {
    const size_t smem1 = (size_t)(Q + kStateRows * P + kStateRows * N) * 4;
    chunk_state_kernel<T><<<dim3(n_chunks, H, B), kThreads, smem1, st>>>(
        xt, dt, A, bt, cum, states, P, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl,
        dt_sh, b_sb, b_sl);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }

  const int PN = P * N;
  state_pass_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, B), kThreads,
                      0, st>>>(cum, states, final_state, n_chunks, Q, PN);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  if (tensor_core)
    return wg::chunk_scan(maps, x, dt, D, sizeof(TD) == 2, cum, states, y, B,
                          L, H, P, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl,
                          dt_sh, st);
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
// tensor_core = 1 runs the first launch as chunk_state_wgmma_kernel and the
// third as chunk_scan_wgmma_kernel (bf16 only, at the shapes wg::make_maps
// names), 0 as chunk_state_kernel and chunk_scan_kernel.
// Returns cudaGetLastError() after the launches (0 on success), or 10000 +
// the CUresult of cuTensorMapEncodeTiled where a TMA tensor map cannot be
// encoded.
int ssd_scan_launch(int x_dtype, int d_dtype, const void* x, const float* dt,
                    const float* A, const void* Bm, const void* Cm,
                    const void* D, void* y, float* final_state, float* cum,
                    float* states, int B, int L, int H, int P, int N, int Q,
                    int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                    int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
                    int64_t c_sb, int64_t c_sl, int tensor_core,
                    void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      L % Q != 0 || B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_ARGS                                                      \
  x, dt, A, Bm, Cm, D, y, final_state, cum, states, B, L, H, P, N, Q, x_sb, \
      x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl, tensor_core, \
      st
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
