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
//   1. cum of the chunk, written out, and the chunk's own (P,N)
//      contribution to the state at its end,
//      sum_q (x[q] exp(cum[Q-1]-cum[q]) dt[q]) B[q]^T;
//   2. state_pass_kernel, grid (P*N/256, H, B): one thread per state
//      element walks the chunks in order, replacing each contribution by
//      the state entering that chunk, and writes the final state;
//   3. each chunk's output: the carried-state term, then the intra-chunk
//      term over 64-row key tiles up to the diagonal (tiles above it are
//      skipped), then D x.  The (Q,Q) matrix is never whole: one (64,64)
//      tile of it at a time.
// Launches 1 and 3 have three instances each, picked together by one rule
// before the launch (the wrapper's ssd_scan.instance_for, from dtype, shape
// and alignment; ssd_scan_launch's `instance`): at P in {16, 32, 64}, N in
// {16, 32, 64, 128}, Q a multiple of 64 and 16-byte aligned bases and
// strides of x, Bm and Cm (TMA reads them), bfloat16 runs the bf16
// tensor-core pair and float32 (also at Q = 32) the tf32 one; every other
// shape runs the CUDA-core pair.  exp(cum[q]-cum[s]) above the diagonal
// overflows (cum reaches about -500 across a 256-chunk in the model), so
// every instance selects it away, never multiplies by a 0/1 mask (inf * 0
// = NaN).  x, Bm and Cm are read through their strides (the model passes
// slices of its conv output, row stride d_inner + 2N).
//
// --- bfloat16: chunk_state_wgmma_kernel, chunk_scan_wgmma_kernel --------
//  * launch 1, grid (chunks, H/G, B): a block takes a group of G = 4 heads
//    of one (b, chunk).  Its producer warp loads the chunk's Bm rows by TMA
//    once for all of them and streams each head's x in 64-row pieces
//    through a ring on mbarriers; its consumer warpgroup computes cum and w
//    = dt exp(cum[Q-1]-cum) of the group, then per k16 step builds A = (x o
//    w)^T in registers (ldmatrix.trans of the swizzled x rows, times w),
//    splits it into bf16 hi and lo, and adds A_hi.Bm + A_lo.Bm into acc (P
//    rows, zero up to 64, by N), Bm MN-major: x and Bm exact bf16 operands,
//    the f32 product kept to about 16 significant bits.  Two blocks share
//    an SM.
//  * launch 3, one warpgroup per block.  C's 64 rows, and per key tile B
//    and x, arrive by TMA (4-D maps over the strided views, the swizzle of
//    their rows, B and x in a ring of two slots on mbarriers).  The state
//    entering the chunk is split in the block into bf16 S_hi = bf16(S) and
//    S_lo = bf16(S - S_hi), K-major, and acc = C.S_hi^T + C.S_lo^T (wgmma
//    m64nPk16, both operands K-major) is scaled per row by exp(cum[q])
//    (chunk 0 has no incoming state and skips it).  Per key tile G = C.B^T
//    (wgmma m64n64k16), then in registers W = (s <= q) ? G exp(cum[q]-cum[s])
//    dt[s] : 0, split into hi and lo A fragments as flash attention splits
//    p, and acc += W_hi.x + W_lo.x (x MN-major, the transpose bit).  The
//    model passes every operand in bf16 but dt, the decays and the state:
//    C.B^T of exact bf16 values has no error, folding dt into W keeps x
//    exact, and hi + lo keeps W and the state to about 16 significant bits
//    (chip_smoke.py's ssd_split_gate holds it there).
//
// --- float32: chunk_state_tf32_kernel, chunk_scan_tf32_kernel ------------
// Every product takes float32 operands, each as three tf32 products into
// f32 sums, big.big + big.small + small.big with big = tf32(v) and small =
// tf32(v - big), rounded as cvt.rna.tf32.f32 rounds but on the integer
// pipes (tf::split).  Each of the three is a chain of wgmmas into an
// accumulator of its own, added at the end (tf::tf32x3): a chain waits on
// itself, and the small terms summed apart lose little to the tensor
// cores' truncating sums (chip_smoke.py's 3xTF32 gate holds y and the
// states within 8e-7 of the exact function; one tf32 product and bf16 hi +
// lo miss it).  tf32 wgmma reads both operands K-major (hopper.cuh), and
// launch 1's reduction runs over the chunk's rows, along which x, Bm and
// Cm are strided; an A operand read from registers can take any layout.
// A producer warp loads every tile by TMA through a ring of slots on
// mbarriers (a small chunk is in flight whole) for the consumer warps.
//  * launch 1, grid (chunks, H/G x slices, B), the same group of G = 4
//    heads, two consumer warpgroups, each with a ring of its own (one ring
//    shared by both would let a warpgroup's parity wait pass on the other's
//    phase of the same slot): they compute cum and w while the
//    loads land, transpose the chunk's Bm once into Bm^T big and small
//    (K-major over the rows, 128-byte swizzle) for all the heads, then
//    each takes every other head and per 64-row piece builds A = (x o w)^T
//    in registers from the x tile and adds A.Bm^T into acc (P x NB), the
//    states going out in whole 32-byte sectors; two heads' products run
//    side by side, as one block fills an SM's shared memory.  Bm^T
//    takes Q NB 8 bytes, so N is cut into slices of NB <= 64 columns (two
//    at the model's N = 128, Q = 256), each block reading x again.  Turned
//    around (Bm^T from registers), the product would need x o w transposed
//    in shared memory for every head.
//  * launch 3, grid (chunks x Q/64, H, B), 64 queries of one (chunk, head),
//    computed transposed, y^T of P rows by the 64 queries:
//      y^T  = exp(cum[q]) (S . C^T)        S the state entering the chunk
//      G^T  = B . C^T                       per key tile up to the diagonal
//      W^T  = (s <= q) ? G^T exp(cum[q] - cum[s]) dt[s] : 0
//      y^T += x^T . W^T
//    S, B and x^T are A operands read from their TMA tiles into registers
//    and split there; only C (once) and W^T (per tile) are split into
//    shared memory as K-major B operands.  The untransposed order (W.x with
//    W from registers and x transposed in shared memory; C.B^T and C.S^T
//    with B and S split in shared memory) also holds B's and S's small
//    halves and x^T's two halves there: at P = 64, N = 128 a ring of two
//    key tiles would not fit 227 KB.  Here: C 64 KB, W^T 32 KB, y^T's sum 16
//    KB, two slots of one key tile's B and x, 48 KB each; one consumer
//    warpgroup.
//  * Q = 32 (a third of the kernel search's calls): one tile of 32 rows;
//    launch 1 takes only the chunk's k8 steps; launch 3 selects W^T to 0
//    for keys and queries past Q and writes no y there.
//
// --- CUDA cores: chunk_state_kernel, chunk_scan_kernel -------------------
// Every other shape, either dtype: launch 1 grid (chunks, H, B) with 4x8
// register tiles of f32 FMAs; launch 3 plain loads and 4x4 register tiles.
//
// What bounds it, at the model's shape (B=8, L=4096, H=24, P=64, N=128,
// Q=256, on an H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16 and 495 tf32 with f32
// sums, 67 TFLOP/s f32 without tensor cores).  The least work is C.B^T's
// lower triangle once per (b, chunk), 1.08 GFLOP, and the three products
// with an f32 operand, 37.9 GFLOP (the intra-chunk term's lower triangle
// per head 12.9, the carried-state term over the 15 chunks whose incoming
// state is not zero 12.1, each chunk's own state 12.9).
//  * bf16 x/B/C: the bytes are x and y 100.7 MB each, dt 3.1 MB, B and C
//    8.4 MB each, the state 6.3 MB: about 228 MB, 68 us; the products, the
//    three with an f32 operand twice as bf16 hi + lo, 76.9 GFLOP, 78 us at
//    the bf16 rate: bound by operations, near its bytes.  The chunk states
//    (B,H,n,P,N) f32, 100.7 MB, go through device memory between the
//    launches: launch 1 alone moves 216 MB (x and the chunk states 100.7 MB
//    each, Bm 8.4, dt and cum 3.1 each), 64.5 us, against 25.8 GFLOP of hi +
//    lo products, 26 us: it is bound by bytes, so chunk_state_wgmma_kernel
//    reads x once, Bm once for a group of heads, and writes the states in
//    whole 32-byte sectors.  chunk_scan_wgmma_kernel computes C.B^T per head
//    and visits the diagonal tiles whole (10 of 16 tile pairs per (b,
//    chunk, head) at Q = 256): about 90 GFLOP.
//  * float32: 446 MB, 133 us; every product three times as tf32, 116.9
//    GFLOP, 236 us at the tf32 rate: bound by operations.  Launch 1 moves
//    325 MB (97 us) against 38.7 GFLOP (78 us): bound by bytes, as in bf16;
//    launch 3 moves 543 MB (162 us) against 78.2 GFLOP (158 us).  (At the
//    f32 rate every product would take 0.58 ms.)

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

// dt of heads [h0, h0 + nh) over a chunk's rows from l0, element i = (q =
// i / nh, head i % nh): dt's rows hold the heads side by side
struct GroupDt {
  const float* dtb;      // dt at (b, row 0, head h0)
  int l0, nh;
  int64_t dt_sl, dt_sh;
  __device__ __forceinline__ float operator()(int i) const {
    return dtb[(int64_t)(l0 + i / nh) * dt_sl + i % nh * dt_sh];
  }
};

// The first kDtLoads loads of dt of consumer thread tid (of NT)
template <int NT = kWgThreads>
__device__ __forceinline__ void dt_prefetch(const GroupDt& dt_at, int tid,
                                            int Q, float (&dv)[kDtLoads]) {
  const int n_dt = dt_at.nh * Q;
#pragma unroll
  for (int u = 0; u < kDtLoads; ++u) {
    const int i = u * NT + tid;
    dv[u] = i < n_dt ? dt_at(i) : 0.f;
  }
}

// By the NT consumer threads (named barrier 1), from the prefetched dv and
// the rest of dt: cum of each head of the group (a warp scan) in cum_s
// (nh, Q), and w = dt exp(cum[Q-1] - cum) in w_s (nh, Q).  a_s: A of the
// group's heads.
template <int NT = kWgThreads>
__device__ __forceinline__ void group_decay(const GroupDt& dt_at,
                                            const float (&dv)[kDtLoads],
                                            const float* a_s, float* w_s,
                                            float* cum_s, int tid, int Q) {
  const int nh = dt_at.nh, n_dt = nh * Q, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int u = 0; u < kDtLoads; ++u) {
    const int i = u * NT + tid;
    if (i < n_dt) w_s[i % nh * Q + i / nh] = cum_s[i % nh * Q + i / nh] = dv[u];
  }
  for (int i = kDtLoads * NT + tid; i < n_dt; i += NT)
    w_s[i % nh * Q + i / nh] = cum_s[i % nh * Q + i / nh] = dt_at(i);
  hopper::named_sync<1, NT>();
  for (int g = warp; g < nh; g += NT / 32)
    warp_cumsum_rows(cum_s + g * Q, a_s[g], Q, lane);
  hopper::named_sync<1, NT>();
  for (int g = 0; g < nh; ++g) {
    const float end = cum_s[g * Q + Q - 1];
    for (int q = tid; q < Q; q += NT)
      w_s[g * Q + q] *= expf(end - cum_s[g * Q + q]);
  }
  hopper::named_sync<1, NT>();
}

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

  // dt of the group's heads; the first kDtLoads of a consumer thread go
  // out before anything else
  const GroupDt dt_at{dt + b * dt_sb + h0 * dt_sh, l0, nh, dt_sl, dt_sh};
  float dv[kDtLoads];
  if (warp < kWarps) dt_prefetch(dt_at, tid, Q, dv);
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

  group_decay(dt_at, dv, a_s, w_s, cum_s, tid, Q);

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

// ---------------------------------------------------------------------------
// Launches 1 and 3, float32 on the tensor cores: chunk_state_tf32_kernel and
// chunk_scan_tf32_kernel (the design is in the header)
// ---------------------------------------------------------------------------
namespace tf {

using hopper::WgmmaTf32;

constexpr int kRows = 64;              // wgmma's M; the rows of a tile
constexpr int kConsumers = 128;        // one warpgroup
constexpr int kThreads = kConsumers + 32;   // and a producer warp
// launch 1: two consumer warpgroups (the group's heads shared between
// them) and a producer warp
constexpr int kStateConsumers = 2 * kConsumers;
constexpr int kStateThreads = kStateConsumers + 32;
constexpr size_t kMaxSmem = 232448;    // bytes a block can use
constexpr int kBatch = 2;              // k8 steps of one commit group
constexpr int kStateStages = 3;        // slots of each ring of launch 1
constexpr int kScanStages = 4;         // ring slots of launch 3, at most

// x = big + small to about 21 bits: big = tf32(x), small = tf32(x - big),
// each rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds
// (hopper::split_tf32), but on the integer pipes: adding half of the 13
// dropped bits to the bits of |x| carries into the kept ones exactly when
// the dropped part is at least half (ties away), and an exponent carry is
// the next binade.  The conversion instruction runs at a fraction of
// their rate, and every float operand passes here.
__device__ __forceinline__ uint32_t tf32_round(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32_round(x);
  small = tf32_round(x - __uint_as_float(big));
}

// bytes of a swizzled row of n floats (128 at most: a wider tile is
// stored as column blocks of 128-byte rows)
__host__ __device__ constexpr int row_bytes(int n) {
  return n * 4 < 128 ? n * 4 : 128;
}

// the float at (row, col) of a tile as TMA writes it: column blocks of
// kRows rows of SW bytes, each swizzled
template <int SW>
__device__ __forceinline__ float at(const uint8_t* t, int row, int col) {
  const uint32_t c = col * 4;
  return *reinterpret_cast<const float*>(
      t + (c / SW) * (kRows * SW) + hopper::swizzle(row * SW + c % SW, SW));
}

// This thread's A fragment of k8 step ks (see tf32x3) from a TMA tile:
// column blocks of kRows rows of SW bytes, each swizzled.  The swizzle
// XORs a row's 16-byte pieces with bits of the row, so each thread's
// offsets are formed once and a step adds a constant.
// RowFrag: A[m][k] = t[m][k], the tile's rows are A's (the state, B).
template <int SW>
struct RowFrag {
  uint32_t row0, sw;    // row r at column 4 kq; the swizzle of rows r, r + 8
  __device__ RowFrag(int r, int kq)
      : row0(r * SW + 4 * kq), sw((((r * SW) >> 7) & (SW / 16 - 1)) << 4) {}
  __device__ __forceinline__ void operator()(const uint8_t* t, int ks,
                                             float (&v)[4]) const {
    const uint8_t* p = t + ks * 32 / SW * (kRows * SW) + row0;
    const uint32_t c0 = (ks * 32 % SW) ^ sw, c1 = c0 ^ 16;
    v[0] = *reinterpret_cast<const float*>(p + c0);
    v[1] = *reinterpret_cast<const float*>(p + 8 * SW + c0);
    v[2] = *reinterpret_cast<const float*>(p + c1);
    v[3] = *reinterpret_cast<const float*>(p + 8 * SW + c1);
  }
};
// ColFrag: A[m][k] = t[k][m], the tile's rows are A's columns (x); step ks
// is 8 rows on
template <int SW>
struct ColFrag {
  uint32_t off[4];      // (m, k) = (r, kq), (r + 8, kq), (r, kq + 4), (r + 8, kq + 4)
  __device__ ColFrag(int r, int kq) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t c = 4 * (r + 8 * (e % 2)), k = kq + 4 * (e / 2);
      off[e] = c / SW * (kRows * SW) + k * SW +
               ((c % SW) ^ ((((k * SW) >> 7) & (SW / 16 - 1)) << 4));
    }
  }
  __device__ __forceinline__ void operator()(const uint8_t* t, int ks,
                                             float (&v)[4]) const {
    const uint8_t* p = t + ks * 8 * SW;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = *reinterpret_cast<const float*>(p + off[e]);
  }
};

// The first 1024-byte aligned byte of the block's dynamic shared memory,
// found by pointer arithmetic on the shared array itself (not through an
// integer), so that the compiler knows every pointer derived from it
// addresses shared memory and emits shared loads and stores, not generic
// ones.
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024u - (hopper::smem_u32(raw) & 1023u)) & 1023u);
}

// x, opaque to the compiler: what is derived from it is formed where it is
// used instead of being hoisted out of the loops and held in registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}
// expf(x), computed where it stands: the compiler may not move it under
// the branch of a select that uses it (a branch per element serialises
// the elements, where straight-line code interleaves them)
__device__ __forceinline__ float exp_here(float x) {
  float e = expf(x);
  asm volatile("" : "+f"(e));
  return e;
}

// The K-major descriptor of k8 step ks of a tile of SW-byte rows stored as
// column blocks of `rows` rows from addr
template <int SW>
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, int ks, int rows) {
  return hopper::make_desc(
      opaque(addr) + (ks * 32 / SW) * (uint32_t)(rows * SW) + ks * 32 % SW,
      16, 8 * SW, hopper::desc_swizzle(SW));
}

// d = sum over k8 steps ks < n of A_ks . B_ks (at most KS steps), as three
// tf32 products, each a chain of wgmmas into an f32 accumulator of its
// own: big.big into d, big.small and small.big beside it, added to d at the
// end.  frag(ks, v) gives this thread's four A values of step ks, the
// wgmma tf32 A fragment (v = A[r][q], A[r+8][q], A[r][q+4], A[r+8][q+4],
// r = 16 warp + lane / 4, q = lane % 4), split here into big = tf32(v)
// and small = tf32(v - big); bdesc(ks, s) is the descriptor of B's big
// (s = 0) or small (s = 1) slice of step ks.  The fragments are built
// kBatch steps at a time, two batches in flight.  Three chains, not one:
// a wgmma that adds to the sum of the one before waits for it, so three
// independent chains keep three times as many wgmmas in flight; and the
// tensor cores round each wgmma's sum toward zero, so small terms added to
// a large sum lose about half an ulp each, which the two small chains do
// not.
template <int NW, int KS, typename Frag, typename Desc>
__device__ __forceinline__ void tf32x3(float (&d)[NW / 2], int n, Frag frag,
                                       Desc bdesc) {
  constexpr int KB = KS < kBatch ? KS : kBatch;
  uint32_t big[2][KB][4], sml[2][KB][4];
  float bs_sum[NW / 2], sb_sum[NW / 2];
  hopper::fence_regs(d);
  hopper::fence_regs(bs_sum);
  hopper::fence_regs(sb_sum);
#pragma unroll
  for (int bt = 0; bt < (KS + KB - 1) / KB; ++bt) {
    if (bt * KB >= n) break;
    const int s = bt % 2;
    if (bt >= 2) {        // the batch that held these registers has run
      hopper::wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        hopper::fence_regs(big[s][i]);
        hopper::fence_regs(sml[s][i]);
      }
    }
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (bt * KB + i < n) frag(bt * KB + i, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[e], big[s][i][e], sml[s][i][e]);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      const int ks = bt * KB + i;
      if (ks >= n) break;
      const uint64_t bb = bdesc(ks, 0), bsm = bdesc(ks, 1);
      const uint32_t(&fb)[4] = big[s][i];
      const uint32_t(&fs)[4] = sml[s][i];
      WgmmaTf32<NW>::rs(d, fb[0], fb[1], fb[2], fb[3], bb, ks > 0);
      WgmmaTf32<NW>::rs(bs_sum, fb[0], fb[1], fb[2], fb[3], bsm, ks > 0);
      WgmmaTf32<NW>::rs(sb_sum, fs[0], fs[1], fs[2], fs[3], bb, ks > 0);
    }
    hopper::wgmma_commit();
  }
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      hopper::fence_regs(big[s][i]);
      hopper::fence_regs(sml[s][i]);
    }
  hopper::fence_regs(d);
  hopper::fence_regs(bs_sum);
  hopper::fence_regs(sb_sum);
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) d[e] += bs_sum[e] + sb_sum[e];
}

// ---- launch 1 --------------------------------------------------------------
// Shared memory of one block: 1024 bytes of alignment slack; Bm^T of the
// chunk's rows and the block's NB columns, big then small (NB rows, K =
// the chunk's rows: column blocks of 32 rows, 128-byte swizzle); two
// rings of `stages` slots, one a consumer warpgroup, each slot a Bm piece
// or an x piece (kRows rows of max(P, NB) floats); w and cum of the
// group's heads; A of the group; the barriers.
template <int P, int NB>
struct StateSmem {
  static constexpr uint32_t SLOT = kRows * (P > NB ? P : NB) * 4;
  static __host__ __device__ constexpr size_t bytes(int Q, int stages) {
    return 1024 + 2 * (size_t)Q * NB * 4 + 2 * (size_t)stages * SLOT +
           (size_t)8 * wg::kStateGroup * Q + 8 * wg::kStateGroup +
           32 * (size_t)stages;
  }
};

// grid (n_chunks, n_groups * n_slices, B); block kStateThreads: two
// consumer warpgroups and a producer warp, for G = wg::kStateGroup heads of
// one (b, chunk) and NB = N / n_slices columns of their states; warpgroup
// w takes heads w and w + 2, so two heads' products run side by side.  Maps: x (P, L,
// H, B) in boxes of (row_bytes(P)/4, R); Bm (N, L, B, 1) in boxes of
// (row_bytes(NB)/4, R), R = min(Q, 64) rows.  Writes cum (B,H,n_chunks,Q)
// and each chunk's own contribution to the state at its end, states
// (B,H,n_chunks,P,N) f32:
//   states[p, n] = sum_q (x[q, p] w[q]) Bm[q, n],  w[q] = dt[q] exp(cum[Q-1] - cum[q])
// as acc (P rows, zero up to 64) x NB = sum over the chunk's R-row pieces
// of (x o w)^T . Bm, each piece's three tf32 products in an accumulator of
// its own, added to acc in f32.
// The items go through two rings, one a warpgroup (ring w's slot t is
// slot w stages + t): the chunk's Bm pieces in turn, then each head's x
// pieces in the ring of the warpgroup that takes the head.  Every
// consumer waits on every Bm piece and the pieces' slots are freed only
// after a block-wide sync, and a warpgroup alone waits on its x pieces: so
// each consumer waits on each slot's phases in order, never on a phase two
// ahead of the last it saw (a parity wait cannot tell them apart).
template <int P, int NB>
__global__ void __launch_bounds__(kStateThreads, 1) chunk_state_tf32_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap, const float* __restrict__ dt,
    const float* __restrict__ A, float* __restrict__ cum_out,
    float* __restrict__ states, int H, int N, int Q, int n_slices,
    int stages, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh) {
  using SM = StateSmem<P, NB>;
  constexpr int G = wg::kStateGroup;
  constexpr int SWP = row_bytes(P), SWB = row_bytes(NB);
  constexpr int NBC = NB * 4 / SWB, PC = P * 4 / SWP;   // TMA boxes a row
  constexpr int kWarps = kConsumers / 32;           // of one warpgroup
  constexpr int kAllWarps = kStateConsumers / 32;
  constexpr uint32_t BT_BLOCK = NB * 128;   // 32 rows of the chunk in Bm^T

  extern __shared__ uint8_t smem_raw[];
  uint8_t* bt_big = smem_base(smem_raw);
  uint8_t* bt_small = bt_big + (size_t)Q * NB * 4;
  uint8_t* ring = bt_small + (size_t)Q * NB * 4;
  float* w_s =
      reinterpret_cast<float*>(ring + 2 * (size_t)stages * SM::SLOT);
  float* cum_s = w_s + G * Q;
  float* a_s = cum_s + G * Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(a_s + 2 * G);
  uint64_t* empty = full + 2 * stages;

  const int c = blockIdx.x, n_chunks = gridDim.x;
  const int h0 = blockIdx.y / n_slices * G, ns = blockIdx.y % n_slices;
  const int b = blockIdx.z;
  const int nh = min(G, H - h0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l0 = c * Q;
  const int R = min(Q, kRows), n_pieces = Q / R;
  // item k of ring w: its slot, and the parity of its phase there.  Bm
  // piece i is item i / 2 of ring i % 2; ring w then holds x piece j of
  // head g = w + 2 t as its item (its Bm pieces) + t n_pieces + j.
  auto slot_of = [&](int w, int k) { return w * stages + k % stages; };
  auto phase_of = [&](int k) { return (uint32_t)(k / stages) & 1; };

  const wg::GroupDt dt_at{dt + b * dt_sb + h0 * dt_sh, l0, nh, dt_sl, dt_sh};
  float dv[wg::kDtLoads];
  if (warp < kAllWarps)
    wg::dt_prefetch<kStateConsumers>(dt_at, tid, Q, dv);
  if (warp == kAllWarps && lane < nh) a_s[lane] = A[h0 + lane];
  if (tid == kStateConsumers) {
    hopper::prefetch_map(&xmap);
    hopper::prefetch_map(&bmap);
    for (int s = 0; s < 2 * stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The producer: ring w's item k into its slot once the consumers have
  // taken item k - stages from it; the Bm pieces, then the heads' x pieces
  // in pairs, piece by piece.
  if (warp == kAllWarps) {
    if (lane == 0) {
      int k[2] = {0, 0};   // items put into each ring
      auto slot = [&](int w) {
        const int kk = k[w]++, s = slot_of(w, kk);
        if (kk >= stages) hopper::mbar_wait(empty + s, phase_of(kk) ^ 1);
        return s;
      };
      for (int i = 0; i < n_pieces; ++i) {
        const int s = slot(i % 2);
        hopper::mbar_expect_tx(full + s, (uint32_t)R * NB * 4);
        for (int cb = 0; cb < NBC; ++cb)
          hopper::tma_load_4d(ring + (size_t)s * SM::SLOT + cb * kRows * SWB,
                              &bmap, full + s, ns * NB + cb * (SWB / 4),
                              l0 + i * R, b, 0);
      }
      for (int g0 = 0; g0 < nh; g0 += 2)
        for (int j = 0; j < n_pieces; ++j)
          for (int g = g0; g < min(g0 + 2, nh); ++g) {
            const int s = slot(g % 2);
            hopper::mbar_expect_tx(full + s, (uint32_t)R * P * 4);
            for (int cb = 0; cb < PC; ++cb)
              hopper::tma_load_4d(ring + (size_t)s * SM::SLOT +
                                      cb * kRows * SWP,
                                  &xmap, full + s, cb * (SWP / 4),
                                  l0 + j * R, h0 + g, b);
          }
    }
    return;
  }

  // cum and w of the group while the loads land
  wg::group_decay<kStateConsumers>(dt_at, dv, a_s, w_s, cum_s, tid, Q);

  // Bm^T big and small: item (n, rows 4 q4 .. 4 q4 + 3) of a piece is four
  // reads down a column of the TMA tile (a warp reads 32 columns of one
  // row) and one 16-byte write of each half.  A thread's items are read
  // kTrBatch at a time before any is written: the compiler cannot tell
  // the writes from the reads, so it would order each read after the
  // writes before it.
  constexpr int kTrBatch = 4;
  const int wgi = warp / kWarps, wq = warp % kWarps;   // warpgroup, its warp
  for (int i = 0; i < n_pieces; ++i) {
    const int s = slot_of(i % 2, i / 2);
    hopper::mbar_wait(full + s, phase_of(i / 2));
    const uint8_t* src = ring + (size_t)s * SM::SLOT;
    const int items = NB * (R / 4);
    for (int it0 = tid; it0 < items; it0 += kTrBatch * kStateConsumers) {
      float v[kTrBatch][4];
#pragma unroll
      for (int u = 0; u < kTrBatch; ++u) {
        const int it = it0 + u * kStateConsumers, n = it % NB;
        const int q4 = it / NB * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[u][e] = it < items ? at<SWB>(src, q4 + e, n) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kTrBatch; ++u) {
        const int it = it0 + u * kStateConsumers, n = it % NB;
        const int q = i * R + it / NB * 4;
        if (it >= items) break;
        uint4 big, small;
        split(v[u][0], big.x, small.x);
        split(v[u][1], big.y, small.y);
        split(v[u][2], big.z, small.z);
        split(v[u][3], big.w, small.w);
        const uint32_t off = (q / 32) * BT_BLOCK +
                             hopper::swizzle(n * 128 + q % 32 * 4, 128);
        *reinterpret_cast<uint4*>(bt_big + off) = big;
        *reinterpret_cast<uint4*>(bt_small + off) = small;
      }
    }
    // every consumer warp has read the piece; the four warps of the ring's
    // warpgroup free the slot
    hopper::named_sync<2, kStateConsumers>();
    if (wgi == i % 2 && lane == 0) hopper::mbar_arrive(empty + s);
  }
  hopper::fence_proxy_async();
  hopper::named_sync<1, kStateConsumers>();

  const int n_bm = (n_pieces + 1 - wgi) / 2;   // Bm pieces in this ring
  const bool live = wq * 16 < P;           // acc rows p < P
  const int r = wq * 16 + lane / 4, kq = lane % 4;
  const ColFrag<SWP> xfrag(r, kq);
  const uint32_t big_addr = hopper::smem_u32(bt_big);
  const uint32_t small_addr = hopper::smem_u32(bt_small);
  for (int g = wgi; g < nh; g += 2) {
    const float* w = w_s + g * Q;
    float acc[NB / 2];
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[e] = 0.f;
    for (int j = 0; j < n_pieces; ++j) {
      const int k = n_bm + g / 2 * n_pieces + j, s = slot_of(wgi, k);
      hopper::mbar_wait(full + s, phase_of(k));
      const uint8_t* xs = ring + (size_t)s * SM::SLOT;
      const int q0 = j * R;
      // A = (x o w)^T: A[p][k] = x[k][p] w[k] over the piece's rows k
      auto frag = [&](int ks, float (&v)[4]) {
        if (!live) return;
        xfrag(xs, ks, v);
        const float w0 = w[q0 + ks * 8 + kq], w1 = w[q0 + ks * 8 + kq + 4];
        v[0] *= w0;
        v[1] *= w0;
        v[2] *= w1;
        v[3] *= w1;
      };
      auto bdesc = [&](int ks, int sm) {
        return kdesc<128>((sm ? small_addr : big_addr) + q0 / 32 * BT_BLOCK +
                              q0 % 32 * 4,
                          ks, NB);
      };
      float part[NB / 2];
      tf32x3<NB, kRows / 8>(part, R / 8, frag, bdesc);
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);
#pragma unroll
      for (int e = 0; e < NB / 2; ++e) acc[e] += part[e];
    }

    // rows r and r + 8, columns 8 jj + 2 kq and + 1: 8-byte stores, a
    // warp's 32-byte row segments whole sectors
    float* st = states +
                (((int64_t)b * H + h0 + g) * n_chunks + c) * P * N + ns * NB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = r + 8 * i;
      if (p >= P) continue;
#pragma unroll
      for (int jj = 0; jj < NB / 8; ++jj)
        *reinterpret_cast<float2*>(st + p * N + jj * 8 + 2 * kq) =
            make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
    }
  }

  // cum, written out by slice 0
  if (ns == 0)
    for (int i = tid; i < nh * Q; i += kStateConsumers)
      cum_out[(((int64_t)b * H + h0 + i / Q) * n_chunks + c) * Q + i % Q] =
          cum_s[i];
}

// ---- launch 3 --------------------------------------------------------------
// Shared memory of one block: 1024 bytes of alignment slack; C's kRows
// query rows, big (over the TMA tile) then small; W^T as the B operand of
// y^T += x^T . W^T, big then small (64 query rows of the key tile's 64
// keys: two column blocks of 32 keys, 128-byte swizzle); a ring of
// y^T's sum over the key tiles, each thread's own 32 floats (held here
// between the tiles, not in registers: the three accumulators of a
// product take them); `stages` slots, each a key tile's B (kRows rows of
// N) and x (kRows rows of P), or the state entering the chunk (P rows of
// N) in B's place; cum and dt of the chunk's rows up to the tile's end;
// the barriers.
template <int P, int N>
struct ScanSmem {
  static constexpr uint32_t C = kRows * N * 4;
  static constexpr uint32_t W = kRows * kRows * 4;
  static constexpr uint32_t X = kRows * P * 4;
  static constexpr uint32_t SLOT = C + X;
  static constexpr uint32_t ACC = kRows * kRows * 4;   // y^T, f32
  static __host__ __device__ constexpr size_t bytes(int Q, int stages) {
    return 1024 + 2 * C + 2 * W + ACC + (size_t)stages * SLOT +
           (size_t)8 * (Q > kRows ? Q : kRows) + 8 + 16 * (size_t)stages;
  }
};

// grid (n_chunks * n_qtiles, H, B); block kThreads: a consumer warpgroup
// and a producer warp for kRows query rows of one chunk and head.  Maps: x
// (P, L, H, B) in boxes of (row_bytes(P)/4, R); Bm and Cm (N, L, B, 1) in
// boxes of (row_bytes(N)/4, R), R = min(Q, 64); states (N, P, B H
// n_chunks, 1) in boxes of (row_bytes(N)/4, P).  cum (B,H,n_chunks,Q) and
// states, the state entering each chunk, from launches 1 and 2.  The
// block holds y^T (P rows, zero up to 64, by its 64 queries):
//   y^T  = exp(cum[q]) (S . C^T)                    (chunk 0 has no S)
//   G^T  = B . C^T                                  per key tile s
//   W^T  = (s <= q) ? G^T exp(cum[q] - cum[s]) dt[s] : 0
//   y^T += x^T . W^T
// S, B and x^T as A fragments read from their TMA tiles and split in
// registers, C and W^T as B operands split in shared memory; the carried
// state and each key tile's y^T term in accumulators of their own.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1) chunk_scan_tf32_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap bmap,
    const __grid_constant__ CUtensorMap cmap,
    const __grid_constant__ CUtensorMap smap, const float* __restrict__ dt,
    const void* __restrict__ D, int d_bf16, const float* __restrict__ cum,
    float* __restrict__ y, int L, int Q, int n_qtiles, int stages,
    int64_t dt_sb, int64_t dt_sl, int64_t dt_sh) {
  using SM = ScanSmem<P, N>;
  constexpr int SWN = row_bytes(N), SWP = row_bytes(P);
  constexpr int NC = N * 4 / SWN, PC = P * 4 / SWP;   // TMA boxes a row
  constexpr int kWarps = kConsumers / 32;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* c_big = smem_base(smem_raw);
  uint8_t* c_small = c_big + SM::C;
  uint8_t* w_big = c_small + SM::C;
  uint8_t* w_small = w_big + SM::W;
  float* acc = reinterpret_cast<float*>(w_small + SM::W);
  uint8_t* ring = w_small + SM::W + SM::ACC;
  float* cum_s = reinterpret_cast<float*>(ring + (size_t)stages * SM::SLOT);
  float* dt_s = cum_s + (Q > kRows ? Q : kRows);
  uint64_t* c_full = reinterpret_cast<uint64_t*>(dt_s + (Q > kRows ? Q : kRows));
  uint64_t* full = c_full + 1;
  uint64_t* empty = full + stages;

  const int c = blockIdx.x / n_qtiles;
  const int qt = n_qtiles - 1 - blockIdx.x % n_qtiles;  // most tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x / n_qtiles, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = min(Q, kRows);
  const int q0 = qt * kRows, n_kt = qt + 1;   // key tiles to the diagonal
  const int l0 = c * Q;
  const int64_t bhc = ((int64_t)b * H + h) * n_chunks + c;
  const int has_s = c > 0;                    // chunk 0 enters with zero
  const int n_items = has_s + n_kt;

  if (tid == kConsumers) {
    hopper::prefetch_map(&xmap);
    hopper::prefetch_map(&bmap);
    hopper::prefetch_map(&cmap);
    hopper::mbar_init(c_full, 1);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, kWarps);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // The producer: C's rows, then item i into slot i % stages once the
  // consumers have taken item i - stages from it: the state entering the
  // chunk (none in chunk 0), then B and x of each key tile to the diagonal
  if (warp == kWarps) {
    if (lane == 0) {
      hopper::mbar_expect_tx(c_full, (uint32_t)R * N * 4);
      for (int cb = 0; cb < NC; ++cb)
        hopper::tma_load_4d(c_big + cb * kRows * SWN, &cmap, c_full,
                            cb * (SWN / 4), l0 + q0, b, 0);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % stages;
        if (i >= stages) hopper::mbar_wait(empty + s, (i / stages - 1) & 1);
        uint8_t* dst = ring + (size_t)s * SM::SLOT;
        if (i < has_s) {
          hopper::mbar_expect_tx(full + s, (uint32_t)P * N * 4);
          for (int cb = 0; cb < NC; ++cb)
            hopper::tma_load_4d(dst + cb * kRows * SWN, &smap, full + s,
                                cb * (SWN / 4), 0, (int)bhc, 0);
          continue;
        }
        const int s0 = l0 + (i - has_s) * kRows;
        hopper::mbar_expect_tx(full + s, (uint32_t)R * (N + P) * 4);
        for (int cb = 0; cb < NC; ++cb)
          hopper::tma_load_4d(dst + cb * kRows * SWN, &bmap, full + s,
                              cb * (SWN / 4), s0, b, 0);
        for (int cb = 0; cb < PC; ++cb)
          hopper::tma_load_4d(dst + SM::C + cb * kRows * SWP, &xmap, full + s,
                              cb * (SWP / 4), s0, h, b);
      }
    }
    return;
  }

  // cum and dt of rows [0, min(q0 + 64, Q)) while the loads land
  const int rows_end = min(q0 + kRows, Q);
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  for (int i = tid; i < rows_end; i += kConsumers) {
    cum_s[i] = cum[bhc * Q + i];
    dt_s[i] = dtb[(int64_t)(l0 + i) * dt_sl];
  }
  // C split: big over the TMA tile, small beside it (the swizzle moves
  // whole 16-byte pieces, so the layout is kept)
  // (a thread reads all its pieces before it writes any: the compiler
  // would order each read after the writes before it)
  hopper::mbar_wait(c_full, 0);
  {
    constexpr int C4 = SM::C / 16 / kConsumers;   // float4s a thread
    float4 v[C4];
#pragma unroll
    for (int u = 0; u < C4; ++u)
      v[u] = reinterpret_cast<const float4*>(c_big)[tid + u * kConsumers];
#pragma unroll
    for (int u = 0; u < C4; ++u) {
      uint4 big, small;
      split(v[u].x, big.x, small.x);
      split(v[u].y, big.y, small.y);
      split(v[u].z, big.z, small.z);
      split(v[u].w, big.w, small.w);
      reinterpret_cast<uint4*>(c_big)[tid + u * kConsumers] = big;
      reinterpret_cast<uint4*>(c_small)[tid + u * kConsumers] = small;
    }
  }
  hopper::fence_proxy_async();
  hopper::named_sync<1, kConsumers>();

  const bool live = warp * 16 < P;      // y^T rows p < P
  const int r = warp * 16 + lane / 4, kq = lane % 4;
  const RowFrag<SWN> nfrag(r, kq);      // the state's and B's, over N
  const ColFrag<SWP> xfrag(r, kq);      // x^T's, over the keys
  const uint32_t cb_addr = hopper::smem_u32(c_big);
  const uint32_t cs_addr = hopper::smem_u32(c_small);
  const uint32_t wb_addr = hopper::smem_u32(w_big);
  const uint32_t ws_addr = hopper::smem_u32(w_small);
  // C^T as the B operand of k8 step ks (over N), big or small
  auto cdesc = [&](int ks, int sm) {
    return kdesc<SWN>(sm ? cs_addr : cb_addr, ks, kRows);
  };
  // this thread's columns of y^T, G^T and W^T: queries 8 j + 2 kq + cc of
  // the tile, in register 4 j + 2 i + cc (i: rows r and r + 8); its y^T at
  // acc[e * kConsumers + tid]
  float part[kRows / 2];

  // the carried state: y^T = exp(cum[q]) (S . C^T)
  int it = 0;
  if (!has_s) {
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) acc[e * kConsumers + tid] = 0.f;
  } else {
    hopper::mbar_wait(full, 0);
    const uint8_t* ss = ring;
    auto frag = [&](int ks, float (&v)[4]) {
      if (live) nfrag(ss, ks, v);
    };
    tf32x3<kRows, N / 8>(part, N / 8, frag, cdesc);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty);
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) {
      const int q = q0 + (e / 4) * 8 + 2 * kq + e % 2;
      const float decay = exp_here(cum_s[q < Q ? q : Q - 1]);
      part[e] = q < Q ? part[e] * decay : 0.f;
    }
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) acc[e * kConsumers + tid] = part[e];
    it = 1;
  }

  // intra-chunk, per key tile up to the diagonal
  for (int j = 0; j < n_kt; ++j, ++it) {
    const int s = it % stages;
    hopper::mbar_wait(full + s, (it / stages) & 1);
    const uint8_t* bs = ring + (size_t)s * SM::SLOT;
    const uint8_t* xs = bs + SM::C;

    // G^T = B . C^T: A[key][n] from B's TMA tile
    float g[kRows / 2];
    auto bfrag = [&](int ks, float (&v)[4]) { nfrag(bs, ks, v); };
    tf32x3<kRows, N / 8>(g, N / 8, bfrag, cdesc);

    // W^T[s][q] = (s <= q < Q) ? G^T exp(cum[q] - cum[s]) dt[s] : 0 (a
    // select: above the diagonal the exp overflows, and inf * 0 is NaN),
    // stored split as the K-major B operand W[q][s]
    // (cum and dt are read before W^T is written: the compiler would order
    // each read after the writes before it)
    float cq[kRows / 8][2], ck[2], dk[2];
#pragma unroll
    for (int jj = 0; jj < kRows / 8; ++jj)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int q = q0 + jj * 8 + 2 * kq + cc;
        cq[jj][cc] = q < rows_end ? cum_s[q] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = j * kRows + r + 8 * i;
      ck[i] = key < rows_end ? cum_s[key] : 0.f;
      dk[i] = key < rows_end ? dt_s[key] : 0.f;
    }
    hopper::named_sync<1, kConsumers>();   // the last tile's W^T is read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int sl = r + 8 * i, key = j * kRows + sl;
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        // W[ql][sl], ql = 8 jj + 2 kq + cc: the swizzle of row ql does
        // not depend on jj
        const uint32_t qo = 2 * kq + cc;
        uint8_t* wb = w_big + sl / 32 * (kRows * 128) + qo * 128 +
                      ((sl % 32 * 4) ^ ((qo & 7) << 4));
        uint8_t* ws = wb + (w_small - w_big);
#pragma unroll
        for (int jj = 0; jj < kRows / 8; ++jj) {
          // the exponent is selected before expf, so that every element
          // takes the same instructions (no branch) and none overflows
          const int q = q0 + jj * 8 + qo;
          const bool keep = key <= q && q < Q;
          const float e = exp_here(keep ? cq[jj][cc] - ck[i] : 0.f);
          const float wv = keep ? g[4 * jj + 2 * i + cc] * e * dk[i] : 0.f;
          uint32_t big, small;
          split(wv, big, small);
          *reinterpret_cast<uint32_t*>(wb + jj * 8 * 128) = big;
          *reinterpret_cast<uint32_t*>(ws + jj * 8 * 128) = small;
        }
      }
    }
    hopper::fence_proxy_async();
    hopper::named_sync<1, kConsumers>();

    // y^T += x^T . W^T: A[p][key] = x[key][p] from x's TMA tile
    auto tfrag = [&](int ks, float (&v)[4]) {
      if (live) xfrag(xs, ks, v);
    };
    auto wdesc = [&](int ks, int sm) {
      return kdesc<128>(sm ? ws_addr : wb_addr, ks, kRows);
    };
    tf32x3<kRows, kRows / 8>(part, R / 8, tfrag, wdesc);
    // the diagonal tile's x rows are the block's queries: its slot stays
    // for the epilogue (no item follows it)
    __syncwarp();
    if (lane == 0 && j + 1 < n_kt) hopper::mbar_arrive(empty + s);
    float sum[kRows / 2];   // all read before any is written, as above
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e) sum[e] = acc[e * kConsumers + tid];
#pragma unroll
    for (int e = 0; e < kRows / 2; ++e)
      acc[e * kConsumers + tid] = sum[e] + part[e];
  }

  // y[q][p] = y^T[p][q] + D[h] x[q][p], x from the diagonal tile
  if (!live) return;
  const uint8_t* xq = ring + (size_t)((it - 1) % stages) * SM::SLOT + SM::C;
  const float Dh = d_bf16 ? __bfloat162float(
                                static_cast<const __nv_bfloat16*>(D)[h])
                          : static_cast<const float*>(D)[h];
  float xv[kRows / 2];     // read before y is written, as above
#pragma unroll
  for (int e = 0; e < kRows / 2; ++e) {
    xv[e] = at<SWP>(xq, (e / 4) * 8 + 2 * kq + e % 2, r + 8 * ((e / 2) % 2));
    part[e] = acc[e * kConsumers + tid];
  }
#pragma unroll
  for (int e = 0; e < kRows / 2; ++e) {
    const int p = r + 8 * ((e / 2) % 2);
    const int q = q0 + (e / 4) * 8 + 2 * kq + e % 2;
    if (p < P && q < Q)
      y[(((int64_t)b * L + l0 + q) * H + h) * P + p] = part[e] + Dh * xv[e];
  }
}

// Launch 1's column slices: the fewest for which Bm^T of the block's
// columns and a slot of each ring fit (NB at most 64, at least 16), and
// its rings' depth: as many slots as fit in both, up to kStateStages and
// the items of warpgroup 0's ring (it takes the more).
inline void state_plan(int P, int N, int Q, int H, int& n_slices,
                       int& stages) {
  const int R = Q < kRows ? Q : kRows;
  const int G = wg::kStateGroup, nh = H < G ? H : G;
  for (n_slices = N > 64 ? N / 64 : 1; n_slices < N / 16; n_slices *= 2) {
    const int NB = N / n_slices;
    const size_t slot = kRows * (P > NB ? P : NB) * 4;
    const size_t base = 1024 + 2 * (size_t)Q * NB * 4 + (size_t)8 * G * Q +
                        8 * G;
    if (base + 2 * (slot + 16) <= kMaxSmem) break;
  }
  const int NB = N / n_slices;
  const size_t slot = kRows * (P > NB ? P : NB) * 4;
  const size_t base = 1024 + 2 * (size_t)Q * NB * 4 + (size_t)8 * G * Q +
                      8 * G;
  const int items = (Q / R + 1) / 2 + (nh + 1) / 2 * (Q / R);
  stages = (int)((kMaxSmem - base) / (2 * (slot + 16)));
  stages = stages < kStateStages ? stages : kStateStages;
  stages = stages < items ? stages : items;
  stages = stages > 1 ? stages : 1;
}

template <int P, int NB>
int launch_state(const CUtensorMap maps[5], const float* dt, const float* A,
                 float* cum, float* states, int B, int L, int H, int N, int Q,
                 int n_slices, int stages, int64_t dt_sb, int64_t dt_sl,
                 int64_t dt_sh, cudaStream_t st) {
  auto kernel = chunk_state_tf32_kernel<P, NB>;
  const size_t smem = StateSmem<P, NB>::bytes(Q, stages);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_groups = (H + wg::kStateGroup - 1) / wg::kStateGroup;
  if ((int64_t)n_groups * n_slices > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<dim3(L / Q, n_groups * n_slices, B), kStateThreads, smem, st>>>(
      maps[0], maps[1], dt, A, cum, states, H, N, Q, n_slices, stages, dt_sb,
      dt_sl, dt_sh);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_state(int NB, const CUtensorMap maps[5], const float* dt,
                   const float* A, float* cum, float* states, int B, int L,
                   int H, int N, int Q, int n_slices, int stages,
                   int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                   cudaStream_t st) {
  switch (NB) {
#define REPRO_SSD_TF_ST(NN)                                                 \
  case NN:                                                                  \
    return launch_state<P, NN>(maps, dt, A, cum, states, B, L, H, N, Q,     \
                               n_slices, stages, dt_sb, dt_sl, dt_sh, st);
    REPRO_SSD_TF_ST(16)
    REPRO_SSD_TF_ST(32)
    REPRO_SSD_TF_ST(64)
#undef REPRO_SSD_TF_ST
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first launch for float32 on the tensor cores.  The maps are
// make_maps'.
int chunk_state(const CUtensorMap maps[5], const float* dt, const float* A,
                float* cum, float* states, int B, int L, int H, int P, int N,
                int Q, int n_slices, int stages, int64_t dt_sb, int64_t dt_sl,
                int64_t dt_sh, cudaStream_t st) {
#define REPRO_SSD_TF_ST_ARGS                                                \
  N / n_slices, maps, dt, A, cum, states, B, L, H, N, Q, n_slices, stages,  \
      dt_sb, dt_sl, dt_sh, st
  if (P == 16) return dispatch_state<16>(REPRO_SSD_TF_ST_ARGS);
  if (P == 32) return dispatch_state<32>(REPRO_SSD_TF_ST_ARGS);
  return dispatch_state<64>(REPRO_SSD_TF_ST_ARGS);
#undef REPRO_SSD_TF_ST_ARGS
}

template <int P, int N>
int launch_scan(const CUtensorMap maps[5], const float* dt, const void* D,
                int d_bf16, const float* cum, void* y, int B, int L, int H,
                int Q, int64_t dt_sb, int64_t dt_sl, int64_t dt_sh,
                cudaStream_t st) {
  auto kernel = chunk_scan_tf32_kernel<P, N>;
  using SM = ScanSmem<P, N>;
  // ring slots: as many as fit, up to kScanStages and the most items a
  // block takes (the state and every key tile of the chunk)
  const int items = 1 + (Q + kRows - 1) / kRows;
  int stages = (int)((kMaxSmem - SM::bytes(Q, 0)) / (SM::SLOT + 16));
  stages = stages < kScanStages ? stages : kScanStages;
  stages = stages < items ? stages : items;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = SM::bytes(Q, stages);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qtiles = (Q + kRows - 1) / kRows;
  kernel<<<dim3((L / Q) * n_qtiles, H, B), kThreads, smem, st>>>(
      maps[0], maps[2], maps[3], maps[4], dt, D, d_bf16, cum,
      static_cast<float*>(y), L, Q, n_qtiles, stages, dt_sb, dt_sl, dt_sh);
  return (int)cudaGetLastError();
}

template <int P>
int dispatch_scan(int N, const CUtensorMap maps[5], const float* dt,
                  const void* D, int d_bf16, const float* cum, void* y, int B,
                  int L, int H, int Q, int64_t dt_sb, int64_t dt_sl,
                  int64_t dt_sh, cudaStream_t st) {
  switch (N) {
#define REPRO_SSD_TF_N(NN)                                                  \
  case NN:                                                                  \
    return launch_scan<P, NN>(maps, dt, D, d_bf16, cum, y, B, L, H, Q,      \
                              dt_sb, dt_sl, dt_sh, st);
    REPRO_SSD_TF_N(16)
    REPRO_SSD_TF_N(32)
    REPRO_SSD_TF_N(64)
    REPRO_SSD_TF_N(128)
#undef REPRO_SSD_TF_N
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The third launch for float32 on the tensor cores.  The maps are
// make_maps'.
int chunk_scan(const CUtensorMap maps[5], const float* dt, const void* D,
               int d_bf16, const float* cum, void* y, int B, int L, int H,
               int P, int N, int Q, int64_t dt_sb, int64_t dt_sl,
               int64_t dt_sh, cudaStream_t st) {
#define REPRO_SSD_TF_ARGS                                                   \
  N, maps, dt, D, d_bf16, cum, y, B, L, H, Q, dt_sb, dt_sl, dt_sh, st
  if (P == 16) return dispatch_scan<16>(REPRO_SSD_TF_ARGS);
  if (P == 32) return dispatch_scan<32>(REPRO_SSD_TF_ARGS);
  return dispatch_scan<64>(REPRO_SSD_TF_ARGS);
#undef REPRO_SSD_TF_ARGS
}

// The float32 tensor-core instances take P in {16, 32, 64}, N in {16, 32,
// 64, 128}, Q a multiple of 64 or Q = 32, x, Bm and Cm at 16-byte aligned
// bases and strides (the wrapper decides this before any launch).  Their
// TMA maps, R = min(Q, 64) rows a box: x (P, L, H, B) in boxes of
// (row_bytes(P)/4, R); Bm (N, L, B, 1) in boxes of (row_bytes(NB)/4, R)
// for launch 1 and of (row_bytes(N)/4, R) for launch 3; Cm likewise; the
// states (N, P, B H n_chunks, 1) in boxes of (row_bytes(N)/4, P).
int make_maps(CUtensorMap maps[5], const void* x, const void* Bm,
              const void* Cm, const float* states, int B, int L, int H, int P,
              int N, int Q, int NB, int64_t x_sb, int64_t x_sl, int64_t x_sh,
              int64_t b_sb, int64_t b_sl, int64_t c_sb, int64_t c_sl) {
  if ((Q % kRows && Q != 32) || (P != 16 && P != 32 && P != 64) ||
      (N != 16 && N != 32 && N != 64 && N != 128))
    return (int)cudaErrorInvalidValue;
  const int R = Q < kRows ? Q : kRows;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int64_t xdims[4] = {P, L, H, B}, xs[3] = {x_sl, x_sh, x_sb};
  const int64_t ndims[4] = {N, L, B, 1};
  const int64_t bs[3] = {b_sl, b_sb, b_sb * B}, cs[3] = {c_sl, c_sb, c_sb * B};
  const int64_t n_bhc = (int64_t)B * H * (L / Q);
  const int64_t sdims[4] = {N, P, n_bhc, 1};
  const int64_t ss[3] = {N, (int64_t)P * N, (int64_t)P * N * n_bhc};
  int rc = hopper::make_map_4d(&maps[0], f32, 4, x, xdims, xs,
                               row_bytes(P) / 4, R);
  if (!rc) rc = hopper::make_map_4d(&maps[1], f32, 4, Bm, ndims, bs,
                                    row_bytes(NB) / 4, R);
  if (!rc) rc = hopper::make_map_4d(&maps[2], f32, 4, Bm, ndims, bs,
                                    row_bytes(N) / 4, R);
  if (!rc) rc = hopper::make_map_4d(&maps[3], f32, 4, Cm, ndims, cs,
                                    row_bytes(N) / 4, R);
  if (!rc) rc = hopper::make_map_4d(&maps[4], f32, 4, states, sdims, ss,
                                    row_bytes(N) / 4, P);
  return rc;
}

}  // namespace tf

// the instances of launches 1 and 3 (ssd_scan_launch's `instance`)
enum Instance { kCudaCore = 0, kWgmma = 1, kTf32 = 2 };

template <typename T, typename TD>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const void* D, void* y, float* final_state,
           float* cum, float* states, int B, int L, int H, int P, int N,
           int Q, int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
           int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
           int64_t c_sb, int64_t c_sl, int instance, cudaStream_t st) {
  const int n_chunks = L / Q;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  cudaError_t e;

  CUtensorMap maps[5];
  if (instance == kWgmma) {
    if (sizeof(T) != 2) return (int)cudaErrorInvalidValue;
    int rc = wg::make_maps(maps, x, Bm, Cm, B, L, H, P, N, Q, x_sb, x_sl,
                           x_sh, b_sb, b_sl, c_sb, c_sl);
    if (!rc)
      rc = wg::chunk_state(maps, dt, A, cum, states, B, L, H, P, N, Q, dt_sb,
                           dt_sl, dt_sh, st);
    if (rc) return rc;
  } else if (instance == kTf32) {
    if (sizeof(T) != 4) return (int)cudaErrorInvalidValue;
    int n_slices, stages;
    tf::state_plan(P, N, Q, H, n_slices, stages);
    int rc = tf::make_maps(maps, x, Bm, Cm, states, B, L, H, P, N, Q,
                           N / n_slices, x_sb, x_sl, x_sh, b_sb, b_sl, c_sb,
                           c_sl);
    if (!rc)
      rc = tf::chunk_state(maps, dt, A, cum, states, B, L, H, P, N, Q,
                           n_slices, stages, dt_sb, dt_sl, dt_sh, st);
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

  if (instance == kWgmma)
    return wg::chunk_scan(maps, x, dt, D, sizeof(TD) == 2, cum, states, y, B,
                          L, H, P, N, Q, x_sb, x_sl, x_sh, dt_sb, dt_sl,
                          dt_sh, st);
  if (instance == kTf32)
    return tf::chunk_scan(maps, dt, D, sizeof(TD) == 2, cum, y, B, L, H, P,
                          N, Q, dt_sb, dt_sl, dt_sh, st);
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
// instance picks launches 1 and 3 together: 1 runs chunk_state_wgmma_kernel
// and chunk_scan_wgmma_kernel (bf16 only, at the shapes wg::make_maps
// names), 2 chunk_state_tf32_kernel and chunk_scan_tf32_kernel (float32
// only, at the shapes tf::make_maps names), 0 chunk_state_kernel and
// chunk_scan_kernel.
// Returns cudaGetLastError() after the launches (0 on success), or 10000 +
// the CUresult of cuTensorMapEncodeTiled where a TMA tensor map cannot be
// encoded.
int ssd_scan_launch(int x_dtype, int d_dtype, const void* x, const float* dt,
                    const float* A, const void* Bm, const void* Cm,
                    const void* D, void* y, float* final_state, float* cum,
                    float* states, int B, int L, int H, int P, int N, int Q,
                    int64_t x_sb, int64_t x_sl, int64_t x_sh, int64_t dt_sb,
                    int64_t dt_sl, int64_t dt_sh, int64_t b_sb, int64_t b_sl,
                    int64_t c_sb, int64_t c_sl, int instance,
                    void* stream) {
  if (P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 || Q > kMaxQ ||
      L % Q != 0 || B < 1 || B > 65535 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_SSD_ARGS                                                      \
  x, dt, A, Bm, Cm, D, y, final_state, cum, states, B, L, H, P, N, Q, x_sb, \
      x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb, b_sl, c_sb, c_sl, instance,    \
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
