// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_kernel` in
// src/repro/kernels/flash_attention.py (pallas_call at :93): q attends to
// k and v with an f32 online softmax over KV tiles of `bk` keys, one
// q tile of `bq` rows at a time; GQA maps query head h to KV head h / G.
//
// Three kernels.  The caller (kernels/flash_attention.py) names one, by
// dtype, head dim D (32, 64, 128 or 256; the wrapper pads any other D up
// to 256 with zero columns) and alignment:
//  * bfloat16 at D <= 128, and at D = 256 where TMA can read q, k, v and
//    o (16-byte aligned base addresses and strides): flash_fwd_wgmma_kernel,
//    on the tensor cores (below);
//  * float32 that TMA can read: flash_fwd_tf32_kernel, on the tensor
//    cores as three tf32 products (below);
//  * float32 that TMA cannot read, and bfloat16 at D = 256 that TMA
//    cannot read: flash_fwd_kernel, f32 FMAs on CUDA cores (at D = 256
//    every (bq, bk) fits a block's shared memory, at most 198 KB).
//
// Semantics kept from the reference by all three: scores are f32 sums
// times the scale; masked scores are the finite -1e30; the softmax state
// (m, l) and the rescale of acc are updated once per bk tile (a tile
// wider than a kernel's piece, once per piece: see each kernel); l is the
// f32 sum of f32 p; the output is acc / max(l, 1e-30) in q's dtype.  KV
// tiles that the causal or window mask removes entirely are not visited
// (the Pallas kernel computes them).  Skipping is exact: such a tile
// leaves (m, l, acc) unchanged in the reference.  The one case where it
// would not is a row whose every key is masked (Sq > Sk with a window):
// the reference then returns the mean of v over all Sk, because the
// finite -1e30 makes p = 1 everywhere.  A pass holding such a row visits
// every tile, as the reference does.  q, k, v and o are read and written
// through strides with only the last dimension contiguous: `mha` passes
// (B,S,H,D) tensors as views.  The causal q tiles with the most keys are
// launched first.
//
// What bounds it: the operations.  At a prefill shape (S = 4096, D = 128)
// each (q, k) pair that the mask keeps costs 2D flops for q.k and 2D for
// p.v against a few bytes of q, k, v and o per row, so the work is far
// above the H100's balance point.
//
// --- bfloat16: flash_fwd_wgmma_kernel -------------------------------------
// The reference casts q, k, v to f32, so q.k is a product of exact bf16
// values with f32 sums: wgmma with bf16 operands and f32 accumulators
// computes it as it is.  p stays f32 in the reference's p.v; here p is
// split into p_hi = bf16(p) and p_lo = bf16(p - p_hi), and acc += p_hi.V
// + p_lo.V are two bf16 wgmmas into one f32 accumulator, which keeps p to
// about 16 significant bits (bf16-only p, SDPA's choice, changes the
// function).  Least time: q.k once and p.v twice at the bf16 rate.
//  * One block per (b, h, q tile): one or two consumer warpgroups of 64
//    q rows each and one producer warp (with two consumer warpgroups it
//    sits in a warpgroup of its own, and setmaxnreg hands its registers
//    to the consumers: 240 a thread).  A q tile taller than the
//    warpgroups is walked in passes; a q tile under 64 rows is padded to
//    64 (the padded rows are computed, never stored, and cannot reach a
//    real row: rows of a product are independent).
//  * bk of 32, 64 or 128 (the search domain's, and ops.mha's 128) has
//    instances of its own, with the tile known to the compiler, and a
//    multiple of 128 (the domain's 256) is walked as tiles of 128 keys:
//    at 256-key pieces a lone warpgroup's scores and p fragments spilled.
//    Any other bk is walked in pieces of 64 keys, each one softmax update
//    (as the f32 kernel does per 256 keys).  At D = 256 only bk = 32 has
//    its own instances: every other bk takes the 64-key pieces (below).
//    Keys of a piece past the end of its tile are padding with the score
//    -inf, so p = 0 and they change neither m, l nor acc, whatever they
//    hold (the next tile's keys, or TMA's zero fill past Sk); a row that
//    keeps no key still averages v over its Sk keys only.
//  * The producer warp loads a pass's q rows by TMA (a q_empty barrier
//    frees the buffer for the next pass), then keeps K and V sub-tiles of
//    N = min(piece, 64) keys in flight through a ring of `stages`
//    shared-memory slots (TMA with mbarriers: K and V of a slot each on a
//    "full" barrier, the slot freed by an "empty" barrier that every
//    consumer warp arrives on).  Tiles are stored as the TMA swizzle
//    writes them (128B rows for D >= 64, 64B rows for D = 32).  Shared
//    memory does not grow with bq.
//  * Per piece a consumer warpgroup issues S = Q.K^T as wgmma m64nNk16
//    (Q and K K-major in shared memory), then the online softmax runs in
//    registers on the accumulator layout: a row is held by 4 threads and
//    reduced with two shuffles.  p_hi and p_lo go from the S accumulator
//    straight into register A fragments (the accumulator's layout is the
//    A fragment's), and acc += p.V is wgmma m64nDk16 with A in registers
//    and V as the B operand, MN-major (transposed) in shared memory.
//  * The output is divided by l in registers and stored through strides.
//  * D = 256.  The accumulator alone is D/2 = 128 f32 registers a thread;
//    beside it a 64-key piece's scores take 32 and p_hi and p_lo 16 + 16
//    (the scores die into the p fragments), within the 240 registers of
//    two consumer warpgroups.  So a piece is 64 keys at most (32 at bk =
//    32): q.k runs per 64-key sub-tile as m64n64k16 over 16 k16 steps,
//    p.v as m64n256k16 with A from registers.  Shared memory: a pass of
//    q is 64 KB (two warpgroups), one K + V slot of 64 keys 64 KB, so
//    the ring holds two slots (197,696 bytes of the 232,448).
// The wgmma, TMA and mbarrier helpers are in hopper.cuh.
//
// --- float32: flash_fwd_tf32_kernel ---------------------------------------
// The reference's f32 products at the tf32 rate.  Each f32 operand x is
// split into big = tf32(x) (cvt.rna: to nearest, ties away) and small =
// tf32(x - big), and each product is three tf32 wgmmas into one f32
// accumulator: big.big + big.small + small.big (small.small, ~2^-22 of
// the product, is dropped).  That keeps about 21 of f32's 24 bits: within
// ~2.5e-6 of the f32 reference at a prefill shape, where bf16 hi + lo
// misses the kernel search's 2e-5 gate and one tf32 product misses it 50
// times over (kernels/flash_attention.py `flash_tf32x3_ref` emulates all
// three).  Both roundings are explicit, so what the tensor cores do with
// an operand's 13 low bits does not matter.  Least time: six tf32
// products at 495 TFLOP/s.
//  * Blocks, warps and passes are flash_fwd_wgmma_kernel's: one block per
//    (b, h, q tile), one or two consumer warpgroups of 64 q rows and a
//    producer warp (setmaxnreg 240 / 24 with two), q tiles padded to 64
//    rows or walked in passes.  Tiles arrive by TMA with the 128-byte
//    swizzle (rows of 32 floats); a tf32 k8 step is 32 bytes, as bf16's
//    k16 step is, so the K-major descriptors are the bf16 kernel's.
//  * tf32 wgmma reads both operands K-major: the PTX ISA has no transpose
//    for 32-bit types.  q and k rows have D contiguous, as q.k^T needs.
//    For p.v each V sub-tile is transposed in shared memory into V^T (D
//    rows of the sub-tile's keys, column blocks of 32 keys).  p comes from
//    the S accumulator in registers, where a thread holds keys (2q, 2q+1)
//    of each 8-key group, while a tf32 A fragment holds columns (q, q+4).
//    V^T stores each 8-key group in the key order (0, 2, 4, 6, 1, 3, 5,
//    7): then the accumulator's registers are the A fragment as they are,
//    and p.v sums over the same keys.
//  * The consumers split each tile once it lands: q per pass and K in
//    place (big over the TMA tile, small beside it), V into V^T big and
//    small (small over the TMA tile once every thread has read it).  Every
//    consumer thread splits its share; fence.proxy.async and a named
//    barrier among the consumers hand the tile to wgmma.
//  * Shared memory holds a pass of q twice (big and small, 64 KB a
//    warpgroup at D = 128) and a ring of slots of one K or V sub-tile
//    twice (8 N D bytes for N keys), which the producer fills in the
//    consumers' order: per piece its K sub-tiles, then its V sub-tiles.
//    A consumer frees a K slot once the next sub-tile's wgmmas are issued
//    and its own have run, so a K sub-tile's split overlaps the previous
//    one's products; a V slot once its own products have run.  Plans
//    (227 KB a block at most):
//      D = 128: 32-key sub-tiles; two warpgroups: q 128 KB and 3 slots of
//               32 KB; one warpgroup: q 64 KB and 5 slots;
//      D = 64:  64-key sub-tiles (32 at bk = 32): q 64 KB (two
//               warpgroups) and up to 5 slots of 32 KB;
//      D = 32:  q 32 KB and up to 8 slots of 16 KB (two pieces' K and V).
//  * A piece (one softmax update) is bk keys at bk = 32, 64 or 128, 128
//    keys of a bk that is a multiple of 128, and 64 keys of any other bk;
//    keys of a piece past its tile are -inf, as in the bf16 kernel.
//  * The tensor cores round each wgmma's sum toward zero, so a long chain
//    of wgmmas into one accumulator drifts: p.v chained over 4096 keys
//    (1,536 wgmmas) brought the output at the qwen1.5-4b prefill shape
//    near the 8e-6 gate of chip_smoke.py, several times the emulation's
//    error.  So each piece's p.v goes into an accumulator of its own (48
//    wgmmas at 128 keys), and acc = acc * alpha + pv is an f32 FMA,
//    rounded to nearest, once per piece.  A
//    thread holds acc and pv (D/2 each), the piece's scores (64 registers
//    at 128 keys) and one sub-tile's big and small p; at D = 128 that
//    spills (PERF.md).
//  * D = 256 (tf32_cols).  acc and pv would each take 128 registers a
//    thread of one warpgroup, and one 64-row pass of q, big and small, is
//    128 KB of the 227.  So the two consumer warpgroups share each pass's
//    64 rows and split D: warpgroup w owns columns [128 w, 128 w + 128),
//    its acc 64 registers and its pv 32 (one 64-column pair at a time).
//    For q.k each forms the partial S over its own 128 columns of D
//    (m64n64k8, three products per k8 step); the two partial sums meet in
//    shared memory (16 KB each a 64-key piece, two named barriers) and
//    each warpgroup adds the other's to its own, so both hold the same S
//    (a + b is b + a exactly) and run the same softmax.  A piece is 32
//    keys at bk = 32, else 64.  Slots are 2048 floats: a K slot the
//    piece's keys of one 32-column block (two at 32-key pieces), the q.k
//    B operand; a V slot 32 keys of a 64-column pair (two TMA boxes),
//    transposed into V^T by split_vt (16-byte reads and writes; p.v as
//    m64n64k8 with p from registers).  The producer loads each piece's K
//    slots, then its V slots, the two warpgroups' in turn, so each
//    warpgroup keeps half of the ring of 4 slots (5 did not run faster at
//    32-key pieces, scripts/flash_tf32_d256_parts.py): 1,024 + 131,072
//    (q) + 4 x 16,384 (slots) + 32,768 (partial S; 16,384 at 32-key
//    pieces) + 80 = 230,480 bytes.  The grid has one block per 64-row
//    pass: a q tile of whole passes is cut into blocks, as nothing of one
//    pass serves the next.
//
// --- flash_fwd_kernel (first design, CUDA cores) --------------------------
// float32 with a base or stride TMA cannot read, bfloat16 at D = 256 with
// a base or stride TMA cannot read.
//  * One block per (b, h, q tile); 256 threads as a 16 x 16 grid, each
//    holding a register tile of 2 or 4 query rows (the block walks its
//    q tile in passes of 32 or 64 rows) by D/16 output columns and by
//    4 score columns: f32 FMAs on CUDA cores, operands from shared
//    memory with rows padded to an odd stride, so no bank conflicts.
//  * The softmax state is updated once per bk tile, as in the reference
//    (a tile wider than 256 keys is updated per 256-key piece); K and V
//    enter shared memory in sub-tiles of 64 keys, so every (bq, bk) of
//    the search domain fits a block's 227 KB (at most 198 KB, at D=256).
//  * p stays f32 for p.v, as in the reference; its least time is at the
//    f32 rate (67 TFLOP/s).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the instance for D, by the q rows a thread holds
template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int G, int Sq, int Sk, int bq, int bk, int causal,
             int window, const int64_t* st, float scale,
             cudaStream_t stream) {
  return rows_per_thread(bq) == 2
             ? launch<T, D, 2>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, stream)
             : launch<T, D, 4>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, stream);
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int G, int Sq, int Sk, int bq, int bk,
             int causal, int window, const int64_t* st, float scale,
             cudaStream_t stream) {
#define REPRO_FLASH_CASE(DD)                                                 \
  case DD:                                                                   \
    return launch_d<T, DD>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal,     \
                           window, st, scale, stream);
  switch (D) {
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(128)
    REPRO_FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

// ---------------------------------------------------------------------------
// bfloat16: flash_fwd_wgmma_kernel
// ---------------------------------------------------------------------------
namespace wg {

using hopper::Wgmma;

constexpr int kRows = 64;                     // q rows of one warpgroup
constexpr size_t kMaxSmem = 232448;           // bytes a block can use
constexpr float kLog2e = 1.4426950408889634f;

// The kernel's tile parameter BK for a bk at head dim D (see the header):
// tiles of BK keys known to the compiler, each one piece, or 0 (tiles of
// bk keys, in 64-key pieces).  D <= 128: bk itself at 32, 64 or 128, 128
// at any multiple of 128 (a tile of bk keys is bk / 128 tiles of 128),
// else 0; D = 256: 32 at bk = 32, else 0 (a piece of 64 keys at most).
// Then the keys of a piece; keys per K/V sub-tile of a piece; bytes of a
// swizzled row of q, k or v
__host__ __device__ constexpr int kernel_bk(int D, int bk) {
  return bk == 32 ? 32
         : D == 256 ? 0
         : bk == 64 ? 64
         : bk > 0 && bk % 128 == 0 ? 128 : 0;
}
__host__ __device__ constexpr int piece_width(int BK) { return BK ? BK : 64; }
__host__ __device__ constexpr int sub_keys(int bkc) { return bkc < 64 ? bkc : 64; }
__host__ __device__ constexpr int row_bytes(int D) {
  return (D < 64 ? D : 64) * 2;
}

// consumer warpgroups: two for a q tile above 64 rows
__host__ __device__ constexpr int warpgroups(int bq) {
  return bq > kRows ? 2 : 1;
}

// Threads of a block.  One consumer warpgroup: 160, the producer warp
// beside it, and every thread may hold 255 registers.  Two: 384, the
// producer warp in a warpgroup of its own, so that setmaxnreg can move
// registers from it (24 a thread) to the consumers (240 a thread); with
// nine warps the compiler would hold every thread to 168, and it then
// serialises the wgmmas.
__host__ __device__ constexpr int block_threads(int nwg) {
  return nwg == 2 ? 384 : 160;
}
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

struct Plan {
  int nwg, stages;
  size_t smem;
};

// Shared memory: 1024 bytes of alignment slack, one pass of q rows,
// `stages` slots of one K and one V sub-tile, and the barriers.  As many
// slots as fit, up to two pieces' worth; at least one piece's worth (nsub
// slots), or the plan does not fit (smem > kMaxSmem).
__host__ inline Plan plan(int D, int bq, int bkc) {
  Plan p;
  p.nwg = warpgroups(bq);
  const int n = sub_keys(bkc), nsub = bkc / n;
  const size_t q_bytes = (size_t)kRows * p.nwg * D * 2;
  const size_t kv_bytes = (size_t)n * D * 2;   // one K (or V) sub-tile
  for (p.stages = 2 * nsub > 2 ? 2 * nsub : 2; ; --p.stages) {
    p.smem = 1024 + q_bytes + 2 * kv_bytes * p.stages + 8 * (2 + 3 * p.stages);
    if (p.smem <= kMaxSmem || p.stages == nsub) break;
  }
  return p;
}

// KV tiles [lo, hi) that hold a key some row in [p0, last] keeps; all of
// them if a row keeps no key at all
__device__ __forceinline__ void tile_range(int p0, int last, int Sk, int bk,
                                           int causal, int window, int& lo,
                                           int& hi) {
  const int n_kt = Sk / bk;
  lo = 0;
  hi = n_kt;
  const bool empty_row = window > 0 && last - window + 1 > Sk - 1;
  if (!empty_row) {
    if (window > 0) lo = max(0, p0 - window + 1) / bk;
    if (causal) hi = min(n_kt, last / bk + 1);
  }
}

// p = hi + lo with hi = bf16(p), lo = bf16(p - hi), for two columns
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// grid (Sq / bq, Hq, B); block block_threads(NWG).  Maps: q (D, Sq,
// Hq, B) in boxes of (SW/2, 64); k and v (D, Sk, Hkv, B) in boxes of
// (SW/2, N), SW = row_bytes(D).  BK > 0: tiles of BK keys, each one
// piece, all known to the compiler (with the tile's size known only at
// run time the kernel measured slower at the prefill shapes: PERF.md);
// BK = 0: tiles of bk keys in 64-key pieces.
template <int D, int BK, int NWG>
__global__ void __launch_bounds__(block_threads(NWG), 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ o,
    int Sk, int G, int bq, int bk, int causal, int window, int stages,
    int64_t o_sb, int64_t o_sh, int64_t o_ss, float scale_log2) {
  constexpr int BKC = piece_width(BK);
  constexpr int N = sub_keys(BKC);
  constexpr int NSUB = BKC / N;
  constexpr int SW = row_bytes(D);
  constexpr int SWZ = hopper::desc_swizzle(SW);
  constexpr int KPA = SW / 32;               // k16 steps across one row
  constexpr int HALVES = D * 2 / SW;         // 128-byte column blocks
  constexpr int PASS = kRows * NWG;          // q rows per pass
  constexpr uint32_t Q_BYTES = PASS * D * 2;
  constexpr uint32_t KV_BYTES = N * D * 2;
  constexpr uint32_t BOX_Q = kRows * SW;     // one (SW/2, 64) q box
  constexpr uint32_t BOX_KV = N * SW;        // one (SW/2, N) k or v box

  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* kv_s = q_s + Q_BYTES;             // slot s: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + 2 * KV_BYTES * stages);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;
  uint64_t* v_full = k_full + stages;
  uint64_t* empty = v_full + stages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / G;
  const int q0 = qt * bq, q_end = q0 + bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = BK ? BK : bk;               // keys of a KV tile

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * NWG);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(k_full + s, 1);
      hopper::mbar_init(v_full + s, 1);
      hopper::mbar_init(empty + s, 4 * NWG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: per pass its q rows, then K and V sub-tiles in order
    if constexpr (NWG == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * NWG || lane != 0) return;
    int it = 0, pass = 0;
    for (int p0 = q0; p0 < q_end; p0 += PASS, ++pass) {
      if (pass > 0) hopper::mbar_wait(q_empty, (pass - 1) & 1);
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      for (int r = 0; r < NWG; ++r)
        for (int hf = 0; hf < HALVES; ++hf)
          hopper::tma_load_4d(q_s + (r * HALVES + hf) * BOX_Q, &qmap, q_full,
                              hf * (SW / 2), p0 + r * kRows, h, b);
      int lo, hi;
      tile_range(p0, min(p0 + PASS, q_end) - 1, Sk, tile, causal, window,
                 lo, hi);
      for (int t = lo; t < hi; ++t)
        for (int c0 = t * tile; c0 < (t + 1) * tile; c0 += BKC)
          for (int j = 0; j < NSUB; ++j, ++it) {
            const int s = it % stages, use = it / stages;
            if (use > 0) hopper::mbar_wait(empty + s, (use - 1) & 1);
            uint8_t* ks = kv_s + s * 2 * KV_BYTES;
            const int key0 = c0 + j * N;
            hopper::mbar_expect_tx(k_full + s, KV_BYTES);
            for (int hf = 0; hf < HALVES; ++hf)
              hopper::tma_load_4d(ks + hf * BOX_KV, &kmap, k_full + s,
                                  hf * (SW / 2), key0, hkv, b);
            hopper::mbar_expect_tx(v_full + s, KV_BYTES);
            for (int hf = 0; hf < HALVES; ++hf)
              hopper::tma_load_4d(ks + KV_BYTES + hf * BOX_KV, &vmap,
                                  v_full + s, hf * (SW / 2), key0, hkv, b);
          }
    }
    return;
  }

  // ---- consumers: warpgroup wgi holds q rows [64 wgi, 64 wgi + 64) of
  // each pass; this thread rows r_in and r_in + 8 of them ----
  if constexpr (NWG == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wgi = warp / 4;
  const int r_in = (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;       // first of its 2 columns per 8
  const uint32_t q_addr = hopper::smem_u32(q_s) + wgi * HALVES * BOX_Q;

  int it = 0, pass = 0;
  for (int p0 = q0; p0 < q_end; p0 += PASS, ++pass) {
    int lo, hi;
    tile_range(p0, min(p0 + PASS, q_end) - 1, Sk, tile, causal, window, lo,
               hi);
    const int w0 = p0 + wgi * kRows;          // first q row of the tile
    const int qpos[2] = {w0 + r_in, w0 + r_in + 8};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, pass & 1);

    // the pieces of each tile in [lo, hi): BKC keys loaded from c0, the
    // first `valid` of them in the tile
    for (int t = lo; t < hi; ++t) {
      const int t_end = (t + 1) * tile;
      for (int c0 = t * tile; c0 < t_end; c0 += BKC) {
        const int valid = min(BKC, t_end - c0);
        // S = Q . K^T for the piece's NSUB sub-tiles
        float s[NSUB][N / 2];
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          hopper::mbar_wait(k_full + (it + j) % stages,
                            ((it + j) / stages) & 1);
#pragma unroll
        for (int j = 0; j < NSUB; ++j) hopper::fence_regs(s[j]);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const uint32_t k_addr =
              hopper::smem_u32(kv_s + ((it + j) % stages) * 2 * KV_BYTES);
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            Wgmma<N>::ss(
                s[j],
                hopper::make_desc(
                    q_addr + (kk / KPA) * BOX_Q + (kk % KPA) * 32, 16,
                    8 * SW, SWZ),
                hopper::make_desc(
                    k_addr + (kk / KPA) * BOX_KV + (kk % KPA) * 32, 16,
                    8 * SW, SWZ),
                kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < NSUB; ++j) hopper::fence_regs(s[j]);

        // scale, mask, and the online softmax over the whole piece
        const bool kept_all = (!causal || c0 + BKC - 1 <= w0) &&
                              (!window || c0 > w0 + kRows - 1 - window);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < N / 2; ++e) {
            const int i = (e / 2) % 2;
            float x = s[j][e] * scale_log2;
            if (!kept_all) {
              const int key = c0 + j * N + (e / 4) * 8 + cq + e % 2;
              bool keep = true;
              if (causal) keep = key <= qpos[i];
              if (window) keep = keep && key > qpos[i] - window;
              if (!keep) x = kNegInf;
            }
            s[j][e] = x;
          }
        if (valid < BKC) {   // keys past the tile: -inf, so p = 0
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
#pragma unroll
            for (int e = 0; e < N / 2; ++e)
              if (j * N + (e / 4) * 8 + cq + e % 2 >= valid)
                s[j][e] = -CUDART_INF_F;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < N / 2; ++e)
            mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[j][e]);
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          alpha[i] = exp2f(m[i] - mx[i]);
          m[i] = mx[i];
        }
        float sum[2] = {0.f, 0.f};
        uint32_t p_hi[NSUB][N / 16][4], p_lo[NSUB][N / 16][4];
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
#pragma unroll
          for (int e = 0; e < N / 2; ++e) {
            const int i = (e / 2) % 2;
            s[j][e] = exp2f(s[j][e] - m[i]);
            sum[i] += s[j][e];
          }
          // keys [16 ks, 16 ks + 16) of the sub-tile: accumulator columns
          // 8-blocks 2 ks and 2 ks + 1, i.e. s[j][8 ks .. 8 ks + 8)
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              split2(s[j][8 * ks + 2 * r], s[j][8 * ks + 2 * r + 1],
                     p_hi[j][ks][r], p_lo[j][ks][r]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e / 2) % 2];

        // acc += p_hi . V + p_lo . V
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
          hopper::mbar_wait(v_full + (it + j) % stages,
                            ((it + j) / stages) & 1);
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const uint32_t v_addr = hopper::smem_u32(
              kv_s + ((it + j) % stages) * 2 * KV_BYTES + KV_BYTES);
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            const uint64_t vd = hopper::make_desc(v_addr + ks * 16 * SW,
                                                  BOX_KV, 8 * SW, SWZ);
            Wgmma<D>::rs_tb(acc, p_hi[j][ks], vd);
            Wgmma<D>::rs_tb(acc, p_lo[j][ks], vd);
          }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            hopper::fence_regs(p_hi[j][ks]);
            hopper::fence_regs(p_lo[j][ks]);
          }
        if (lane == 0)
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
            hopper::mbar_arrive(empty + (it + j) % stages);
        it += NSUB;
      }
    }
    if (lane == 0) hopper::mbar_arrive(q_empty);   // q read for the pass

    // o = acc / max(l, 1e-30); l summed over the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (qpos[i] >= q_end) continue;
      const float li = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* orow = o + b * o_sb + h * o_sh + (int64_t)qpos[i] * o_ss;
#pragma unroll
      for (int cb = 0; cb < D / 8; ++cb)
        *reinterpret_cast<__nv_bfloat162*>(orow + cb * 8 + cq) =
            __floats2bfloat162_rn(acc[cb * 4 + 2 * i] / li,
                                  acc[cb * 4 + 2 * i + 1] / li);
    }
  }
}

template <int D, int BK, int NWG>
int launch(const CUtensorMap maps[3], void* o, int B, int Hq, int G, int Sq,
           int Sk, int bq, int bk, int causal, int window, const int64_t* st,
           float scale, const Plan& p, cudaStream_t stream) {
  auto kernel = flash_fwd_wgmma_kernel<D, BK, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Sq / bq, Hq, B);
  kernel<<<grid, block_threads(NWG), p.smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), Sk, G, bq,
      bk, causal, window, p.stages, st[9], st[10], st[11], scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D, int BK>
int dispatch_nwg(const CUtensorMap maps[3], void* o, int B, int Hq, int G,
                 int Sq, int Sk, int bq, int bk, int causal, int window,
                 const int64_t* st, float scale, const Plan& p,
                 cudaStream_t stream) {
  if (p.nwg == 2)
    return launch<D, BK, 2>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                            window, st, scale, p, stream);
  return launch<D, BK, 1>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal, window,
                          st, scale, p, stream);
}

template <int D>
int dispatch_bk(const CUtensorMap maps[3], void* o, int B, int Hq, int G,
                int Sq, int Sk, int bq, int bk, int causal, int window,
                const int64_t* st, float scale, const Plan& p,
                cudaStream_t stream) {
  // only the instances kernel_bk can give at D are compiled (two at D = 256)
  switch (kernel_bk(D, bk)) {
#define REPRO_WG_BK(BB)                                                      \
  case BB:                                                                   \
    if constexpr (kernel_bk(D, BB) == BB)                                    \
      return dispatch_nwg<D, BB>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,  \
                                 window, st, scale, p, stream);              \
    break;
    REPRO_WG_BK(32)
    REPRO_WG_BK(64)
    REPRO_WG_BK(128)
    REPRO_WG_BK(0)
#undef REPRO_WG_BK
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

bool supported(int D, int bq, int bk) {
  return (D == 32 || D == 64 || D == 128 || D == 256) && bq >= 1 && bk >= 1;
}

int run(int D, const void* q, const void* k, const void* v, void* o, int B,
        int Hq, int G, int Sq, int Sk, int bq, int bk, int causal,
        int window, const int64_t* st, float scale, cudaStream_t stream) {
  if (!supported(D, bq, bk)) return (int)cudaErrorInvalidValue;
  const int bkc = piece_width(kernel_bk(D, bk));
  const Plan p = plan(D, bq, bkc);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int box = row_bytes(D) / 2;
  const int64_t qdims[4] = {D, Sq, Hq, B}, kdims[4] = {D, Sk, Hq / G, B};
  const int64_t qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                vs[3] = {st[8], st[7], st[6]};
  CUtensorMap maps[3];
  int rc = hopper::make_map_bf16_4d(&maps[0], q, qdims, qs, box, kRows);
  if (!rc) rc = hopper::make_map_bf16_4d(&maps[1], k, kdims, ks, box,
                                         sub_keys(bkc));
  if (!rc) rc = hopper::make_map_bf16_4d(&maps[2], v, kdims, vs, box,
                                         sub_keys(bkc));
  if (rc) return rc;
  switch (D) {
    case 32:
      return dispatch_bk<32>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                              window, st, scale, p, stream);
    case 64:
      return dispatch_bk<64>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                              window, st, scale, p, stream);
    case 128:
      return dispatch_bk<128>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, p, stream);
    default:
      return dispatch_bk<256>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, p, stream);
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: flash_fwd_tf32_kernel
// ---------------------------------------------------------------------------
namespace tf {

using hopper::WgmmaTf32;

constexpr int kRows = 64;                     // q rows of one warpgroup
constexpr size_t kMaxSmem = 232448;           // bytes a block can use
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSyncId = 1;                    // named barrier of the consumers

// Keys per softmax update (the kernel's piece, BKC): bk where it is 32, 64
// or 128; 128-key pieces of a bk that is a multiple of 128; 64-key pieces
// of any other bk (the last piece of a tile padded past it).  D = 256:
// 32 at bk = 32, else 64-key pieces (shared memory; see the header).
__host__ __device__ constexpr int piece_width(int D, int bk) {
  return D == 256 ? (bk == 32 ? 32 : 64)
         : bk == 32 || bk == 64 ? bk : bk % 128 == 0 ? 128 : 64;
}
// keys per K or V sub-tile: 32 at D = 128 (shared memory), else the piece
// up to 64 (at D = 256 a slot holds the piece's keys of 32 columns of D)
__host__ __device__ constexpr int sub_keys(int D, int bkc) {
  return D == 128 ? 32 : bkc < 64 ? bkc : 64;
}
// consumer warpgroups: two for a q tile above 64 rows, and always two at
// D = 256 (they share a pass's 64 rows and split D)
__host__ __device__ constexpr int warpgroups(int D, int bq) {
  return D == 256 || bq > kRows ? 2 : 1;
}
__host__ __device__ constexpr int block_threads(int nwg) {
  return nwg == 2 ? 384 : 160;
}
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages256 = 4;                 // ring slots at D = 256

struct Plan {
  int nwg, stages;
  size_t smem;
};

// Shared memory: 1024 bytes of alignment slack, one pass of q rows twice
// (the TMA tile, rounded in place to big, and small), `stages` slots of
// one K or V sub-tile twice (see the header), and the barriers.  As many
// slots as fit, up to two pieces' K and V; at least two.  D = 256: a pass
// is 64 rows (128 KB), a slot 2048 floats twice, and the two warpgroups'
// partial scores of a piece sit beside the ring of kStages256 slots: as
// the producer alternates between the warpgroups, each keeps two (it
// frees a slot once its next one is issued); a fifth fits only beside
// 32-key pieces' partial scores, and ran no faster there.
__host__ inline Plan plan(int D, int bq, int bkc) {
  Plan p;
  p.nwg = warpgroups(D, bq);
  if (D == 256) {
    p.stages = kStages256;
    p.smem = 1024 + 2 * (size_t)kRows * D * 4 + 2 * 2048 * 4 * p.stages +
             2 * (size_t)kRows * bkc * 4 + 8 * (2 + 2 * p.stages);
    return p;
  }
  const int n = sub_keys(D, bkc), nsub = bkc / n;
  const size_t q_bytes = 2 * (size_t)kRows * p.nwg * D * 4;
  const size_t slot = 2 * (size_t)n * D * 4;
  for (p.stages = 4 * nsub; ; --p.stages) {
    p.smem = 1024 + q_bytes + slot * p.stages + 8 * (2 + 2 * p.stages);
    if (p.smem <= kMaxSmem || p.stages == 2) break;
  }
  return p;
}

// Every float of `n4` float4s at t split: big in place, small at sm; the
// consumer thread i of NT takes float4s i, i + NT, ... (the swizzle moves
// whole 16-byte pieces, so the layout is kept)
template <int N4, int NT>
__device__ __forceinline__ void split_tile(uint8_t* t, uint8_t* sm, int i) {
  float4* a = reinterpret_cast<float4*>(t);
  uint4* s = reinterpret_cast<uint4*>(sm);
#pragma unroll 4
  for (int c = i; c < N4; c += NT) {
    const float4 x = a[c];
    uint4 big, small;
    hopper::split_tf32(x.x, big.x, small.x);
    hopper::split_tf32(x.y, big.y, small.y);
    hopper::split_tf32(x.z, big.z, small.z);
    hopper::split_tf32(x.w, big.w, small.w);
    reinterpret_cast<uint4*>(a)[c] = big;
    s[c] = small;
  }
}

// The V sub-tile of a slot, N keys x D as TMA wrote it (D/32 column blocks
// of N 128-byte rows, swizzled), becomes V^T big in the slot's second half
// and V^T small over the first: D rows of the sub-tile's keys, K-major,
// column blocks of 32 keys (D 128-byte rows each, swizzled), each 8-key
// group in the key order (0, 2, 4, 6, 1, 3, 5, 7) of the A fragments that
// p is (see the header).  Consumer thread i reads keys lane by lane, so
// neither the reads nor the 4-byte writes conflict in a bank.
template <int D, int N, int NT>
__device__ __forceinline__ void split_v(uint8_t* vs, int i) {
  constexpr int ITEMS = N * D / 4 / NT;       // float4s a thread
  constexpr uint32_t HALF = N * D * 4;
  float4 x[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int idx = i + u * NT, r = idx % N, dg = idx / N;
    x[u] = *reinterpret_cast<const float4*>(
        vs + (dg / 8) * (N * 128) + r * 128 + (((dg % 8) ^ (r % 8)) << 4));
  }
  hopper::named_sync<kSyncId, NT>();   // the raw tile is overwritten below
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int idx = i + u * NT, r = idx % N, dg = idx / N;
    const int pos = (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1);
    const int pp = pos % 32;
    uint8_t* col = vs + (pos / 32) * (D * 128) + (pp % 4) * 4;
    const float e[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = 4 * dg + c;
      const uint32_t off = d * 128 + (((pp / 4) ^ (d % 8)) << 4);
      uint32_t big, small;
      hopper::split_tf32(e[c], big, small);
      *reinterpret_cast<uint32_t*>(col + HALF + off) = big;
      *reinterpret_cast<uint32_t*>(col + off) = small;
    }
  }
}

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) {
  return hopper::make_desc(addr, 16, 8 * 128, hopper::desc_swizzle(128));
}

// x, opaque to the compiler: descriptors derived from it are formed where
// they are used instead of being hoisted out of the loop and held in
// registers (at D = 256, q's 32 of them spilled)
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// D <= 128: each consumer warpgroup holds its own 64 q rows of a pass.
// Maps: q (D, Sq, Hq, B) in boxes of (32, 64); k and v (D, Sk, Hkv, B) in
// boxes of (32, N).  BKC: keys per piece (piece_width); tiles of bk keys.
template <int D, int BKC, int NWG>
__device__ __forceinline__ void tf32_rows(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    float* __restrict__ o, int Sk, int G, int bq, int bk, int causal,
    int window, int stages, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale_log2) {
  constexpr int N = sub_keys(D, BKC);
  constexpr int NSUB = BKC / N;
  constexpr int CB = D / 32;                 // 128-byte column blocks of a row
  constexpr int PASS = kRows * NWG;          // q rows per pass
  constexpr int NT = 128 * NWG;              // consumer threads
  constexpr uint32_t Q_BYTES = PASS * D * 4;
  constexpr uint32_t HALF = N * D * 4;       // one K or V sub-tile
  constexpr uint32_t BOX_Q = kRows * 128;    // one (32, 64) q box
  constexpr uint32_t BOX_KV = N * 128;       // one (32, N) k or v box
  constexpr uint32_t BOX_VT = D * 128;       // 32 keys of V^T

  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* slots = q_s + 2 * Q_BYTES;        // q big, q small, then the ring
  uint64_t* q_full = reinterpret_cast<uint64_t*>(slots + 2 * HALF * stages);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + stages;

  const int qt = gridDim.x - 1 - blockIdx.x;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z, hkv = h / G;
  const int q0 = qt * bq, q_end = q0 + bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 4 * NWG);
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * NWG);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // ---- producer: per pass its q rows, then per piece the K sub-tiles
    // and the V sub-tiles, one ring slot each, in the consumers' order
    if constexpr (NWG == 2) hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != 4 * NWG || lane != 0) return;
    int it = 0, pass = 0;
    for (int p0 = q0; p0 < q_end; p0 += PASS, ++pass) {
      if (pass > 0) hopper::mbar_wait(q_empty, (pass - 1) & 1);
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      for (int r = 0; r < NWG; ++r)
        for (int cb = 0; cb < CB; ++cb)
          hopper::tma_load_4d(q_s + (r * CB + cb) * BOX_Q, &qmap, q_full,
                              cb * 32, p0 + r * kRows, h, b);
      int lo, hi;
      wg::tile_range(p0, min(p0 + PASS, q_end) - 1, Sk, bk, causal, window,
                     lo, hi);
      for (int t = lo; t < hi; ++t)
        for (int c0 = t * bk; c0 < (t + 1) * bk; c0 += BKC)
          for (int kv = 0; kv < 2; ++kv)
            for (int j = 0; j < NSUB; ++j, ++it) {
              const int s = it % stages, use = it / stages;
              if (use > 0) hopper::mbar_wait(empty + s, (use - 1) & 1);
              uint8_t* dst = slots + s * 2 * HALF;
              hopper::mbar_expect_tx(full + s, HALF);
              for (int cb = 0; cb < CB; ++cb)
                hopper::tma_load_4d(dst + cb * BOX_KV, kv ? &vmap : &kmap,
                                    full + s, cb * 32, c0 + j * N, hkv, b);
            }
    }
    return;
  }

  // ---- consumers: warpgroup wgi holds q rows [64 wgi, 64 wgi + 64) of
  // each pass; this thread rows r_in and r_in + 8 of them ----
  if constexpr (NWG == 2) hopper::setmaxnreg_inc<kConsumerRegs>();
  const int ct = threadIdx.x;
  const int wgi = warp / 4;
  const int r_in = (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;       // first of its 2 columns per 8
  const uint32_t qb_addr = hopper::smem_u32(q_s) + wgi * CB * BOX_Q;
  const uint32_t qs_addr = qb_addr + Q_BYTES;

  int it = 0, pass = 0;
  for (int p0 = q0; p0 < q_end; p0 += PASS, ++pass) {
    int lo, hi;
    wg::tile_range(p0, min(p0 + PASS, q_end) - 1, Sk, bk, causal, window, lo,
                   hi);
    const int w0 = p0 + wgi * kRows;          // first q row of the tile
    const int qpos[2] = {w0 + r_in, w0 + r_in + 8};

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, pass & 1);
    split_tile<PASS * D / 4, NT>(q_s, q_s + Q_BYTES, ct);
    hopper::fence_proxy_async();
    hopper::named_sync<kSyncId, NT>();

    // the pieces of each tile in [lo, hi): BKC keys loaded from c0, the
    // first `valid` of them in the tile
    for (int t = lo; t < hi; ++t) {
      for (int c0 = t * bk; c0 < (t + 1) * bk; c0 += BKC) {
        const int valid = min(BKC, (t + 1) * bk - c0);
        // S = Q.K^T = Qb.Kb + Qb.Ks + Qs.Kb, one sub-tile at a time: split
        // it, issue its wgmmas, then free the previous sub-tile's slot
        float s[NSUB][N / 2];
#pragma unroll
        for (int j = 0; j < NSUB; ++j, ++it) {
          const int slot = it % stages;
          hopper::mbar_wait(full + slot, (it / stages) & 1);
          uint8_t* ks = slots + slot * 2 * HALF;
          split_tile<N * D / 4, NT>(ks, ks + HALF, ct);
          hopper::fence_proxy_async();
          hopper::named_sync<kSyncId, NT>();
          const uint32_t kb_addr = hopper::smem_u32(ks);
          const uint32_t ks_addr = kb_addr + HALF;
          hopper::fence_regs(s[j]);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) {
            const uint32_t qo = (kk / 4) * BOX_Q + (kk % 4) * 32;
            const uint32_t ko = (kk / 4) * BOX_KV + (kk % 4) * 32;
            WgmmaTf32<N>::ss(s[j], kmajor(qb_addr + qo), kmajor(kb_addr + ko),
                             kk > 0);
            WgmmaTf32<N>::ss(s[j], kmajor(qb_addr + qo), kmajor(ks_addr + ko),
                             1);
            WgmmaTf32<N>::ss(s[j], kmajor(qs_addr + qo), kmajor(kb_addr + ko),
                             1);
          }
          hopper::wgmma_commit();
          if (j > 0) {
            hopper::wgmma_wait<1>();
            if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % stages);
          }
        }
        hopper::wgmma_wait<0>();
        if (lane == 0) hopper::mbar_arrive(empty + (it - 1) % stages);
#pragma unroll
        for (int j = 0; j < NSUB; ++j) hopper::fence_regs(s[j]);

        // scale, mask, and the online softmax over the whole piece
        const bool kept_all = (!causal || c0 + BKC - 1 <= w0) &&
                              (!window || c0 > w0 + kRows - 1 - window);
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < N / 2; ++e) {
            const int i = (e / 2) % 2;
            float x = s[j][e] * scale_log2;
            if (!kept_all) {
              const int key = c0 + j * N + (e / 4) * 8 + cq + e % 2;
              bool keep = true;
              if (causal) keep = key <= qpos[i];
              if (window) keep = keep && key > qpos[i] - window;
              if (!keep) x = kNegInf;
            }
            s[j][e] = x;
          }
        if (valid < BKC) {   // keys past the tile: -inf, so p = 0
#pragma unroll
          for (int j = 0; j < NSUB; ++j)
#pragma unroll
            for (int e = 0; e < N / 2; ++e)
              if (j * N + (e / 4) * 8 + cq + e % 2 >= valid)
                s[j][e] = -CUDART_INF_F;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < N / 2; ++e)
            mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[j][e]);
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          alpha[i] = exp2f(m[i] - mx[i]);
          m[i] = mx[i];
        }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NSUB; ++j)
#pragma unroll
          for (int e = 0; e < N / 2; ++e) {
            const int i = (e / 2) % 2;
            s[j][e] = exp2f(s[j][e] - m[i]);
            sum[i] += s[j][e];
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

        // pv = P.V = Pb.Vb + Pb.Vs + Ps.Vb over the piece, one sub-tile at a
        // time, in an accumulator of its own (see the header).  The
        // accumulator of keys 8 ks + (2q, 2q + 1) in rows (r, r + 8) is the A
        // fragment of V^T's key positions (q, q + 4).  A sub-tile's Pb and
        // Ps live until its wgmmas have run: waiting for them before the
        // next sub-tile's split keeps one sub-tile's worth in registers
        // (with two in flight more instances spilled, and every domain
        // block and the prefill shape ran slower).
        float pv[D / 2];
        hopper::fence_regs(pv);
#pragma unroll
        for (int j = 0; j < NSUB; ++j, ++it) {
          const int slot = it % stages;
          hopper::mbar_wait(full + slot, (it / stages) & 1);
          uint8_t* vs = slots + slot * 2 * HALF;
          split_v<D, N, NT>(vs, ct);
          hopper::fence_proxy_async();
          hopper::named_sync<kSyncId, NT>();
          uint32_t pb[N / 8][4], ps[N / 8][4];
#pragma unroll
          for (int ks = 0; ks < N / 8; ++ks) {
            const float* x = &s[j][4 * ks];
            hopper::split_tf32(x[0], pb[ks][0], ps[ks][0]);  // r, 2q
            hopper::split_tf32(x[2], pb[ks][1], ps[ks][1]);  // r+8, 2q
            hopper::split_tf32(x[1], pb[ks][2], ps[ks][2]);  // r, 2q+1
            hopper::split_tf32(x[3], pb[ks][3], ps[ks][3]);  // r+8, 2q+1
          }
          hopper::wgmma_fence();
          const uint32_t vb_addr = hopper::smem_u32(vs) + HALF;
          const uint32_t vsm_addr = hopper::smem_u32(vs);
#pragma unroll
          for (int ks = 0; ks < N / 8; ++ks) {
            const uint32_t vo = (ks / 4) * BOX_VT + (ks % 4) * 32;
            const uint32_t(&big)[4] = pb[ks];
            const uint32_t(&sml)[4] = ps[ks];
            WgmmaTf32<D>::rs(pv, big[0], big[1], big[2], big[3],
                             kmajor(vb_addr + vo), j > 0 || ks > 0);
            WgmmaTf32<D>::rs(pv, big[0], big[1], big[2], big[3],
                             kmajor(vsm_addr + vo), 1);
            WgmmaTf32<D>::rs(pv, sml[0], sml[1], sml[2], sml[3],
                             kmajor(vb_addr + vo), 1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
#pragma unroll
          for (int ks = 0; ks < N / 8; ++ks) {
            hopper::fence_regs(pb[ks]);
            hopper::fence_regs(ps[ks]);
          }
          if (lane == 0) hopper::mbar_arrive(empty + slot);
        }
        hopper::fence_regs(pv);
#pragma unroll
        for (int e = 0; e < D / 2; ++e)
          acc[e] = fmaf(acc[e], alpha[(e / 2) % 2], pv[e]);
      }
    }
    if (lane == 0) hopper::mbar_arrive(q_empty);   // q read for the pass

    // o = acc / max(l, 1e-30); l summed over the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (qpos[i] >= q_end) continue;
      const float li = fmaxf(l[i], 1e-30f);
      float* orow = o + b * o_sb + h * o_sh + (int64_t)qpos[i] * o_ss;
#pragma unroll
      for (int cb = 0; cb < D / 8; ++cb)
        *reinterpret_cast<float2*>(orow + cb * 8 + cq) =
            make_float2(acc[cb * 4 + 2 * i] / li, acc[cb * 4 + 2 * i + 1] / li);
    }
  }
}

// D = 256, a V slot: 32 keys x 64 columns as TMA wrote them (two column
// blocks of 32 keys' 128-byte rows, swizzled) becomes V^T big in the
// slot's second half and V^T small over the first: 64 rows of the 32
// keys, K-major, one column block, each 8-key group in the key order (0,
// 2, 4, 6, 1, 3, 5, 7) of the A fragments that p is (as split_v lays it
// out).  Thread i of the warpgroup moves keys (par, par + 2, par + 4,
// par + 6) of 8-key group g8 in the four columns of float4 dg: four
// 16-byte reads, then per column one 16-byte write of big and one of
// small.  The lanes are laid out so that no read or write conflicts in a
// bank.  The warpgroup meets at named barrier `bar`.
__device__ __forceinline__ void split_vt(uint8_t* vs, int i, int bar) {
  constexpr uint32_t HALF = 32 * 64 * 4;
  const int x = i % 8, t = i / 8;
  const int g8 = x >> 1, par = x & 1;
  const int dg = 2 * ((g8 + (t >> 1)) & 3) + (t & 1) + 8 * (t >> 3);
  float4 r[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = 8 * g8 + par + 2 * j;
    r[j] = *reinterpret_cast<const float4*>(
        vs + (dg / 8) * 4096 + row * 128 + (((dg % 8) ^ (row % 8)) << 4));
  }
  hopper::named_sync<128>(bar);   // the raw tile is overwritten below
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int d = 4 * dg + c;
    const uint32_t off = d * 128 + (((2 * g8 + par) ^ (d % 8)) << 4);
    const float e[4] = {(&r[0].x)[c], (&r[1].x)[c], (&r[2].x)[c],
                        (&r[3].x)[c]};
    uint4 big, small;
    hopper::split_tf32(e[0], big.x, small.x);
    hopper::split_tf32(e[1], big.y, small.y);
    hopper::split_tf32(e[2], big.z, small.z);
    hopper::split_tf32(e[3], big.w, small.w);
    *reinterpret_cast<uint4*>(vs + HALF + off) = big;
    *reinterpret_cast<uint4*>(vs + off) = small;
  }
}

// D = 256: the two consumer warpgroups share each pass's 64 q rows, and
// warpgroup w owns columns [128 w, 128 w + 128) of D (see the header).
// Maps: q (D, Sq, Hq, B) in boxes of (32, 64); k (D, Sk, Hkv, B) in boxes
// of (32, BKC), v in boxes of (32, 32).  Tiles of bk keys in pieces of
// BKC (32 or 64).  A slot holds 2048 floats: KCB column blocks of the
// piece's keys of K, or 32 keys of a 64-column pair of V.
template <int BKC>
__device__ __forceinline__ void tf32_cols(
    const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
    float* __restrict__ o, int Sk, int G, int bq, int bk, int causal,
    int window, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale_log2) {
  constexpr int D = 256, ST = kStages256;
  constexpr int CB = D / 32;                 // 128-byte column blocks of a row
  constexpr int CBW = CB / 2;                // of them, one warpgroup's
  constexpr int KCB = 64 / BKC;              // column blocks of a K slot
  constexpr int KU = CBW / KCB;              // a warpgroup's K slots a piece
  constexpr int VH = BKC / 32;               // 32-key halves of a piece
  constexpr int VU = 2 * VH;                 // a warpgroup's V slots a piece
  constexpr int NT = 128;                    // threads of a warpgroup
  constexpr int XN = BKC / 2;                // a thread's scores of a piece
  constexpr uint32_t Q_BYTES = kRows * D * 4;
  constexpr uint32_t BOX_Q = kRows * 128;    // one (32, 64) q box
  constexpr uint32_t BOX_K = BKC * 128;      // one (32, BKC) k box
  constexpr uint32_t BOX_V = 32 * 128;       // one (32, 32) v box
  constexpr uint32_t HALF = 2048 * 4;        // a slot's TMA bytes

  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* slots = q_s + 2 * Q_BYTES;        // q big, q small, then the ring
  float4* xchg = reinterpret_cast<float4*>(slots + 2 * HALF * ST);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(xchg + 2 * (XN / 4) * NT);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_empty + 1;
  uint64_t* empty = full + ST;

  const int qt = gridDim.x - 1 - blockIdx.x;   // most keys first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq, q_end = q0 + bq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 8);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);       // one warpgroup reads a slot
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: per pass its q rows, then per piece the K slots and
    // the V slots, the two warpgroups' in turn: use u of K (or of V) is
    // warpgroup u % 2's slot u / 2
    hopper::setmaxnreg_dec<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    const int hkv = h / G;
    int it = 0, pass = 0;
    for (int p0 = q0; p0 < q_end; p0 += kRows, ++pass) {
      if (pass > 0) hopper::mbar_wait(q_empty, (pass - 1) & 1);
      hopper::mbar_expect_tx(q_full, Q_BYTES);
      for (int cb = 0; cb < CB; ++cb)
        hopper::tma_load_4d(q_s + cb * BOX_Q, &qmap, q_full, cb * 32, p0, h,
                            b);
      int lo, hi;
      wg::tile_range(p0, min(p0 + kRows, q_end) - 1, Sk, bk, causal, window,
                     lo, hi);
      for (int t = lo; t < hi; ++t)
        for (int c0 = t * bk; c0 < (t + 1) * bk; c0 += BKC)
          for (int u = 0; u < 2 * (KU + VU); ++u, ++it) {
            const int s = it % ST, lap = it / ST;
            if (lap > 0) hopper::mbar_wait(empty + s, (lap - 1) & 1);
            hopper::mbar_expect_tx(full + s, HALF);
            uint8_t* dst = slots + s * 2 * HALF;
            if (u < 2 * KU) {    // K: w's column blocks KCB (u / 2) ..
              const int col = 128 * (u % 2) + 32 * KCB * (u / 2);
              for (int j = 0; j < KCB; ++j)
                hopper::tma_load_4d(dst + j * BOX_K, &kmap, full + s,
                                    col + 32 * j, c0, hkv, b);
            } else {             // V: w's pair v / VH, keys 32 (v % VH) on
              const int v = (u - 2 * KU) / 2;
              const int col = 128 * (u % 2) + 64 * (v / VH);
              const int key = c0 + 32 * (v % VH);
              hopper::tma_load_4d(dst, &vmap, full + s, col, key, hkv, b);
              hopper::tma_load_4d(dst + BOX_V, &vmap, full + s, col + 32, key,
                                  hkv, b);
            }
          }
    }
    return;
  }

  // ---- consumers: warpgroup wgi holds columns [128 wgi, 128 wgi + 128)
  // of D for all 64 q rows of a pass; this thread rows r_in and r_in + 8
  hopper::setmaxnreg_inc<kConsumerRegs>();
  const int wgi = warp / 4, ct = threadIdx.x % NT;
  const int bar = kSyncId + 1 + wgi;   // named barrier of this warpgroup
  const int r_in = (warp % 4) * 16 + lane / 4;
  const int cq = (lane % 4) * 2;       // first of its 2 columns per 8
  uint8_t* q_mine = q_s + wgi * CBW * BOX_Q;
  const uint32_t qb_addr = hopper::smem_u32(q_mine);
  const uint32_t qs_addr = qb_addr + Q_BYTES;
  float4* x_mine = xchg + wgi * (XN / 4) * NT;
  const float4* x_other = xchg + (1 - wgi) * (XN / 4) * NT;

  int it = 0, pass = 0;    // slot uses so far (both warpgroups'), passes
  for (int p0 = q0; p0 < q_end; p0 += kRows, ++pass) {
    int lo, hi;
    wg::tile_range(p0, min(p0 + kRows, q_end) - 1, Sk, bk, causal, window,
                   lo, hi);
    const int qpos[2] = {p0 + r_in, p0 + r_in + 8};

    float acc[2][32];      // columns 128 wgi + 64 pair + (0 .. 63)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[u][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    hopper::mbar_wait(q_full, pass & 1);
    split_tile<CBW * BOX_Q / 16, NT>(q_mine, q_mine + Q_BYTES, ct);
    hopper::fence_proxy_async();
    hopper::named_sync<NT>(bar);

    // the pieces of each tile in [lo, hi): BKC keys loaded from c0, the
    // first `valid` of them in the tile
    for (int t = lo; t < hi; ++t) {
      for (int c0 = t * bk; c0 < (t + 1) * bk; c0 += BKC) {
        const int valid = min(BKC, (t + 1) * bk - c0);
        // this warpgroup's part of S = Q.K^T (its 128 columns of D), one
        // K slot at a time: split it, issue its wgmmas, then free the
        // previous slot.  Its slots are uses it + 2u + wgi.
        float s[XN];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const int use = it + 2 * u + wgi, slot = use % ST;
          hopper::mbar_wait(full + slot, (use / ST) & 1);
          uint8_t* ks = slots + slot * 2 * HALF;
          split_tile<HALF / 16, NT>(ks, ks + HALF, ct);
          hopper::fence_proxy_async();
          hopper::named_sync<NT>(bar);
          const uint32_t kb_addr = hopper::smem_u32(ks);
          const uint32_t ks_addr = kb_addr + HALF;
          const uint32_t qb_u = opaque(qb_addr + KCB * u * BOX_Q);
          const uint32_t qs_u = opaque(qs_addr + KCB * u * BOX_Q);
          hopper::fence_regs(s);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4 * KCB; ++kk) {
            const uint32_t qo = (kk / 4) * BOX_Q + (kk % 4) * 32;
            const uint32_t ko = (kk / 4) * BOX_K + (kk % 4) * 32;
            WgmmaTf32<BKC>::ss(s, kmajor(qb_u + qo), kmajor(kb_addr + ko),
                               u > 0 || kk > 0);
            WgmmaTf32<BKC>::ss(s, kmajor(qb_u + qo), kmajor(ks_addr + ko),
                               1);
            WgmmaTf32<BKC>::ss(s, kmajor(qs_u + qo), kmajor(kb_addr + ko),
                               1);
          }
          hopper::wgmma_commit();
          if (u > 0) {
            hopper::wgmma_wait<1>();
            if (lane == 0) hopper::mbar_arrive(empty + (use - 2) % ST);
          }
        }
        hopper::wgmma_wait<0>();
        if (lane == 0)
          hopper::mbar_arrive(empty + (it + 2 * (KU - 1) + wgi) % ST);
        hopper::fence_regs(s);
        it += 2 * KU;

        // S = the two warpgroups' parts added, in both: a + b is b + a
        // exactly, so both hold the same scores and the same softmax.  The
        // first barrier waits until the other has read the last piece's.
        hopper::named_sync<kSyncId, 2 * NT>();
#pragma unroll
        for (int j = 0; j < XN / 4; ++j)
          x_mine[j * NT + ct] =
              make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
        hopper::named_sync<kSyncId, 2 * NT>();
#pragma unroll
        for (int j = 0; j < XN / 4; ++j) {
          const float4 y = x_other[j * NT + ct];
          s[4 * j] += y.x;
          s[4 * j + 1] += y.y;
          s[4 * j + 2] += y.z;
          s[4 * j + 3] += y.w;
        }

        // scale, mask, and the online softmax over the whole piece
        const bool kept_all = (!causal || c0 + BKC - 1 <= p0) &&
                              (!window || c0 > p0 + kRows - 1 - window);
#pragma unroll
        for (int e = 0; e < XN; ++e) {
          const int i = (e / 2) % 2;
          float x = s[e] * scale_log2;
          if (!kept_all) {
            const int key = c0 + (e / 4) * 8 + cq + e % 2;
            bool keep = true;
            if (causal) keep = key <= qpos[i];
            if (window) keep = keep && key > qpos[i] - window;
            if (!keep) x = kNegInf;
          }
          s[e] = x;
        }
        if (valid < BKC) {   // keys past the tile: -inf, so p = 0
#pragma unroll
          for (int e = 0; e < XN; ++e)
            if ((e / 4) * 8 + cq + e % 2 >= valid) s[e] = -CUDART_INF_F;
        }
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int e = 0; e < XN; ++e)
          mx[(e / 2) % 2] = fmaxf(mx[(e / 2) % 2], s[e]);
        float alpha[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          alpha[i] = exp2f(m[i] - mx[i]);
          m[i] = mx[i];
        }
        float sum[2] = {0.f, 0.f};
        uint32_t pb[BKC / 8][4], ps[BKC / 8][4];
#pragma unroll
        for (int e = 0; e < XN; ++e) {
          const int i = (e / 2) % 2;
          s[e] = exp2f(s[e] - m[i]);
          sum[i] += s[e];
        }
#pragma unroll
        for (int ks = 0; ks < BKC / 8; ++ks) {   // the A fragments of p
          const float* x = &s[4 * ks];
          hopper::split_tf32(x[0], pb[ks][0], ps[ks][0]);  // r, 2q
          hopper::split_tf32(x[2], pb[ks][1], ps[ks][1]);  // r+8, 2q
          hopper::split_tf32(x[1], pb[ks][2], ps[ks][2]);  // r, 2q+1
          hopper::split_tf32(x[3], pb[ks][3], ps[ks][3]);  // r+8, 2q+1
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

        // pv = P.V = Pb.Vb + Pb.Vs + Ps.Vb for each of this warpgroup's two
        // 64-column pairs, over the piece's 32-key halves (slots v = VH
        // pair + half), in an accumulator of its own (see the header);
        // acc = acc * alpha + pv once a pair's halves have run.  A slot's
        // V^T split overlaps the previous slot's wgmmas.
        float pv[32];
#pragma unroll
        for (int v = 0; v < VU; ++v) {
          const int use = it + 2 * v + wgi, slot = use % ST;
          hopper::mbar_wait(full + slot, (use / ST) & 1);
          uint8_t* vs = slots + slot * 2 * HALF;
          split_vt(vs, ct, bar);
          hopper::fence_proxy_async();
          hopper::named_sync<NT>(bar);
          if (v > 0 && v % VH == 0) {   // pair 0 done: into acc
            hopper::wgmma_wait<0>();
            hopper::fence_regs(pv);
            if (lane == 0) hopper::mbar_arrive(empty + (use - 2) % ST);
#pragma unroll
            for (int e = 0; e < 32; ++e)
              acc[0][e] = fmaf(acc[0][e], alpha[(e / 2) % 2], pv[e]);
          }
          const uint32_t vb_addr = hopper::smem_u32(vs) + HALF;
          const uint32_t vsm_addr = hopper::smem_u32(vs);
          hopper::fence_regs(pv);
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t vo = ks * 32;
            const uint32_t(&big)[4] = pb[4 * (v % VH) + ks];
            const uint32_t(&sml)[4] = ps[4 * (v % VH) + ks];
            WgmmaTf32<64>::rs(pv, big[0], big[1], big[2], big[3],
                              kmajor(vb_addr + vo), v % VH > 0 || ks > 0);
            WgmmaTf32<64>::rs(pv, big[0], big[1], big[2], big[3],
                              kmajor(vsm_addr + vo), 1);
            WgmmaTf32<64>::rs(pv, sml[0], sml[1], sml[2], sml[3],
                              kmajor(vb_addr + vo), 1);
          }
          hopper::wgmma_commit();
          if (v % VH > 0) {    // the slot before this one (same pair) ran
            hopper::wgmma_wait<1>();
            if (lane == 0) hopper::mbar_arrive(empty + (use - 2) % ST);
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(pv);
#pragma unroll
        for (int ks = 0; ks < BKC / 8; ++ks) {
          hopper::fence_regs(pb[ks]);
          hopper::fence_regs(ps[ks]);
        }
        if (lane == 0)
          hopper::mbar_arrive(empty + (it + 2 * (VU - 1) + wgi) % ST);
#pragma unroll
        for (int e = 0; e < 32; ++e)
          acc[1][e] = fmaf(acc[1][e], alpha[(e / 2) % 2], pv[e]);
        it += 2 * VU;
      }
    }
    if (lane == 0) hopper::mbar_arrive(q_empty);   // q read for the pass

    // o = acc / max(l, 1e-30) in this warpgroup's columns; l summed over
    // the row's 4 threads
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if (qpos[i] >= q_end) continue;
      const float li = fmaxf(l[i], 1e-30f);
      float* orow =
          o + b * o_sb + h * o_sh + (int64_t)qpos[i] * o_ss + wgi * 128;
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(orow + u * 64 + j * 8 + cq) =
              make_float2(acc[u][4 * j + 2 * i] / li,
                          acc[u][4 * j + 2 * i + 1] / li);
    }
  }
}

// grid (Sq / bq, Hq, B); block block_threads(NWG).  D <= 128: tf32_rows;
// D = 256: tf32_cols (NWG = 2; a ring of kStages256 slots).
template <int D, int BKC, int NWG>
__global__ void __launch_bounds__(block_threads(NWG), 1) flash_fwd_tf32_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int Sk,
    int G, int bq, int bk, int causal, int window, int stages, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale_log2) {
  if constexpr (D == 256)
    tf32_cols<BKC>(qmap, kmap, vmap, o, Sk, G, bq, bk, causal, window, o_sb,
                   o_sh, o_ss, scale_log2);
  else
    tf32_rows<D, BKC, NWG>(qmap, kmap, vmap, o, Sk, G, bq, bk, causal,
                           window, stages, o_sb, o_sh, o_ss, scale_log2);
}

template <int D, int BKC, int NWG>
int launch(const CUtensorMap maps[3], void* o, int B, int Hq, int G, int Sq,
           int Sk, int bq, int bk, int causal, int window, const int64_t* st,
           float scale, const Plan& p, cudaStream_t stream) {
  auto kernel = flash_fwd_tf32_kernel<D, BKC, NWG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  // D = 256: a q tile of whole passes is one block a pass (a block walks
  // its passes in series, and nothing of one pass serves the next)
  const int rows = D == 256 && bq % kRows == 0 ? kRows : bq;
  dim3 grid(Sq / rows, Hq, B);
  kernel<<<grid, block_threads(NWG), p.smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<float*>(o), Sk, G, rows, bk,
      causal, window, p.stages, st[9], st[10], st[11], scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D, int BKC>
int dispatch_nwg(const CUtensorMap maps[3], void* o, int B, int Hq, int G,
                 int Sq, int Sk, int bq, int bk, int causal, int window,
                 const int64_t* st, float scale, const Plan& p,
                 cudaStream_t stream) {
  if (p.nwg == 2)
    return launch<D, BKC, 2>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                             window, st, scale, p, stream);
  if constexpr (D != 256)   // D = 256 has two warpgroups at every bq
    return launch<D, BKC, 1>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                             window, st, scale, p, stream);
  return (int)cudaErrorInvalidValue;
}

template <int D>
int dispatch_bkc(const CUtensorMap maps[3], void* o, int B, int Hq, int G,
                 int Sq, int Sk, int bq, int bk, int causal, int window,
                 const int64_t* st, float scale, const Plan& p,
                 cudaStream_t stream) {
  // only the pieces piece_width can give at D are compiled (two at D = 256)
  switch (piece_width(D, bk)) {
#define REPRO_TF_BKC(BB)                                                     \
  case BB:                                                                   \
    if constexpr (piece_width(D, BB) == BB)                                  \
      return dispatch_nwg<D, BB>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,  \
                                 window, st, scale, p, stream);              \
    break;
    REPRO_TF_BKC(32)
    REPRO_TF_BKC(64)
    REPRO_TF_BKC(128)
#undef REPRO_TF_BKC
    default:
      break;
  }
  return (int)cudaErrorInvalidValue;
}

bool supported(int D, int bq, int bk) {
  return (D == 32 || D == 64 || D == 128 || D == 256) && bq >= 1 && bk >= 1;
}

int run(int D, const void* q, const void* k, const void* v, void* o, int B,
        int Hq, int G, int Sq, int Sk, int bq, int bk, int causal,
        int window, const int64_t* st, float scale, cudaStream_t stream) {
  if (!supported(D, bq, bk)) return (int)cudaErrorInvalidValue;
  const int bkc = piece_width(D, bk);
  const Plan p = plan(D, bq, bkc);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int64_t qdims[4] = {D, Sq, Hq, B}, kdims[4] = {D, Sk, Hq / G, B};
  const int64_t qs[3] = {st[2], st[1], st[0]}, ks[3] = {st[5], st[4], st[3]},
                vs[3] = {st[8], st[7], st[6]};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // rows of a k and a v box: a sub-tile's keys; at D = 256 a k box holds
  // the piece's keys of one column block, a v box 32 keys of one
  const int n = sub_keys(D, bkc), nv = D == 256 ? 32 : n;
  CUtensorMap maps[3];
  int rc = hopper::make_map_4d(&maps[0], f32, 4, q, qdims, qs, 32, kRows);
  if (!rc) rc = hopper::make_map_4d(&maps[1], f32, 4, k, kdims, ks, 32, n);
  if (!rc) rc = hopper::make_map_4d(&maps[2], f32, 4, v, kdims, vs, 32, nv);
  if (rc) return rc;
  switch (D) {
    case 32:
      return dispatch_bkc<32>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                              window, st, scale, p, stream);
    case 64:
      return dispatch_bkc<64>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                              window, st, scale, p, stream);
    case 128:
      return dispatch_bkc<128>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, p, stream);
    default:
      return dispatch_bkc<256>(maps, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                               window, st, scale, p, stream);
  }
}

}  // namespace tf

}  // namespace

extern "C" {

// kernel: 0 = flash_fwd_kernel (CUDA cores: float32 at D = 32, 64, 128,
// 256, bfloat16 at D = 256), 1 = flash_fwd_wgmma_kernel (bfloat16, D = 32,
// 64, 128, 256), 2 = flash_fwd_tf32_kernel (float32, D = 32, 64, 128,
// 256);
// dtype: 0 = float32, 1 = bfloat16.  The caller names the kernel: nothing
// here picks one.

// Bytes of dynamic shared memory one block of `kernel` takes for (dtype,
// D, bq, bk), or -1 for what that kernel does not take (a dtype or head
// dim it has no instance for; a block under one row).
long long flash_attention_smem_bytes(int kernel, int dtype, int D, int bq,
                                     int bk) {
  if (kernel == 1) {   // bfloat16, D <= 256
    if (dtype != 1 || !wg::supported(D, bq, bk)) return -1;
    return (long long)wg::plan(D, bq, wg::piece_width(wg::kernel_bk(D, bk)))
        .smem;
  }
  if (kernel == 2) {   // float32, D <= 256
    if (dtype != 0 || !tf::supported(D, bq, bk)) return -1;
    return (long long)tf::plan(D, bq, tf::piece_width(D, bk)).smem;
  }
  const bool f32 = dtype == 0 && (D == 32 || D == 64 || D == 128 || D == 256);
  if (kernel != 0 || !(f32 || (dtype == 1 && D == 256))) return -1;
  return (long long)(smem_floats(D, bq, bk) * sizeof(float));
}

// q: (B, Hq, Sq, D), k, v: (B, Hkv, Sk, D), o: (B, Hq, Sq, D) in dtype,
// each with any strides whose last is 1; strides holds (sb, sh, ss) of q,
// k, v, o in that order.  Needs Hq = Hkv * G, Sq % bq == 0, Sk % bk == 0;
// kernels 1 and 2 need 16-byte aligned base addresses and strides of q, k,
// v (TMA) and o.  Returns cudaGetLastError() after the launch (0 on
// success), cudaErrorInvalidValue for what `kernel` does not take, or
// 10000 + the CUresult of cuTensorMapEncodeTiled where a TMA tensor map
// cannot be encoded.
int flash_attention_launch(int kernel, int dtype, int D, const void* q,
                           const void* k, const void* v, void* o, int B,
                           int Hq, int G, int Sq, int Sk, int bq, int bk,
                           int causal, int window, const int64_t* strides,
                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flash_attention_smem_bytes(kernel, dtype, D, bq, bk) < 0)
    return (int)cudaErrorInvalidValue;
  if (kernel == 2)
    return tf::run(D, q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal, window,
                   strides, scale, st);
  if (kernel == 1)
    return wg::run(D, q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal, window,
                   strides, scale, st);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, Hq, G, Sq, Sk, bq, bk, causal,
                           window, strides, scale, st);
  return launch_d<__nv_bfloat16, 256>(q, k, v, o, B, Hq, G, Sq, Sk, bq, bk,
                                      causal, window, strides, scale, st);
}

}  // extern "C"
