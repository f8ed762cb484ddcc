// Flash-decode for Hopper (sm_90a): one launch per call.
//
// Replaces the Pallas TPU kernel `decode_attention` / `_kernel` in
// src/repro/kernels/decode_attention.py (pallas_call at :76): one query
// token per sequence attends to its KV cache at positions < length[b],
// with an f32 online softmax; GQA folds G = Hq / Hkv query heads onto
// each KV head.
//
// What bounds it: the bytes of K and V read.  A call reads
// 2 * sum_b min(length[b], S) * Hkv * D cache elements and does 4 * G
// flops on each (q.k and p.v for each of the G heads).  At G = 1, the
// main path, that is ~1 flop/byte in f32 and ~2 in bf16, far below the
// CUDA cores' balance of ~20 flops/byte (67 TFLOP/s over 3.35 TB/s), so
// the least time is bytes / 3.35 TB/s.  Why CUDA cores and not wgmma:
// the work is a matrix-vector product per (b, kv head), and wgmma's
// 64-row tiles would be at least 87 % empty at the repo's G <= 8.  G = 8
// in bf16 (16 flops/byte) is the one case that nears the CUDA cores'
// balance.
//
// What the design does about it:
//  * One launch.  Each (b, kv head)'s keys are cut into ranges of
//    `keys` (the wrapper's K: from the SM count, B * Hkv and S, or the
//    caller's `bk`).  The grid covers ceil(S / keys) ranges; a block whose
//    range starts at or past min(length[b], S) returns at once, so the
//    blocks that work follow the lengths in use and no key past a slot's
//    length is read.  length <= 0 runs every range: the reference's
//    finite -1e30 scores make that the mean of v over all S.
//  * The combine is in the same launch.  A block with more than one
//    working range writes its partial (m, l, acc) and counts itself on a
//    per-(b, kv head, head group) counter; the last of the working blocks
//    (the target, ceil(n / keys), is computed here from the length)
//    merges the partials by log-sum-exp, writes the output and resets the
//    counter for the next launch.  A single working range writes the
//    output itself.
//  * Loads in flight.  Lanes split a key row into 16-byte loads (4 f32 or
//    8 bf16 a lane: one f32 row of D = 128 is one warp load; smaller rows
//    give a warp several keys at once).  Each row group of lanes is a
//    worker with its own online softmax (m, l, acc in registers); it
//    issues the K and V loads of up to 8 keys (kUnroll, fewer where q and
//    acc take more registers) before it uses any of them.  A block has up
//    to 8 warps.  The key loop has no __syncthreads: warps merge once, at
//    the end, through shared memory.
//  * GQA from registers: every lane keeps its slice of q for all the
//    heads of its block (up to 8, an instance for 1, 2, 4 and 8), so K
//    and V are read once for all of them.  G > 8 runs in groups of 8.
//  * The cache is read through strides, so the model's (B, S, Hkv, D)
//    layout is taken as it is: no transpose, no copy.  Rows whose address
//    or stride is not a multiple of 16 bytes take element loads.
//  * Head dims 16, 32, 64, 80, 112, 128 and 256 have instances; a D whose
//    row is not a power-of-two count of 16-byte vectors (80, 112) leaves
//    lanes idle.
//
// Semantics kept from the reference: NEG_INF is the finite -1e30; the
// output is acc / max(l, 1e-30), in q's dtype; accumulation is f32.
// Scores are kept in base 2 (q is scaled by log2(e) / sqrt(D)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxWarps = 8;
constexpr int kMaxUnroll = 8;
constexpr int kMergeBytes = 32 * 1024;  // static shared memory of the merge

constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}
constexpr int pow2_at_most(int n) {
  return n < 2 ? 1 : 2 * pow2_at_most(n / 2);
}
constexpr int clamp_int(int lo, int x, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// The shape of one instance: how lanes split a key row, how many keys
// each worker loads before it uses them, and how many warps a block has.
template <typename T, int D, int MG>
struct Cfg {
  static constexpr int kVec = 16 / (int)sizeof(T);     // elements a load
  static constexpr int kRowVecs = D / kVec;            // loads a key row
  static constexpr int kLanes = kRowVecs >= 32 ? 32 : pow2_at_least(kRowVecs);
  static constexpr int kVecsPerLane = (kRowVecs + kLanes - 1) / kLanes;
  static constexpr int kElems = kVecsPerLane * kVec;   // row elements a lane
  static constexpr int kRowsPerWarp = 32 / kLanes;
  // loads in flight against the registers q and acc take (2 * MG * kElems)
  static constexpr int kUnroll = clamp_int(
      1, pow2_at_most(128 / (MG * kElems)), kMaxUnroll / kVecsPerLane);
  // as many warps as the merge's shared memory (one MG x D tile each) fits
  static constexpr int kWarps =
      clamp_int(1, pow2_at_most(kMergeBytes / (MG * D * 4)), kMaxWarps);
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kWorkers = kWarps * kRowsPerWarp;
  static constexpr int kRoundKeys = kWorkers * kUnroll;  // keys a block round
  static_assert(D % kVec == 0, "a key row is whole 16-byte vectors");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* length;   // (B,) int32
  void* out;           // contiguous (B, Hkv * G, D), q's dtype
  float* part;         // partials: acc (B,Hkv,R,G,D), then m and l (B,Hkv,R,G)
  int* counter;        // (B, Hkv * groups) int32, zero between launches
  int S, G, keys, groups, aligned;
  int64_t q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale_log2;    // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The reference's acc / max(l, 1e-30) in the output's dtype: every path
// that writes the output goes through here.
template <typename T>
__device__ __forceinline__ void write_out(T* o, float acc, float l) {
  store(o, acc / fmaxf(l, 1e-30f));
}

// 16 bytes of a row as floats.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4], float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8],
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes of a row from an address that may not be 16-byte aligned.
__device__ __forceinline__ uint4 load16_elems(const float* p) {
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load16_elems(const __nv_bfloat16* p) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(p[2 * i]) |
           ((uint32_t)__bfloat16_as_ushort(p[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool kAligned>
__device__ __forceinline__ uint4 load16(const T* p) {
  if (kAligned) return __ldg(reinterpret_cast<const uint4*>(p));
  return load16_elems(p);
}

// The K and V loads of one round of a worker: kUnroll keys, all issued
// before any is used.
template <typename T, int D, int MG, bool kAligned>
__device__ __forceinline__ void load_round(
    const T* kb, const T* vb, int64_t k_ss, int64_t v_ss, int key0,
    int stop, int sub,
    uint4 (&kr)[Cfg<T, D, MG>::kUnroll][Cfg<T, D, MG>::kVecsPerLane],
    uint4 (&vr)[Cfg<T, D, MG>::kUnroll][Cfg<T, D, MG>::kVecsPerLane]) {
  using C = Cfg<T, D, MG>;
#pragma unroll
  for (int u = 0; u < C::kUnroll; ++u) {
    const int key = key0 + u * C::kWorkers;
#pragma unroll
    for (int i = 0; i < C::kVecsPerLane; ++i) {
      const int j = sub + i * C::kLanes;
      if (key < stop && j < C::kRowVecs) {
        kr[u][i] = load16<T, kAligned>(kb + key * k_ss + j * C::kVec);
        vr[u][i] = load16<T, kAligned>(vb + key * v_ss + j * C::kVec);
      } else {
        kr[u][i] = make_uint4(0, 0, 0, 0);
        vr[u][i] = make_uint4(0, 0, 0, 0);
      }
    }
  }
}

// grid (ranges, Hkv * groups, B); block kThreads.  A block holds up to MG
// query heads of one kv head and reads the keys of one range.
template <typename T, int D, int MG>
__global__ void __launch_bounds__(Cfg<T, D, MG>::kThreads)
    decode_attention_kernel(const Params p) {
  using C = Cfg<T, D, MG>;
  constexpr int U = C::kUnroll, E = C::kElems, VPL = C::kVecsPerLane;
  constexpr int LN = C::kLanes, VEC = C::kVec;
  constexpr int kWarps = C::kWarps, kThreads = C::kThreads;
  __shared__ float sm_acc[kWarps][MG][D];
  __shared__ float sm_m[kWarps][MG], sm_l[kWarps][MG];
  __shared__ int sm_last;

  const int r = blockIdx.x, hg = blockIdx.y, b = blockIdx.z;
  const int R = gridDim.x, Hkv = gridDim.y / p.groups;
  const int h = hg / p.groups, g0 = (hg % p.groups) * MG;
  const int gn = min(MG, p.G - g0);                // heads of this block
  const int len = p.length[b];
  const bool uniform = len <= 0;       // reference: mean of v over all S
  const int n = uniform ? p.S : min(len, p.S);
  const int start = r * p.keys;
  if (start >= n) return;
  const int stop = min(n, start + p.keys);
  const int n_work = (n + p.keys - 1) / p.keys;     // ranges that run

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % LN;                        // lane within a row
  const int worker = warp * C::kRowsPerWarp + lane / LN;

  // this lane's slice of q for the block's heads, in base-2 score units
  float qr[MG][E];
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb +
                (int64_t)(h * p.G + g0) * p.q_sh;
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int j = sub + i * LN;
        qr[g][i * VEC + e] =
            (g < gn && j < C::kRowVecs)
                ? to_float(qb[g * p.q_sh + j * VEC + e]) * p.scale_log2
                : 0.f;
      }

  float m[MG], l[MG], acc[MG][E];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  for (int base = start; base < stop; base += C::kRoundKeys) {
    uint4 kr[U][VPL], vr[U][VPL];
    if (p.aligned)
      load_round<T, D, MG, true>(kb, vb, p.k_ss, p.v_ss, base + worker, stop,
                                 sub, kr, vr);
    else
      load_round<T, D, MG, false>(kb, vb, p.k_ss, p.v_ss, base + worker,
                                  stop, sub, kr, vr);
    float s[U][MG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float dot[MG];
#pragma unroll
      for (int g = 0; g < MG; ++g) dot[g] = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        float f[VEC];
        unpack(kr[u][i], f, T());
#pragma unroll
        for (int g = 0; g < MG; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            dot[g] = fmaf(qr[g][i * VEC + e], f[e], dot[g]);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
#pragma unroll
        for (int o = LN / 2; o > 0; o >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        s[u][g] = uniform ? kNegInf : dot[g];
      }
    }
    // online softmax over the round's keys; keys past `stop` weigh 0
    const int key0 = base + worker;
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (key0 + u * C::kWorkers < stop) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float pu =
            key0 + u * C::kWorkers < stop ? exp2f(s[u][g] - mx) : 0.f;
        l[g] += pu;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          float f[VEC];
          unpack(vr[u][i], f, T());
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[g][i * VEC + e] = fmaf(pu, f[e], acc[g][i * VEC + e]);
        }
      }
    }
  }

  // merge the row groups of a warp (lanes LN apart hold the same columns)
#pragma unroll
  for (int o = LN; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float M = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - M), c = exp2f(mo - M);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], o) * c;
      m[g] = M;
    }
  }
  // then the warps, through shared memory
  if (lane < LN) {
#pragma unroll
    for (int g = 0; g < MG; ++g)
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = sub + i * LN;
        if (j < C::kRowVecs)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            sm_acc[warp][g][j * VEC + e] = acc[g][i * VEC + e];
      }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();

  const int64_t row0 = ((int64_t)b * Hkv + h) * p.G + g0;   // (b, h, g0)
  T* out = static_cast<T*>(p.out);
  const int64_t prow0 = (((int64_t)b * Hkv + h) * R) * p.G + g0;  // r = 0
  const int64_t n_part = (int64_t)gridDim.z * Hkv * R * p.G;
  float* part_acc = p.part;
  float* part_m = p.part + n_part * D;
  float* part_l = part_m + n_part;
  for (int x = tid; x < gn * D; x += kThreads) {
    const int g = x / D, d = x % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w][g] - M);
      L += sm_l[w][g] * c;
      A += sm_acc[w][g][d] * c;
    }
    if (n_work == 1) {
      write_out(out + (row0 + g) * D + d, A, L);
    } else {
      const int64_t pr = prow0 + (int64_t)r * p.G + g;
      part_acc[pr * D + d] = A;
      if (d == 0) {
        part_m[pr] = M;
        part_l[pr] = L;
      }
    }
  }
  if (n_work == 1) return;

  // the last working block of this (b, kv head, head group) combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* c = p.counter + (int64_t)b * gridDim.y + hg;
    sm_last = atomicAdd(c, 1) == n_work - 1;
    if (sm_last) *c = 0;                   // ready for the next launch
  }
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  for (int x = tid; x < gn * D; x += kThreads) {
    const int g = x / D, d = x % D;
    float M = kNegInf;
#pragma unroll 8
    for (int rr = 0; rr < n_work; ++rr)
      M = fmaxf(M, __ldcg(part_m + prow0 + (int64_t)rr * p.G + g));
    float L = 0.f, A = 0.f;
#pragma unroll 8
    for (int rr = 0; rr < n_work; ++rr) {
      const int64_t pr = prow0 + (int64_t)rr * p.G + g;
      const float c = exp2f(__ldcg(part_m + pr) - M);
      L += __ldcg(part_l + pr) * c;
      A += __ldcg(part_acc + pr * D + d) * c;
    }
    write_out(out + (row0 + g) * D + d, A, L);
  }
}

template <typename T, int D, int MG>
int launch(const Params& p, int ranges, int B, int Hkv, cudaStream_t st) {
  const dim3 grid(ranges, Hkv * p.groups, B);
  decode_attention_kernel<T, D, MG><<<grid, Cfg<T, D, MG>::kThreads, 0, st>>>(
      p);
  return (int)cudaGetLastError();
}

// What the host plans with for one instance: keys a block reads in one
// round, and blocks one SM holds at once.
template <typename T, int D, int MG>
int info(int what) {
  if (what == 0) return Cfg<T, D, MG>::kRoundKeys;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, decode_attention_kernel<T, D, MG>, Cfg<T, D, MG>::kThreads,
          0) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// Returns CALL<T, D, MG> ARGS for the instance of (dtype, D, MG), or
// `bad` where there is none.
#define REPRO_DECODE_DISPATCH(CALL, ARGS, bad)                         \
  switch (dtype * 10000 + D * 10 + MG) {                               \
    REPRO_DECODE_DT(0, float, CALL, ARGS)                              \
    REPRO_DECODE_DT(1, __nv_bfloat16, CALL, ARGS)                      \
    default:                                                           \
      return bad;                                                      \
  }
#define REPRO_DECODE_DT(DT, T, CALL, ARGS)                             \
  REPRO_DECODE_D(DT, T, 16, CALL, ARGS)                                \
  REPRO_DECODE_D(DT, T, 32, CALL, ARGS)                                \
  REPRO_DECODE_D(DT, T, 64, CALL, ARGS)                                \
  REPRO_DECODE_D(DT, T, 80, CALL, ARGS)                                \
  REPRO_DECODE_D(DT, T, 112, CALL, ARGS)                               \
  REPRO_DECODE_D(DT, T, 128, CALL, ARGS)                               \
  REPRO_DECODE_D(DT, T, 256, CALL, ARGS)
#define REPRO_DECODE_D(DT, T, DD, CALL, ARGS)                          \
  REPRO_DECODE_CASE(DT, T, DD, 1, CALL, ARGS)                          \
  REPRO_DECODE_CASE(DT, T, DD, 2, CALL, ARGS)                          \
  REPRO_DECODE_CASE(DT, T, DD, 4, CALL, ARGS)                          \
  REPRO_DECODE_CASE(DT, T, DD, 8, CALL, ARGS)
#define REPRO_DECODE_CASE(DT, T, DD, G, CALL, ARGS)                    \
  case DT * 10000 + DD * 10 + G:                                       \
    return CALL<T, DD, G> ARGS;

}  // namespace

extern "C" {

// For the instance of (dtype, D, MG): what = 0 gives the keys one block
// round reads, what = 1 the blocks one SM holds; -1 where there is no
// instance (or the query fails).
int decode_attention_info(int dtype, int D, int MG, int what) {
  REPRO_DECODE_DISPATCH(info, (what), -1)
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  MG: the
// query heads a block holds (1, 2, 4 or 8), `groups` = ceil(G / MG).
// q: (B, Hkv*G, D) with strides (q_sb, q_sh, 1); k, v: (B, Hkv, S, D) with
// strides (sb, sh, ss, 1); out: contiguous (B, Hkv*G, D); length: (B,)
// int32.  `ranges` ranges of `keys` keys per (b, kv head); for ranges > 1,
// part: f32 scratch of B*Hkv*ranges*G*(D+2) floats, counter: B*Hkv*groups
// int32 that are 0.
// Returns cudaGetLastError() after the launch (0 on success).
int decode_attention_launch(int dtype, int D, int MG, const void* q,
                            const void* k, const void* v, const int* length,
                            void* out, float* part, int* counter, int B,
                            int Hkv, int G, int groups, int S, int keys,
                            int ranges, int aligned,
                            int64_t q_sb, int64_t q_sh, int64_t k_sb,
                            int64_t k_sh, int64_t k_ss, int64_t v_sb,
                            int64_t v_sh, int64_t v_ss, float scale_log2,
                            void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.length = length;
  p.out = out;
  p.part = part;
  p.counter = counter;
  p.S = S;
  p.G = G;
  p.keys = keys;
  p.groups = groups;
  p.aligned = aligned;
  p.q_sb = q_sb;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_sh = k_sh;
  p.k_ss = k_ss;
  p.v_sb = v_sb;
  p.v_sh = v_sh;
  p.v_ss = v_ss;
  p.scale_log2 = scale_log2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_DECODE_DISPATCH(launch, (p, ranges, B, Hkv, st),
                        (int)cudaErrorInvalidValue)
}

}  // extern "C"
