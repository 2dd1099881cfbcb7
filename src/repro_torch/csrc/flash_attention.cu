// Flash attention for the serving path: every attention layer of gemma3-1b,
// in prefill (a 1,024-token prompt) and in decode (one query against the
// cache). On the training path the two prefill routes also write each row's
// log-sum-exp (lse, float32, natural log), which the backward
// (flash_attention_bwd.cu) reads to rebuild P without a second softmax, and
// the bf16 route the output in float32 before its rounding (o32), from which
// the backward's Delta = rowsum(dO * O) is exact.
//
// Replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:29, pallas_call at :113). That
// kernel ran a (batch, q head, q tile, kv tile) grid with the kv axis
// innermost, so the online-softmax state (m, l, acc) lived in VMEM across
// the sequential kv steps. Blocks of a CUDA grid run in no order, so here
// the kv walk is a loop inside a block (prefill) or is cut into splits whose
// partial states a second launch merges (decode).
//
// Three routes; the host picks one per call (plan_launch in
// kernels/flash_attention/kernel.py) and passes it in:
//
//   decode (route 2), both dtypes, when the G * Sq (head, query) rows of a
//   KV group fit kDecodeRows (16). Bound by bytes: gemma3-1b decode reads a
//   ~4.3 MB cache for ~17 MFLOP, ~1.3 us at 3.35 TB/s. flash_kernel_split
//   runs one block per (batch, KV head, split of split_len = 32 or 64 keys
//   of the visible key range), so B * KV * n_split blocks cover the card
//   (132 at the serving shape) instead of B * KV. A block copies its split's
//   K and V rows with 16-byte cp.async (all in flight at once: one memory
//   latency per block), then each warp takes rows: lane j scores key j
//   against the row in float32 (no shuffles), the warp reduces max and sum,
//   and lane c accumulates 16-byte chunk c of p . V. Each (row, split) writes
//   float32 (m, l, acc[hd]) to scratch (B, H, Sq, n_split, hd + 2) that the
//   wrapper allocates. flash_kernel_merge, one block per (b, h, query) and
//   one thread per head dim, weighs split s by exp(m_s - M): an empty split (m = -1e30, l = 0, acc =
//   0) gets weight 0 next to any real key, and M = -1e30 only when every
//   split is empty, where exp(0) * 0 stays 0, so inf - inf never forms. CUDA
//   cores are the right tool at 4 rows: the products are tiny next to the
//   bytes.
//
//   tensor-core prefill (route 1), bf16. Bound by operations: the global
//   layer (B 4, H 4, KV 1, S 1,024, hd 256) does ~8.6 GFLOP causal, ~8.7 us
//   at 989 TFLOP/s. flash_kernel_mma is flash-attention-2 shaped: a block of
//   4 warps owns 64 (head, query) rows of one GQA group (the G heads packed
//   into the rows, so each K/V tile serves all of them); warp w owns rows
//   16w..16w+15. S = Q K^T and O += P V run as mma.sync.m16n8k16 bf16 with
//   float32 accumulators in registers, operands fetched with ldmatrix
//   (.trans for V) from shared rows padded by 16 bytes (conflict-free for
//   every head dim: a row is an odd number of 16-byte chunks, 2 hd / 16 +
//   1, so the eight rows one ldmatrix reads fall in eight distinct chunks
//   of a 128-byte line; at zamba2-7b's hd 112 that is 15 chunks, 7 pairs
//   of 8-dim tiles along hd and 56 accumulator floats a thread; at the
//   ~100M gemma3-family trainer's hd 80, 11 chunks, 5 pairs, 5 k-steps of
//   16 and 40 accumulator floats). The online softmax runs on the accumulator fragments:
//   scale, tanh softcap and the causal / window / kend mask (only on tiles
//   that need it), row max and sum across the quad that shares a row by
//   shuffles, in log2 units (exp2f). P is rounded to bf16 in registers and
//   fed straight back as the A operand of P V; l sums the rounded P, so the
//   output is a convex combination of V rows. K/V tiles arrive as bf16
//   through a two-stage cp.async ring: tile t + 1 loads while tile t
//   computes. Q stays in shared memory (at hd 256 its fragments would cost
//   64 registers beside the 128 of the O accumulator). Tiles of 64 keys (32
//   at hd 256, so two blocks fit an SM) are visited only inside the causal
//   and window bounds, and blocks are numbered longest q tile first, so the
//   last wave is short.
//   Why mma.sync and not wgmma: wgmma needs both shared-memory operands in
//   descriptor-encoded swizzled layouts and V transposed through the
//   descriptor, where one wrong bit gives silently wrong products;
//   mma.sync + ldmatrix keeps each fragment's layout explicit and
//   checkable by reading, the simpler kernel to get right first. It peaks
//   below wgmma's rate; wgmma with TMA is the next step (PERF.md).
//
//   SIMT prefill (route 0), float32: one block per (batch, group of query
//   heads, query tile of 32 rows), float32 FMAs on the CUDA cores out of
//   shared memory. It keeps float32 products exact to ~1e-6, which the
//   float32 hold runs need (a TF32 product would not be).
//
// All routes: inputs read in the caller's layout through element strides
// (batch, head, position; unit stride along hd), so the model hands its
// (B, S, H, hd) projections and (B, max_len, KV, hd) caches over without a
// transpose; the output goes to (B, Sq, H, hd) storage. Scores, max, sum and
// accumulators are float32. The finite -1e30 sentinel keeps exp(s - m) away
// from inf - inf; the output is acc / max(l, 1e-30). kend = min(Skv,
// kv_len): decode passes q_offset = pos and kv_len = pos + 1. Rows with no
// valid key are not on the serving path (every causal row sees its own key);
// their output is not the plain version's and no test compares it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* scratch;       // decode: (B, H, Sq, n_split, hd + 2) float32
  float* lse;           // prefill, when not null: (B, H, Sq) float32, ln units
  float* o32;           // bf16 prefill with lse: the output in float32
                        // before its rounding, with o's element strides
  int64_t qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, pos
  int batch;
  int heads;            // H
  int group;            // G: query heads per KV head
  int heads_per_block;  // query heads of one group served by a block
  int block_q;          // query positions per block
  int n_groups;         // H / heads_per_block
  int64_t n_qtiles;     // ceil(Sq / block_q)
  int64_t sq;           // queries
  int64_t kend;         // keys [0, kend) exist (min(Skv, kv_len))
  int causal;
  int64_t window;       // <= 0: no window
  float softcap;        // <= 0: no softcap
  int64_t q_offset;
  float scale;
  int64_t key_lo, key_hi;  // decode: the keys some row may see
  int64_t split_len;       // decode: keys per split (32 or 64)
  int64_t n_split;         // decode: splits of [key_lo, key_hi)
};

// 16-byte loads: 4 floats or 8 bf16 values, widened to float.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The keys some row of queries [q0, last_q] may see: [lo, hi).
__device__ inline void key_bounds(const Params& p, int64_t q0, int64_t last_q,
                                  int64_t* lo, int64_t* hi) {
  *lo = 0;
  *hi = p.kend;
  if (p.window > 0) {
    const int64_t w = p.q_offset + q0 - p.window + 1;
    *lo = w > 0 ? w : 0;
  }
  if (p.causal) {
    const int64_t c = p.q_offset + last_q + 1;
    *hi = c < *hi ? c : *hi;
  }
}

// ---------------------------------------------------------------------------
// Route 0: SIMT prefill (float32)

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                      // (head, query) rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeysPerLane = 2;
constexpr int kBlockK = 32 * kKeysPerLane;     // keys per tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kRows * HD + kBlockK * (HD + 1) + kBlockK * HD + kRows * kBlockK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Params p) {
  constexpr int kVec = Vec16<T>::kN;
  constexpr int kChunks = HD / kVec;            // 16-byte chunks per row
  constexpr int kDims = (HD + 31) / 32;         // head dims per lane
  extern __shared__ float smem[];
  float* sQ = smem;                             // kRows x HD
  float* sK = sQ + kRows * HD;                  // kBlockK x (HD + 1)
  float* sV = sK + kBlockK * (HD + 1);          // kBlockK x HD
  float* sP = sV + kBlockK * HD;                // kRows x kBlockK

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = (int64_t)blockIdx.x * p.block_q;   // first query index
  const int h0 = blockIdx.y * p.heads_per_block;        // first query head
  const int64_t kvh = h0 / p.group;
  const int64_t b = blockIdx.z;
  const int rows = p.heads_per_block * p.block_q;

  // stage Q; rows past the block's queries are zero
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int d0 = (c % kChunks) * kVec;
    const int64_t qi = q0 + r % p.block_q;
    float vals[kVec];
    if (r < rows && qi < p.sq) {
      const int64_t h = h0 + r / p.block_q;
      Vec16<T>::load(q + b * p.qs[0] + h * p.qs[1] + qi * p.qs[2] + d0, vals);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) vals[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sQ[r * HD + d0 + i] = vals[i];
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDims];
  int64_t qpos[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    m[rr] = kNegInf;
    l[rr] = 0.f;
    qpos[rr] = p.q_offset + q0 + r % p.block_q;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[rr][i] = 0.f;
  }

  const int64_t last_q = (q0 + p.block_q < p.sq ? q0 + p.block_q : p.sq) - 1;
  int64_t key_lo, key_hi;
  key_bounds(p, q0, last_q, &key_lo, &key_hi);
  const int64_t t_lo = key_lo / kBlockK;
  const int64_t t_hi = key_hi > key_lo ? (key_hi + kBlockK - 1) / kBlockK : t_lo;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int64_t key0 = t * kBlockK;
    __syncthreads();  // Q is staged; the last tile's K/V are no longer read
    for (int c = tid; c < kBlockK * kChunks; c += kThreads) {
      const int j = c / kChunks;
      const int d0 = (c % kChunks) * kVec;
      const int64_t key = key0 + j;
      float kv[kVec], vv[kVec];
      if (key < p.kend) {
        Vec16<T>::load(k + b * p.ks[0] + kvh * p.ks[1] + key * p.ks[2] + d0, kv);
        Vec16<T>::load(v + b * p.vs[0] + kvh * p.vs[1] + key * p.vs[2] + d0, vv);
      } else {  // zero, not garbage: p * v must stay finite
#pragma unroll
        for (int i = 0; i < kVec; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        sK[j * (HD + 1) + d0 + i] = kv[i];
        sV[j * HD + d0 + i] = vv[i];
      }
    }
    __syncthreads();

    float s[kKeysPerLane][kRowsPerWarp];
#pragma unroll
    for (int kk = 0; kk < kKeysPerLane; ++kk)
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) s[kk][rr] = 0.f;
    const float* qrow = sQ + warp * kRowsPerWarp * HD;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float kd[kKeysPerLane];
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk)
        kd[kk] = sK[(lane + 32 * kk) * (HD + 1) + d];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float qd = qrow[rr * HD + d];
#pragma unroll
        for (int kk = 0; kk < kKeysPerLane; ++kk) s[kk][rr] += qd * kd[kk];
      }
    }

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const int64_t key = key0 + lane + 32 * kk;
        float x = s[kk][rr] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool ok = key < p.kend && (!p.causal || key <= qpos[rr]) &&
                        (p.window <= 0 || key > qpos[rr] - p.window);
        s[kk][rr] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[kk][rr]);
      }
      const float m_new = fmaxf(m[rr], warp_max(mx));
      const float corr = expf(m[rr] - m_new);
      float sum = 0.f;
      float* prow = sP + (warp * kRowsPerWarp + rr) * kBlockK;
#pragma unroll
      for (int kk = 0; kk < kKeysPerLane; ++kk) {
        const float pk = expf(s[kk][rr] - m_new);
        prow[lane + 32 * kk] = pk;
        sum += pk;
      }
      l[rr] = l[rr] * corr + warp_sum(sum);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kDims; ++i) acc[rr][i] *= corr;
    }
    __syncwarp();

    const float* pw = sP + warp * kRowsPerWarp * kBlockK;
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float vj[kDims];
#pragma unroll
      for (int i = 0; i < kDims; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < HD ? sV[j * HD + d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float pj = pw[rr * kBlockK + j];
#pragma unroll
        for (int i = 0; i < kDims; ++i) acc[rr][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int64_t qi = q0 + r % p.block_q;
    if (r >= rows || qi >= p.sq) continue;
    const int64_t h = h0 + r / p.block_q;
    T* orow = o + b * p.os[0] + h * p.os[1] + qi * p.os[2];
    const float denom = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store(orow + d, acc[rr][i] / denom);
    }
    if (p.lse != nullptr && lane == 0)
      p.lse[(b * p.heads + h) * p.sq + qi] = m[rr] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// Route 1: tensor-core prefill (bf16)

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;       // (head, query) rows per block

template <int HD>
struct MmaTile {
  static constexpr int kBlockN = HD >= 256 ? 32 : 64;   // keys per tile
  static constexpr int kLd = HD + 8;   // bf16 per shared row: 16-byte pad
  // Q, then a two-stage ring of (K, V) tiles
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kLd * (kMmaRows + 4 * kBlockN);
};

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2) flash_kernel_mma(Params p) {
  using T = __nv_bfloat16;
  constexpr int BN = MmaTile<HD>::kBlockN;
  constexpr int LD = MmaTile<HD>::kLd;
  constexpr int kChunks = HD / 8;     // 16-byte chunks per row
  constexpr int kKSteps = HD / 16;    // k steps of Q K^T
  constexpr int kNTiles = BN / 8;     // 8-key n tiles of S
  constexpr int kDTiles = HD / 8;     // 8-dim n tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);    // kMmaRows x LD
  T* sK = sQ + kMmaRows * LD;                // 2 stages x BN x LD
  T* sV = sK + 2 * BN * LD;                  // 2 stages x BN x LD

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // blocks in order of work: the last q tile (most causal keys) first
  int64_t bid = blockIdx.x;
  const int64_t b = bid % p.batch;
  bid /= p.batch;
  const int grp = (int)(bid % p.n_groups);
  bid /= p.n_groups;
  const int64_t q0 = (p.n_qtiles - 1 - bid) * p.block_q;
  const int h0 = grp * p.heads_per_block;
  const int64_t kvh = h0 / p.group;
  const int rows = p.heads_per_block * p.block_q;
  const T* kb = k + b * p.ks[0] + kvh * p.ks[1];
  const T* vb = v + b * p.vs[0] + kvh * p.vs[1];

  // Q: rows past the block's queries are zero
  for (int c = tid; c < kMmaRows * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int d0 = (c % kChunks) * 8;
    const int64_t qi = q0 + r % p.block_q;
    const bool ok = r < rows && qi < p.sq;
    const T* src = ok ? q + b * p.qs[0] + (h0 + r / p.block_q) * p.qs[1] +
                            qi * p.qs[2] + d0
                      : q;
    cp_async16(sQ + r * LD + d0, src, ok);
  }
  cp_async_commit();

  const int64_t last_q = (q0 + p.block_q < p.sq ? q0 + p.block_q : p.sq) - 1;
  int64_t key_lo, key_hi;
  key_bounds(p, q0, last_q, &key_lo, &key_hi);
  const int64_t t_lo = key_lo / BN;
  const int64_t t_hi = key_hi > key_lo ? (key_hi + BN - 1) / BN : t_lo;

  // keys past kend are zero, not garbage: p * v must stay finite
  auto load_kv = [&](int64_t t, int stage) {
    T* dk = sK + stage * BN * LD;
    T* dv = sV + stage * BN * LD;
    for (int c = tid; c < BN * kChunks; c += kMmaThreads) {
      const int j = c / kChunks;
      const int d0 = (c % kChunks) * 8;
      const int64_t key = t * BN + j;
      const bool ok = key < p.kend;
      cp_async16(dk + j * LD + d0, ok ? kb + key * p.ks[2] + d0 : k, ok);
      cp_async16(dv + j * LD + d0, ok ? vb + key * p.vs[2] + d0 : v, ok);
    }
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int r_a = warp * 16 + g;   // this thread's two rows
  const int r_b = r_a + 8;
  const int qpos_a = (int)(p.q_offset + q0 + r_a % p.block_q);
  const int qpos_b = (int)(p.q_offset + q0 + r_b % p.block_q);
  const int qpos_min = (int)(p.q_offset + q0);
  const int qpos_max = (int)(p.q_offset + last_q);
  const int kend = (int)p.kend;
  const int window = (int)p.window;
  const float scale_log2 = p.scale * kLog2e;
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
  const float cap_log2 = p.softcap * kLog2e;

  float acc[kDTiles][4];
#pragma unroll
  for (int j = 0; j < kDTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t + 1 < t_hi) load_kv(t + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile t have landed
    __syncthreads();
    const T* tK = sK + stage * BN * LD;
    const T* tV = sV + stage * BN * LD;

    // S = Q K^T
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kNTiles / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, tK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale, softcap, mask; the running max over the quad sharing a row
    const int key0 = (int)(t * BN);
    const bool need_mask = key0 + BN > kend ||
                           (p.causal && key0 + BN - 1 > qpos_min) ||
                           (window > 0 && key0 <= qpos_max - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e];
        x = p.softcap > 0.f ? cap_log2 * tanhf(x * cap_in) : x * scale_log2;
        if (need_mask) {
          const int key = key0 + 8 * j + 2 * tq + (e & 1);
          const int qp = e < 2 ? qpos_a : qpos_b;
          const bool ok = key < kend && (!p.causal || key <= qp) &&
                          (window <= 0 || key > qp - window);
          if (!ok) x = kNegInf;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kDTiles; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // P in bf16, packed in registers as the A operand of P V
    uint32_t pa[kNTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(exp2f(s[j][0] - m[0]),
                                                      exp2f(s[j][1] - m[0]));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(exp2f(s[j][2] - m[1]),
                                                      exp2f(s[j][3] - m[1]));
      const float2 flo = __bfloat1622float2(lo);
      const float2 fhi = __bfloat1622float2(hi);
      l[0] += flo.x + flo.y;
      l[1] += fhi.x + fhi.y;
      pa[j / 2][(j & 1) * 2] = bf16x2_bits(lo);
      pa[j / 2][(j & 1) * 2 + 1] = bf16x2_bits(hi);
    }

    // O += P V
#pragma unroll
    for (int ks = 0; ks < kNTiles / 2; ++ks) {
#pragma unroll
      for (int dp = 0; dp < kDTiles / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, tV + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa[ks], bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa[ks], bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage is free for the load of tile t + 2
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_b : r_a;
    const int64_t qi = q0 + r % p.block_q;
    if (r >= rows || qi >= p.sq) continue;
    const int64_t h = h0 + r / p.block_q;
    T* orow = o + b * p.os[0] + h * p.os[1] + qi * p.os[2];
    const float denom = fmaxf(l[half], 1e-30f);
    // m is in log2 units (scores times kLog2e): lse = ln 2 (m + log2 l)
    if (p.lse != nullptr && tq == 0)
      p.lse[(b * p.heads + h) * p.sq + qi] = (m[half] + log2f(denom)) * kLn2;
#pragma unroll
    for (int j = 0; j < kDTiles; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * half] / denom,
                                acc[j][2 * half + 1] / denom);
    if (p.o32 != nullptr) {
      float* frow = p.o32 + b * p.os[0] + h * p.os[1] + qi * p.os[2];
#pragma unroll
      for (int j = 0; j < kDTiles; ++j)
        *reinterpret_cast<float2*>(frow + 8 * j + 2 * tq) =
            make_float2(acc[j][2 * half] / denom,
                        acc[j][2 * half + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Route 2: split-KV decode (both dtypes), then the merge

constexpr int kDecodeRows = 16;      // G * Sq rows at most
constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kSplitKeys = 64;       // keys per split at most
constexpr int kMergeThreads = 256;   // one thread a head dim (hd <= 256)
constexpr int kMergeChunk = 1024;    // split weights staged at a time

template <typename T, int HD>
struct SplitTile {
  static constexpr int kVec = Vec16<T>::kN;
  static constexpr int kLd = HD + kVec;   // elements per shared row: 16-byte pad
  static constexpr size_t kSmem = sizeof(float) * kDecodeRows * HD +
                                  2 * sizeof(T) * kSplitKeys * kLd;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kSplitThreads) flash_kernel_split(Params p) {
  constexpr int kVec = SplitTile<T, HD>::kVec;
  constexpr int LD = SplitTile<T, HD>::kLd;
  constexpr int kChunks = HD / kVec;                 // 16-byte chunks per row
  constexpr int kLaneChunks = (kChunks + 31) / 32;   // of P V, per lane
  constexpr int kLaneKeys = kSplitKeys / 32;        // keys per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);    // rows x HD
  T* sK = reinterpret_cast<T*>(sQ + kDecodeRows * HD);  // split_len x LD
  T* sV = sK + kSplitKeys * LD;

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t split = blockIdx.x;
  const int64_t kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int rows = p.group * (int)p.sq;
  const int64_t key0 = p.key_lo + split * p.split_len;
  const int64_t key_end = key0 + p.split_len < p.key_hi ? key0 + p.split_len
                                                        : p.key_hi;
  const int n = key_end > key0 ? (int)(key_end - key0) : 0;
  const int split_len = (int)p.split_len;

  // the split's K and V rows, all in flight at once; rows past n are zero
  const T* kb = k + b * p.ks[0] + kvh * p.ks[1];
  const T* vb = v + b * p.vs[0] + kvh * p.vs[1];
  for (int c = tid; c < split_len * kChunks; c += kSplitThreads) {
    const int j = c / kChunks;
    const int d0 = (c % kChunks) * kVec;
    const bool ok = j < n;
    cp_async16(sK + j * LD + d0, ok ? kb + (key0 + j) * p.ks[2] + d0 : k, ok);
    cp_async16(sV + j * LD + d0, ok ? vb + (key0 + j) * p.vs[2] + d0 : v, ok);
  }
  cp_async_commit();
  // Q rows (head g, query i) = row g * Sq + i, widened to float
  for (int c = tid; c < rows * HD; c += kSplitThreads) {
    const int r = c / HD;
    const int d = c % HD;
    const int64_t h = kvh * p.group + r / p.sq;
    sQ[c] = to_float(q[b * p.qs[0] + h * p.qs[1] + (r % p.sq) * p.qs[2] + d]);
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int r = warp; r < rows; r += kSplitWarps) {
    const int64_t h = kvh * p.group + r / p.sq;
    const int64_t qi = r % p.sq;
    const int64_t qpos = p.q_offset + qi;
    const float* qrow = sQ + r * HD;
    // lane j scores keys j and j + 32
    float x[kLaneKeys];
    bool ok[kLaneKeys];
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kLaneKeys; ++c) {
      const int j = lane + 32 * c;
      const int64_t key = key0 + j;
      ok[c] = j < n && (!p.causal || key <= qpos) &&
              (p.window <= 0 || key > qpos - p.window);
      x[c] = kNegInf;
      if (32 * c >= split_len) continue;
      const T* krow = sK + j * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d0 = 0; d0 < HD; d0 += kVec) {
        float kf[kVec];
        Vec16<T>::load(krow + d0, kf);
#pragma unroll
        for (int i = 0; i < kVec; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qrow + d0 + i);
          dot += qv.x * kf[i] + qv.y * kf[i + 1] + qv.z * kf[i + 2] +
                 qv.w * kf[i + 3];
        }
      }
      float s = dot * p.scale;
      if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
      if (ok[c]) {
        x[c] = s;
        mx = fmaxf(mx, s);
      }
    }
    mx = warp_max(mx);
    float pr[kLaneKeys];
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneKeys; ++c) {
      pr[c] = ok[c] ? expf(x[c] - mx) : 0.f;
      sum += pr[c];
    }
    const float l = warp_sum(sum);

    // P V: lane owns 16-byte chunks lane, lane + 32, ... of the row
    float acc[kLaneChunks][kVec];
#pragma unroll
    for (int cc = 0; cc < kLaneChunks; ++cc)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[cc][i] = 0.f;
#pragma unroll
    for (int c = 0; c < kLaneKeys; ++c) {
      if (32 * c >= split_len) break;
#pragma unroll 8
      for (int jj = 0; jj < 32; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, pr[c], jj);
        const T* vrow = sV + (32 * c + jj) * LD;
#pragma unroll
        for (int cc = 0; cc < kLaneChunks; ++cc) {
          const int chunk = lane + 32 * cc;
          if (chunk < kChunks) {
            float vf[kVec];
            Vec16<T>::load(vrow + chunk * kVec, vf);
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[cc][i] += pj * vf[i];
          }
        }
      }
    }

    float* part = p.scratch +
                  (((b * p.heads + h) * p.sq + qi) * p.n_split + split) * (HD + 2);
    if (lane == 0) {
      part[0] = mx;
      part[1] = l;
    }
#pragma unroll
    for (int cc = 0; cc < kLaneChunks; ++cc) {
      const int chunk = lane + 32 * cc;
      if (chunk < kChunks) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) part[2 + chunk * kVec + i] = acc[cc][i];
      }
    }
  }
}

// Reductions over a block of kMergeThreads; `red` holds one value a warp.
__device__ inline float block_max(float x, float* red) {
  x = warp_max(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kMergeThreads / 32; ++i) x = fmaxf(x, red[i]);
  __syncthreads();  // red is free again
  return x;
}

__device__ inline float block_sum(float x, float* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int i = 1; i < kMergeThreads / 32; ++i) x += red[i];
  __syncthreads();
  return x;
}

// One block per (query, head, batch), thread d owns head dim d: split s
// weighs exp(m_s - M). The threads read the splits' (m, l) side by side and
// stage the weights in shared memory, kMergeChunk at a time, so no thread
// walks the splits one dependent load after another.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) flash_kernel_merge(Params p,
                                                                    int hd) {
  __shared__ float w[kMergeChunk];
  __shared__ float red[kMergeThreads / 32];
  const int tid = threadIdx.x;
  const int64_t qi = blockIdx.x;
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t n = p.n_split;
  const int64_t stride = hd + 2;
  const float* part =
      p.scratch + ((b * p.heads + h) * p.sq + qi) * n * stride;
  float x = kNegInf;
  for (int64_t s = tid; s < n; s += kMergeThreads)
    x = fmaxf(x, part[s * stride]);
  const float big = block_max(x, red);
  x = 0.f;
  for (int64_t s = tid; s < n; s += kMergeThreads)
    x += expf(part[s * stride] - big) * part[s * stride + 1];
  const float denom = fmaxf(block_sum(x, red), 1e-30f);
  float acc = 0.f;
  for (int64_t c0 = 0; c0 < n; c0 += kMergeChunk) {
    const int m = (int)(n - c0 < kMergeChunk ? n - c0 : kMergeChunk);
    for (int s = tid; s < m; s += kMergeThreads)
      w[s] = expf(part[(c0 + s) * stride] - big);
    __syncthreads();
    if (tid < hd) {
      const float* col = part + c0 * stride + 2 + tid;
#pragma unroll 16
      for (int s = 0; s < m; ++s) acc += w[s] * col[s * stride];
    }
    __syncthreads();  // w is free for the next chunk
  }
  if (tid < hd)
    store(static_cast<T*>(p.o) + b * p.os[0] + h * p.os[1] + qi * p.os[2] +
              tid,
          acc / denom);
}

// ---------------------------------------------------------------------------
// Launches

template <int HD>
int launch_simt(const Params& p, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool configured = false;
  if (int err = allow_smem(flash_kernel<float, HD>, bytes, &configured))
    return err;
  const dim3 grid((unsigned)p.n_qtiles, (unsigned)p.n_groups,
                  (unsigned)p.batch);
  flash_kernel<float, HD><<<grid, kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const Params& p, cudaStream_t st) {
  constexpr size_t bytes = MmaTile<HD>::kSmem;
  static bool configured = false;
  if (int err = allow_smem(flash_kernel_mma<HD>, bytes, &configured))
    return err;
  const int64_t blocks = p.n_qtiles * p.n_groups * p.batch;
  flash_kernel_mma<HD><<<(unsigned)blocks, kMmaThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_decode(const Params& p, int64_t KV, cudaStream_t st) {
  constexpr size_t bytes = SplitTile<T, HD>::kSmem;
  static bool configured = false;
  if (int err = allow_smem(flash_kernel_split<T, HD>, bytes, &configured))
    return err;
  const dim3 grid((unsigned)p.n_split, (unsigned)KV, (unsigned)p.batch);
  flash_kernel_split<T, HD><<<grid, kSplitThreads, bytes, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 merge((unsigned)p.sq, (unsigned)p.heads, (unsigned)p.batch);
  flash_kernel_merge<T><<<merge, kMergeThreads, 0, st>>>(p, HD);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_decode(int64_t hd, const Params& p, int64_t KV, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_decode<T, 16>(p, KV, st);
    case 32: return launch_decode<T, 32>(p, KV, st);
    case 64: return launch_decode<T, 64>(p, KV, st);
    case 80: return launch_decode<T, 80>(p, KV, st);
    case 112: return launch_decode<T, 112>(p, KV, st);
    case 128: return launch_decode<T, 128>(p, KV, st);
    case 256: return launch_decode<T, 256>(p, KV, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_mma(int64_t hd, const Params& p, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_mma<16>(p, st);
    case 32: return launch_mma<32>(p, st);
    case 64: return launch_mma<64>(p, st);
    case 80: return launch_mma<80>(p, st);
    case 112: return launch_mma<112>(p, st);
    case 128: return launch_mma<128>(p, st);
    case 256: return launch_mma<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_simt(int64_t hd, const Params& p, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_simt<16>(p, st);
    case 32: return launch_simt<32>(p, st);
    case 64: return launch_simt<64>(p, st);
    case 80: return launch_simt<80>(p, st);
    case 112: return launch_simt<112>(p, st);
    case 128: return launch_simt<128>(p, st);
    case 256: return launch_simt<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Query heads per block: the largest divisor of G that fits `rows`; then
// as many query positions per head as fit.
void tile_rows(Params* p, int64_t Sq, int rows) {
  int hpb = p->group < rows ? p->group : rows;
  while (p->group % hpb) --hpb;
  p->heads_per_block = hpb;
  const int64_t per_head = rows / hpb;
  p->block_q = (int)(Sq < per_head ? Sq : per_head);
  p->n_groups = p->heads / hpb;
  p->n_qtiles = (Sq + p->block_q - 1) / p->block_q;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o (B, H, Sq, hd), each through
// its element strides (batch, head, position), which `strides` holds on the
// host: q, k, v, o, three each. Keys [0, kend) exist (kend <= Skv). `route`
// is 0 (SIMT prefill, float32), 1 (tensor-core prefill, bf16) or 2 (split-KV
// decode: G * Sq <= 16, keys [key_lo, key_hi) in n_split splits of split_len
// = 32 or 64, `scratch` float32 of B * H * Sq * n_split * (hd + 2)); route 2
// runs two kernels, the others one, all on `stream` of `device`. `lse`, when
// not null, takes each row's log-sum-exp of its scaled (and capped) scores,
// float32 (B, H, Sq) in natural-log units, for the backward; routes 0 and 1
// only. `o32` takes the output in float32 before its rounding to bf16, at
// o's element strides, where route 1 writes lse (and is null elsewhere):
// the backward's Delta from it is the exact rowsum(dO * P V). Returns the
// first CUDA error (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, float* lse, float* o32,
                               const int64_t* strides,
                               int64_t B,
                               int64_t H, int64_t KV, int64_t Sq, int64_t Skv,
                               int64_t kend, int64_t hd, int bf16, int causal,
                               int64_t window, float softcap, int64_t q_offset,
                               float scale, int route, int64_t key_lo,
                               int64_t key_hi, int64_t split_len,
                               int64_t n_split, void* scratch, void* stream,
                               int device) {
  (void)Skv;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.scratch = static_cast<float*>(scratch);
  p.lse = lse;
  p.o32 = o32;
  if ((o32 != nullptr) != (lse != nullptr && route == 1))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.batch = (int)B;
  p.heads = (int)H;
  p.group = (int)(H / KV);
  p.sq = Sq;
  p.kend = kend;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = scale;
  p.key_lo = key_lo;
  p.key_hi = key_hi;
  p.split_len = split_len;
  p.n_split = n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (route) {
    case 0:
      if (bf16) return (int)cudaErrorInvalidValue;
      tile_rows(&p, Sq, kRows);
      return dispatch_simt(hd, p, st);
    case 1:
      if (!bf16) return (int)cudaErrorInvalidValue;
      tile_rows(&p, Sq, kMmaRows);
      return dispatch_mma(hd, p, st);
    case 2:
      if (lse != nullptr || p.group * Sq > kDecodeRows || n_split < 1 || scratch == nullptr ||
          (split_len != 32 && split_len != kSplitKeys))
        return (int)cudaErrorInvalidValue;
      return bf16 ? dispatch_decode<__nv_bfloat16>(hd, p, KV, st)
                  : dispatch_decode<float>(hd, p, KV, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
