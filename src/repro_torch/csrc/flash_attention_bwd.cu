// Flash attention backward, bf16 on Hopper's tensor cores: dQ, dK and dV of
// every attention layer of gemma3-1b at each training step. A float32 route
// on the CUDA cores (flash_attention_bwd_f32, at the end of the file) takes
// float32 inputs.
//
// The TPU kernel it stands beside, _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:29, pallas_call at :113), has
// no backward: the reference trains through jax.value_and_grad of a jnp
// stand-in (src/repro/models/attention.py, attention_blockwise). The port's
// models call the CUDA forward (flash_attention.cu), so training needs this
// kernel; its plain version is flash_attention_bwd_ref
// (kernels/flash_attention_bwd/ref.py).
//
// Bound by operations: five products of the forward's size (S = Q K^T,
// dP = dO V^T, dV = P^T dO, dK = dS^T Q, dQ = dS K), 2.5 times the
// forward's 4 B H pairs hd: ~21.5 GFLOP at the gemma3-1b global layer
// (B 4, H 4, KV 1, S 1,024, hd 256, causal), ~21.7 us at 989 TFLOP/s.
//
// The forward wrote lse = m + ln l per (batch, head, query) row. With
// Delta_i = sum_d dO_i,d O_i,d, the backward of O = softmax(C) V, where
// C = softcap(S * scale) (C = S * scale without a softcap), is
//
//   P = exp(C - lse)        dV = P^T dO          dP = dO V^T
//   g = scale (1 - (C / cap)^2), or scale without a softcap
//   dS = (P (dP - Delta)) g dQ = dS K            dK = dS^T Q
//
// Rounding: S, dP, P, g and every sum are float32; P and dS are rounded to
// bf16 where they become tensor-core operands (dV, dK, dQ), as the forward
// rounds P before P V. The plain version computes the same expressions in
// the same order and rounds at the same places, so the two differ only in
// the order of float32 sums.
//
// Design (the Hopper primitives are in hopper.cuh). The launch plan is
// plan_bwd in kernels/flash_attention_bwd/kernel.py: the tiles' shapes, and
// a table of the tile walk (each launch position's key tile with its query
// tiles, each dQ position's row tile with its key tiles) that the kernels
// read and the CPU tests hold. What each part does about the earlier
// mma.sync form:
//   1. wgmma, not mma.sync + ldmatrix. Every product is a
//      wgmma.mma_async of 64-row tiles read from shared memory by
//      descriptor (128-, 64- or 32-byte swizzle by head dim; Q, K, V and dO
//      K-major, and MN-major through imm-trans-b where a product reduces
//      over their rows), float32 accumulators in registers, 64-key tiles.
//      At hd >= 128 two consumer warpgroups split each tile (the scores by
//      rows, the outputs by hd) and take 232 registers a thread while the
//      producer's drop to 40 (setmaxnreg; 384 threads launch at 168). P and
//      dS go to shared memory as bf16 in the 128-byte-swizzled K-major
//      layout the next product reads. Within a tile P is computed while dP
//      is still in flight, and dV's product runs while dS is computed.
//   2. A grid that fills and balances the card. dkdv_kernel has one block
//      per (batch, query head, key tile), not per KV head: 256 blocks at
//      the gemma3-1b global layer where the earlier form had 128. The
//      G = H / KV heads of a KV head are one thread-block cluster (the
//      largest divisor of G up to 8; several heads a block beyond that).
//      Key tiles launch longest first (key tile 0 first under the causal
//      mask), so the last wave is short. dq_kernel keeps the forward's
//      packing of a group's heads into 64-row tiles, longest first (the
//      last query tile under the causal mask).
//   3. S and dP are still computed twice: dq_kernel recomputes them, so
//      the backward runs seven products of the forward's size where five
//      would do. Folding dQ into dkdv_kernel would need a float32 dQ
//      scratch summed across key tiles in a fixed order; not done here.
//   4. The operands are copied by TMA, not by the SMs. One producer thread
//      keeps the next row tiles (dK/dV: Q, dO and their lse, Delta) or key
//      tiles (dQ: K, V) in flight with 4-D TMA loads over the model's
//      strided (B, S, heads, hd) storage (maps built on the host by
//      cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint),
//      two stages deep at hd 256 and four below, full / empty mbarriers
//      between it and the consumers.
//   delta_kernel: Delta in float32 (B, H, Sq), hd / 8 lanes a row, from
//      the forward's float32 O (its output before the rounding to bf16).
// No float atomics: after its walk each block of a cluster puts its float32
// dK and dV in shared memory, and each block sums a slice of them across
// the cluster through distributed shared memory in ascending rank (= head)
// order, rounding to bf16 once; dQ is summed inside one block. So two calls
// on the same inputs give bit-equal gradients. Keys past kend (and keys no
// query sees) get zero dK and dV: the K and V maps end at kend, so TMA
// fills those rows with zeros, and P = dS = 0 there.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using T = __nv_bfloat16;

constexpr int kTileRows = 64;   // keys of a key tile, rows of a row tile
constexpr int kMaxCluster = 8;

struct BwdParams {
  CUtensorMap tq_kv, tdo_kv;   // Q, dO boxes of the dK/dV row tiles
  CUtensorMap tq_q, tdo_q;     // Q, dO boxes of the dQ row tiles
  CUtensorMap tk, tv;          // K, V boxes of 64 keys (ending at kend)
  const float* o;              // the forward's output in float32
  const T* dout;
  int64_t os[3], dos[3];       // element strides: batch, head, position
  const float* lse;            // (B, H, Sq), natural log
  float* delta;                // (B, H, Sq)
  T* dq;
  T* dk;
  T* dv;
  int64_t dqs[3], dks[3], dvs[3];
  int batch;
  int heads;                   // H
  int kv_heads;                // KV
  int group;                   // G = H / KV
  int cluster;                 // blocks of a KV head's cluster
  int heads_per_block;         // G / cluster
  int kv_hpt, kv_bq;           // dK/dV row tiles: heads x queries
  int q_hpt, q_bq;             // dQ row tiles: heads x queries
  int n_ktiles, n_qtiles;
  // plan_bwd's tile table, int32, longest first: per dK/dV launch position
  // (key tile, first query tile, query tiles), n_ktiles of them; then per
  // dQ launch position (first query, first key tile, end key tile)
  const int* tiles;
  int64_t sq, skv, kend;
  int causal;
  int64_t window;              // <= 0: no window
  float softcap;               // <= 0: no softcap
  int64_t q_offset;
  float scale;
};

// The per-head-dim shape of both kernels. A head dim above 64 that is not
// a multiple of the 64-column swizzle span (zamba2-7b's 112) is laid out in
// shared memory as the next multiple, kPD (128): the tensor maps keep the
// true extent HD, so TMA fills columns HD..kPD-1 of each tile's last atom
// with zeros. The products that reduce over hd (S, dP) run HD / 16 k-steps
// and never read those columns; the products whose N is hd (dV, dK, dQ)
// run at kPD, where the zero columns of dO, Q and K give output columns
// that are never stored (dK, dV sum and store HD columns, dQ stores HD).
// So hd 112 runs the hd-128 shape: 128 / 112 = 1.14 times the tensor work
// of those three products, 1.09 times that of all five.
template <int HD>
struct Cfg {
  static constexpr int kPD = HD <= 64 ? HD : (HD + 63) / 64 * 64;
  static constexpr int kWG = kPD >= 128 ? 2 : 1;       // consumer warpgroups
  static constexpr int kThreads = 128 * (kWG + 1);      // + the producer's
  static constexpr int kCons = 128 * kWG;
  static constexpr int kSpanCols = kPD < 64 ? kPD : 64;  // bf16 a swizzled row
  static constexpr int kSpan = 2 * kSpanCols;           // bytes
  static constexpr int kAtoms = kPD / kSpanCols;
  static constexpr int kLayout = kPD >= 64 ? 1 : (kPD == 32 ? 2 : 3);
  static_assert(kPD % kSpanCols == 0 && HD % 16 == 0, "head dim");
  static constexpr uint32_t kSbo = 8 * kSpan;           // 8-row core group
  static constexpr uint32_t kAtomBytes = kTileRows * kSpan;
  static constexpr uint32_t kTile = kAtoms * kAtomBytes;   // 64 rows x kPD
  // stages of the Q, dO ring (dK/dV) and of the K, V ring (dQ): four
  // where shared memory holds them, so more copies are in flight
  static constexpr int kStages = kPD <= 128 ? 4 : 2;
  static constexpr int kNS = kTileRows / kWG;   // score columns a warpgroup
  static constexpr int kND = kPD / kWG;         // output dims a warpgroup
  static constexpr uint32_t kPS = kTileRows * 128;   // a 64 x 64 P or dS
  // dK/dV: K, V, the stages of Q and dO, P^T, dS^T, then the stages of
  // lse and Delta; the float32 dK, dV partials later reuse the front
  static constexpr uint32_t kKvBytes = (2 + 2 * kStages) * kTile + 2 * kPS;
  static constexpr uint32_t kPartPitch = kPD + 8;  // floats a partial row
  static_assert(2u * kTileRows * kPartPitch * 4 <= kKvBytes, "partials");
  // dQ: Q, dO, the stages of K and V, dS
  static constexpr uint32_t kQBytes = (2 + 2 * kStages) * kTile + kPS;
  static constexpr size_t kSmemKv =
      1024 + kKvBytes + 2 * 4 * kStages * kTileRows + 8 * (1 + 2 * kStages);
  static constexpr size_t kSmemQ = 1024 + kQBytes + 8 * (1 + 2 * kStages);
};

__device__ inline unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// K-major descriptor of a tile: rows row0.., the reduction dim k16 step kk.
template <int HD>
__device__ inline uint64_t kmajor(const unsigned char* tile, int row0,
                                  int kk) {
  using C = Cfg<HD>;
  const int col = 16 * kk;
  const uint32_t a = smem_u32(tile) + (col / C::kSpanCols) * C::kAtomBytes +
                     (col % C::kSpanCols) * 2 + row0 * C::kSpan;
  return gmma_desc(a, 16, C::kSbo, C::kLayout);
}

// MN-major descriptor of a tile as B: its rows the reduction dim (k16 step
// kk), columns col0.. (a multiple of the swizzle span) the N dim.
template <int HD>
__device__ inline uint64_t mnmajor(const unsigned char* tile, int col0,
                                   int kk) {
  using C = Cfg<HD>;
  const uint32_t a = smem_u32(tile) + (col0 / C::kSpanCols) * C::kAtomBytes +
                     16 * kk * C::kSpan;
  return gmma_desc(a, C::kAtomBytes, C::kSbo, C::kLayout);
}

// K-major descriptor of a 64 x 64 P / dS tile (128-byte swizzle).
__device__ inline uint64_t ps_desc(const unsigned char* tile, int kk) {
  return gmma_desc(smem_u32(tile) + 32 * kk, 16, 1024, 1);
}

// Byte offset of element (m, k) in a 64 x 64 K-major 128-byte-swizzled tile.
__device__ inline uint32_t ps_offset(int m, int k) {
  return m * 128 + ((((k >> 3) ^ m) & 7) << 4) + (k & 7) * 2;
}

// Zeroes rows [rows, 64) of each atom of `n` consecutive tiles: rows no TMA
// box writes (fewer packed rows than 64) must hold zeros, not stale data.
template <int HD>
__device__ inline void zero_tail_rows(unsigned char* tiles, int n, int rows) {
  using C = Cfg<HD>;
  if (rows >= kTileRows) return;
  const int per_atom = (kTileRows - rows) * C::kSpan / 16;
  const int total = n * C::kAtoms * per_atom;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int atom = i / per_atom;
    const int off = rows * C::kSpan + (i % per_atom) * 16;
    *reinterpret_cast<uint4*>(tiles + atom * C::kAtomBytes + off) =
        make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
}

// TMA of one 64-row tile (all atoms along hd) of `map` at (q0, h0, b).
template <int HD>
__device__ inline void load_tile(unsigned char* dst, const CUtensorMap* map,
                                 uint64_t* bar, int64_t pos0, int h0,
                                 int64_t b) {
  using C = Cfg<HD>;
#pragma unroll
  for (int a = 0; a < C::kAtoms; ++a)
    tma_load_4d(dst + a * C::kAtomBytes, map, bar, a * C::kSpanCols,
                (int)pos0, h0, (int)b);
}

// The causal, window and kend mask of one 64-key x row tile, in int32
// positions (queries and keys stay below 2^31). `full` when every pair of
// the tile is visible and every row exists, so the elementwise pass skips
// the per-element test.
struct TileMask {
  bool full;
  int kend, causal, window;

  __device__ TileMask(const BwdParams& p, int64_t key0, int64_t qmin,
                      int64_t qmax, bool rows_exist)
      : kend((int)p.kend), causal(p.causal), window((int)p.window) {
    full = rows_exist && key0 + kTileRows <= p.kend &&
           (!p.causal || key0 + kTileRows - 1 <= qmin) &&
           (p.window <= 0 || key0 > qmax - p.window);
  }

  __device__ bool visible(int key, int qpos) const {
    return key < kend && (!causal || key <= qpos) &&
           (window <= 0 || key > qpos - window);
  }
};

// The elementwise constants: P = exp2(s * c_s - lse2) without a softcap;
// with one, th = tanh(s * c_t), P = exp2(th * c_s - lse2) and dS carries
// scale (1 - th^2).
struct Consts {
  float c_s, c_t, scale;
  bool cap;

  __device__ explicit Consts(const BwdParams& p)
      : c_s((p.softcap > 0.f ? p.softcap : p.scale) * kLog2e),
        c_t(p.softcap > 0.f ? p.scale / p.softcap : 0.f),
        scale(p.scale),
        cap(p.softcap > 0.f) {}

  // P of score s (lse2 in log2 units); *g gets dS's factor
  __device__ float prob(float s, float lse2, float* g) const {
    if (cap) {
      const float th = tanhf(s * c_t);
      *g = scale * (1.f - th * th);
      return exp2f(th * c_s - lse2);
    }
    *g = scale;
    return exp2f(s * c_s - lse2);
  }
};

// Lanes of delta_kernel a row: HD / 8 16-byte chunks rounded up to a power
// of two (the shuffle tree's width; 16 at hd 112, two lanes idle), at most
// 32.
template <int HD>
__host__ __device__ constexpr int delta_lanes() {
  int n = 1;
  while (n < HD / 8 && n < 32) n *= 2;
  return n;
}

// Delta_i = sum_d dO_i,d O_i,d per (batch, head, query) row:
// delta_lanes<HD>() lanes a row, each summing 16-byte chunks, then a
// shuffle tree inside the row's lanes; 32 / delta_lanes rows a warp.
template <int HD>
__global__ void __launch_bounds__(256) delta_kernel(BwdParams p) {
  constexpr int chunks = HD / 8;
  constexpr int per_row = delta_lanes<HD>();
  const int lane = threadIdx.x & 31;
  const int64_t row =
      ((int64_t)blockIdx.x * 8 + (threadIdx.x >> 5)) * (32 / per_row) +
      lane / per_row;
  const int64_t rows = (int64_t)p.batch * p.heads * p.sq;
  float sum = 0.f;
  if (row < rows) {
    const int64_t i = row % p.sq;
    const int64_t h = (row / p.sq) % p.heads;
    const int64_t b = row / (p.sq * p.heads);
    const float* orow = p.o + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const T* drow = p.dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
    for (int c = lane % per_row; c < chunks; c += per_row) {
      const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const float4* o4 = reinterpret_cast<const float4*>(orow + 8 * c);
      const float4 a = o4[0], z = o4[1];
      const float of[8] = {a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 df = __bfloat1622float2(d2[e]);
        sum += of[2 * e] * df.x + of[2 * e + 1] * df.y;
      }
    }
  }
#pragma unroll
  for (int o = per_row / 2; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (row < rows && lane % per_row == 0) p.delta[row] = sum;
}

// mbarriers of dkdv_kernel: K and V landed; stage s of Q, dO (with its lse
// and Delta) full at kQFull + s, free at kQFull + kStages + s
enum { kKvFull = 0, kQFull = 1 };

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    dkdv_kernel(const __grid_constant__ BwdParams p) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = sK + C::kTile;
  unsigned char* sQ = sV + C::kTile;                 // kStages stages
  unsigned char* sdO = sQ + C::kStages * C::kTile;   // kStages stages
  unsigned char* sPt = sdO + C::kStages * C::kTile;
  unsigned char* sdSt = sPt + C::kPS;
  float* sLse = reinterpret_cast<float*>(smem + C::kKvBytes);  // [kStages][64]
  float* sDelta = sLse + C::kStages * kTileRows;                // [kStages][64]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sDelta + C::kStages * kTileRows);
  uint64_t* q_empty = bars + kQFull + C::kStages;

  // block -> (batch, KV head, rank, launch position); the table gives the
  // position's key tile and the query tiles that can see it
  const int rank = (int)(blockIdx.x % p.cluster);
  int64_t bid = blockIdx.x / p.cluster;
  const int kvh = (int)(bid % p.kv_heads);
  bid /= p.kv_heads;
  const int64_t b = bid % p.batch;
  const int* entry = p.tiles + 3 * (bid / p.batch);
  const int64_t key0 = (int64_t)entry[0] * kTileRows;
  const int64_t qt_lo = entry[1];
  const int64_t nq = entry[2];
  const int n_tiles = (int)(nq * (p.heads_per_block / p.kv_hpt));
  const int h_first = kvh * p.group + rank * p.heads_per_block;
  const int rows = p.kv_hpt * p.kv_bq;

  if (threadIdx.x == 0) {
    mbar_init(&bars[kKvFull], 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bars[kQFull + s], 33);   // the copies' + 32 lanes'
      mbar_init(&q_empty[s], C::kCons / 32);
    }
    mbar_init_fence();
  }
  zero_tail_rows<HD>(sQ, 2 * C::kStages, rows);   // every stage of Q, dO
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= C::kCons) {
    // ---- producer warpgroup: its first warp feeds the ring ----
    if constexpr (C::kWG == 2) reg_dealloc<40>();
    if (threadIdx.x < C::kCons + 32) {
      if (n_tiles > 0 && lane == 0) {
        mbar_arrive_tx(&bars[kKvFull], 2 * C::kTile);
        load_tile<HD>(sK, &p.tk, &bars[kKvFull], key0, kvh, b);
        load_tile<HD>(sV, &p.tv, &bars[kKvFull], key0, kvh, b);
      }
      const uint32_t bytes = 2u * 2u * C::kPD * rows;   // TMA counts the fill
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::kStages;
        if (t >= C::kStages)
          mbar_wait(&q_empty[s], (t / C::kStages - 1) & 1);
        const int h0 = h_first + (int)(t / nq) * p.kv_hpt;
        const int64_t q0 = (qt_lo + t % nq) * p.kv_bq;
        if (lane == 0) {   // the copies first, then this tile's lse, Delta
          mbar_arrive_tx(&bars[kQFull + s], bytes);
          load_tile<HD>(sQ + s * C::kTile, &p.tq_kv, &bars[kQFull + s], q0,
                        h0, b);
          load_tile<HD>(sdO + s * C::kTile, &p.tdo_kv, &bars[kQFull + s], q0,
                        h0, b);
        }
        for (int r = lane; r < kTileRows; r += 32) {
          const int64_t qi = q0 + r % p.kv_bq;
          float l2 = 0.f, d = 0.f;
          if (r < rows && qi < p.sq) {
            const int64_t idx = (b * p.heads + h0 + r / p.kv_bq) * p.sq + qi;
            l2 = p.lse[idx] * kLog2e;
            d = p.delta[idx];
          }
          sLse[s * kTileRows + r] = l2;
          sDelta[s * kTileRows + r] = d;
        }
        mbar_arrive(&bars[kQFull + s]);
      }
      __syncwarp();
    }
    cluster_sync();   // the partials are in shared memory
    cluster_sync();   // every block has read them
  } else {
    // ---- consumer warpgroups ----
    if constexpr (C::kWG == 2) reg_alloc<232>();
    const int wg = threadIdx.x / 128;
    const int wi = (threadIdx.x / 32) & 3;
    const int g = lane >> 2;
    const int tq = lane & 3;
    float dv[C::kND / 2], dk[C::kND / 2];
#pragma unroll
    for (int i = 0; i < C::kND / 2; ++i) dv[i] = dk[i] = 0.f;
    if (n_tiles > 0) mbar_wait(&bars[kKvFull], 0);

    const Consts cst(p);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::kStages;
      mbar_wait(&bars[kQFull + s], (t / C::kStages) & 1);
      const unsigned char* tQ = sQ + s * C::kTile;
      const unsigned char* tdO = sdO + s * C::kTile;
      // S^T = K Q^T and dP^T = V dO^T: 64 keys x this warpgroup's rows,
      // two groups, so P is computed while dP^T is still in flight
      float st[C::kNS / 2], dpt[C::kNS / 2], gs[C::kNS / 2];
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_bf16<C::kNS, 0>(st, kmajor<HD>(sK, 0, kk),
                              kmajor<HD>(tQ, wg * C::kNS, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_bf16<C::kNS, 0>(dpt, kmajor<HD>(sV, 0, kk),
                              kmajor<HD>(tdO, wg * C::kNS, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      const int64_t q0 = (qt_lo + t % nq) * p.kv_bq;
      const int64_t q_end = q0 + p.kv_bq < p.sq ? q0 + p.kv_bq : p.sq;
      const TileMask mask(p, key0, p.q_offset + q0, p.q_offset + q_end - 1,
                          rows == kTileRows && q0 + p.kv_bq <= p.sq);
      const int key_a = (int)key0 + 16 * wi + g;
      const float* lse = sLse + s * kTileRows + wg * C::kNS;
#pragma unroll
      for (int j = 0; j < C::kNS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 8 * j + 2 * tq + c;   // of this warpgroup's rows
          const float lse2 = lse[r];
          int qpos = 0;
          bool ok = true;
          if (!mask.full) {
            const int rr = wg * C::kNS + r;
            const int qi = (int)q0 + rr % p.kv_bq;
            ok = rr < rows && qi < p.sq;
            qpos = (int)p.q_offset + qi;
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 4 * j + 2 * half + c;
            const float pr = cst.prob(st[e], lse2, &gs[e]);
            st[e] = mask.full || (ok && mask.visible(key_a + 8 * half, qpos))
                        ? pr
                        : 0.f;
          }
        }
      }
      named_barrier(1, C::kCons);   // the last tile's P^T, dS^T are read
#pragma unroll
      for (int j = 0; j < C::kNS / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              sPt + ps_offset(16 * wi + g + 8 * half,
                              wg * C::kNS + 8 * j + 2 * tq)) =
              __floats2bfloat162_rn(st[4 * j + 2 * half],
                                    st[4 * j + 2 * half + 1]);
      fence_proxy_async();
      named_barrier(1, C::kCons);   // P^T complete
      // dV += P^T dO on this warpgroup's dims, in flight during dS
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        wgmma_bf16<C::kND, 1>(dv, ps_desc(sPt, kk),
                              mnmajor<HD>(tdO, wg * C::kND, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();   // dP^T has landed
      fence_regs(dpt);
      const float* dlt = sDelta + s * kTileRows + wg * C::kNS;
#pragma unroll
      for (int j = 0; j < C::kNS / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float delta = dlt[8 * j + 2 * tq + c];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 4 * j + 2 * half + c;
            dpt[e] = st[e] * (dpt[e] - delta) * gs[e];
          }
        }
      }
#pragma unroll
      for (int j = 0; j < C::kNS / 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<__nv_bfloat162*>(
              sdSt + ps_offset(16 * wi + g + 8 * half,
                               wg * C::kNS + 8 * j + 2 * tq)) =
              __floats2bfloat162_rn(dpt[4 * j + 2 * half],
                                    dpt[4 * j + 2 * half + 1]);
      fence_proxy_async();
      named_barrier(1, C::kCons);   // dS^T complete
      // dK += dS^T Q on this warpgroup's dims
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTileRows / 16; ++kk)
        wgmma_bf16<C::kND, 1>(dk, ps_desc(sdSt, kk),
                              mnmajor<HD>(tQ, wg * C::kND, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[s]);
    }

    // the block's float32 dK, dV (keys x dims) into shared memory
    named_barrier(1, C::kCons);   // every consumer is done with the tiles
    float* part = reinterpret_cast<float*>(smem);   // [2][64][kPartPitch]
#pragma unroll
    for (int i = 0; i < C::kND / 8; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * wi + g + 8 * half;
        const int d = wg * C::kND + 8 * i + 2 * tq;
        *reinterpret_cast<float2*>(part + m * C::kPartPitch + d) =
            make_float2(dk[4 * i + 2 * half], dk[4 * i + 2 * half + 1]);
        *reinterpret_cast<float2*>(part + (kTileRows + m) * C::kPartPitch +
                                   d) =
            make_float2(dv[4 * i + 2 * half], dv[4 * i + 2 * half + 1]);
      }
    }
    cluster_sync();
    // this rank's slice of the cluster's sum, heads in ascending order;
    // four chunks a round, so that their remote loads overlap; the HD
    // true columns of each row only
    constexpr int kChunks = HD / 4;   // float4 chunks a row
    constexpr int kTotal = 2 * kTileRows * kChunks;
    const uint32_t base = smem_u32(part);
    const int step = p.cluster * C::kCons;
    for (int idx0 = rank * C::kCons + threadIdx.x; idx0 < kTotal;
         idx0 += 4 * step) {
      float4 sum[4];
      uint32_t off[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = idx0 + u * step < kTotal ? idx0 + u * step : idx0;
        off[u] = base + 4u * ((idx / kChunks) * C::kPartPitch +
                              (idx % kChunks) * 4);
        sum[u] = ld_cluster_f4(cluster_map(off[u], 0));
      }
      for (int r = 1; r < p.cluster; ++r) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = ld_cluster_f4(cluster_map(off[u], r));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sum[u].x += v[u].x;
          sum[u].y += v[u].y;
          sum[u].z += v[u].z;
          sum[u].w += v[u].w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = idx0 + u * step;
        if (idx >= kTotal) continue;
        const int mat = idx / (kTileRows * kChunks);
        const int m = (idx / kChunks) % kTileRows;
        const int d = (idx % kChunks) * 4;
        const int64_t key = key0 + m;
        if (key >= p.skv) continue;
        T* row = mat == 0
                     ? p.dk + b * p.dks[0] + kvh * p.dks[1] + key * p.dks[2]
                     : p.dv + b * p.dvs[0] + kvh * p.dvs[1] + key * p.dvs[2];
        *reinterpret_cast<uint2*>(row + d) =
            make_uint2(bf16x2_bits(__floats2bfloat162_rn(sum[u].x, sum[u].y)),
                       bf16x2_bits(__floats2bfloat162_rn(sum[u].z, sum[u].w)));
      }
    }
    cluster_sync();
  }
}

// mbarriers of dq_kernel: Q and dO landed; stage s of K, V full at
// kKFull + s, free at kKFull + kStages + s
enum { kRowsFull = 0, kKFull = 1 };

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    dq_kernel(const __grid_constant__ BwdParams p) {
  using C = Cfg<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sdO = sQ + C::kTile;
  unsigned char* sK = sdO + C::kTile;   // kStages stages
  unsigned char* sV = sK + C::kStages * C::kTile;
  unsigned char* sdS = sV + C::kStages * C::kTile;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kQBytes);
  uint64_t* k_empty = bars + kKFull + C::kStages;

  // block -> (batch, head group, launch position); the table gives the
  // position's row tile and the key tiles its rows can see
  int64_t bid = blockIdx.x;
  const int64_t b = bid % p.batch;
  bid /= p.batch;
  const int n_groups = p.heads / p.q_hpt;
  const int h0 = (int)(bid % n_groups) * p.q_hpt;
  const int* entry = p.tiles + 3 * (p.n_ktiles + bid / n_groups);
  const int64_t q0 = entry[0];
  const int t_lo = entry[1];
  const int t_hi = entry[2];
  const int kvh = h0 / p.group;
  const int rows = p.q_hpt * p.q_bq;
  const int64_t last_q = (q0 + p.q_bq < p.sq ? q0 + p.q_bq : p.sq) - 1;

  if (threadIdx.x == 0) {
    mbar_init(&bars[kRowsFull], 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bars[kKFull + s], 1);
      mbar_init(&k_empty[s], C::kCons / 32);
    }
    mbar_init_fence();
  }
  zero_tail_rows<HD>(sQ, 2, rows);   // Q and dO
  __syncthreads();

  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= C::kCons) {
    // ---- producer: one thread issues every copy ----
    if (threadIdx.x != C::kCons || t_lo >= t_hi) return;
    mbar_arrive_tx(&bars[kRowsFull], 2u * 2u * C::kPD * rows);
    load_tile<HD>(sQ, &p.tq_q, &bars[kRowsFull], q0, h0, b);
    load_tile<HD>(sdO, &p.tdo_q, &bars[kRowsFull], q0, h0, b);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo;
      const int s = i % C::kStages;
      if (i >= C::kStages) mbar_wait(&k_empty[s], (i / C::kStages - 1) & 1);
      mbar_arrive_tx(&bars[kKFull + s], 2 * C::kTile);
      load_tile<HD>(sK + s * C::kTile, &p.tk, &bars[kKFull + s],
                    (int64_t)t * kTileRows, kvh, b);
      load_tile<HD>(sV + s * C::kTile, &p.tv, &bars[kKFull + s],
                    (int64_t)t * kTileRows, kvh, b);
    }
    return;
  }

  // ---- consumer warpgroups: rows 16 wi + g and + 8 of the 64 ----
  const int wg = threadIdx.x / 128;
  const int wi = (threadIdx.x / 32) & 3;
  const int g = lane >> 2;
  const int tq = lane & 3;
  int qpos[2];
  float lse2[2], delta[2];
  bool valid[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * wi + g + 8 * half;
    const int64_t qi = q0 + r % p.q_bq;
    valid[half] = r < rows && qi < p.sq;
    qpos[half] = (int)(p.q_offset + qi);
    lse2[half] = delta[half] = 0.f;
    if (valid[half]) {
      const int64_t idx = (b * p.heads + h0 + r / p.q_bq) * p.sq + qi;
      lse2[half] = p.lse[idx] * kLog2e;
      delta[half] = p.delta[idx];
    }
  }
  const Consts cst(p);
  const bool rows_exist = rows == kTileRows && q0 + p.q_bq <= p.sq;
  float acc[C::kND / 2];
#pragma unroll
  for (int i = 0; i < C::kND / 2; ++i) acc[i] = 0.f;
  if (t_lo < t_hi) mbar_wait(&bars[kRowsFull], 0);

  for (int t = t_lo; t < t_hi; ++t) {
    const int i = t - t_lo;
    const int s = i % C::kStages;
    mbar_wait(&bars[kKFull + s], (i / C::kStages) & 1);
    const unsigned char* tK = sK + s * C::kTile;
    const unsigned char* tV = sV + s * C::kTile;
    // S = Q K^T and dP = dO V^T: 64 rows x this warpgroup's keys
    float sc[C::kNS / 2], dp[C::kNS / 2], gs[C::kNS / 2];
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_bf16<C::kNS, 0>(sc, kmajor<HD>(sQ, 0, kk),
                            kmajor<HD>(tK, wg * C::kNS, kk), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_bf16<C::kNS, 0>(dp, kmajor<HD>(sdO, 0, kk),
                            kmajor<HD>(tV, wg * C::kNS, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P while dP is in flight
    const int64_t key0 = (int64_t)t * kTileRows;
    const TileMask mask(p, key0, p.q_offset + q0, p.q_offset + last_q,
                        rows_exist);
    const int key_w = (int)key0 + wg * C::kNS + 2 * tq;
#pragma unroll
    for (int j = 0; j < C::kNS / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * half + c;
          const float pr = cst.prob(sc[e], lse2[half], &gs[e]);
          sc[e] = mask.full || (valid[half] &&
                                mask.visible(key_w + 8 * j + c, qpos[half]))
                      ? pr
                      : 0.f;
        }
    wgmma_wait<0>();
    fence_regs(dp);
    named_barrier(1, C::kCons);   // the last tile's dS is read
#pragma unroll
    for (int j = 0; j < C::kNS / 8; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float ds[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * half + c;
          ds[c] = sc[e] * (dp[e] - delta[half]) * gs[e];
        }
        *reinterpret_cast<__nv_bfloat162*>(
            sdS + ps_offset(16 * wi + g + 8 * half,
                            wg * C::kNS + 8 * j + 2 * tq)) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      }
    }
    fence_proxy_async();
    named_barrier(1, C::kCons);   // dS complete
    // dQ += dS K on this warpgroup's dims
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk)
      wgmma_bf16<C::kND, 1>(acc, ps_desc(sdS, kk),
                            mnmajor<HD>(tK, wg * C::kND, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&k_empty[s]);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!valid[half]) continue;
    const int r = 16 * wi + g + 8 * half;
    const int64_t qi = q0 + r % p.q_bq;
    const int64_t h = h0 + r / p.q_bq;
    T* row = p.dq + b * p.dqs[0] + h * p.dqs[1] + qi * p.dqs[2] +
             wg * C::kND;
#pragma unroll
    for (int j = 0; j < C::kND / 8; ++j)
      if (wg * C::kND + 8 * j < HD)   // not the padding columns
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                  acc[4 * j + 2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so
// the library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map (hd, positions, heads, batch) over bf16 storage with element
// strides `st` (batch, head, position), boxes of (swizzle span, box_pos,
// box_heads, 1).
template <int HD>
int encode(CUtensorMap* map, const void* ptr, const int64_t* st, int64_t B,
           int64_t heads, int64_t positions, int box_pos, int box_heads) {
  using C = Cfg<HD>;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)positions,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kSpanCols, (cuuint32_t)box_pos,
                             (cuuint32_t)box_heads, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      C::kLayout == 1 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (C::kLayout == 2 ? CU_TENSOR_MAP_SWIZZLE_64B
                                         : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_bwd(BwdParams& p, const void* q, const void* k, const void* v,
               const int64_t* strides, cudaStream_t st) {
  using C = Cfg<HD>;
  const int64_t* qs = strides;
  const int64_t* ks = strides + 3;
  const int64_t* vs = strides + 6;
  const int64_t* dos = strides + 12;
  int err = encode<HD>(&p.tq_kv, q, qs, p.batch, p.heads, p.sq, p.kv_bq,
                       p.kv_hpt);
  if (!err) err = encode<HD>(&p.tdo_kv, p.dout, dos, p.batch, p.heads, p.sq,
                             p.kv_bq, p.kv_hpt);
  if (!err) err = encode<HD>(&p.tq_q, q, qs, p.batch, p.heads, p.sq, p.q_bq,
                             p.q_hpt);
  if (!err) err = encode<HD>(&p.tdo_q, p.dout, dos, p.batch, p.heads, p.sq,
                             p.q_bq, p.q_hpt);
  if (!err) err = encode<HD>(&p.tk, k, ks, p.batch, p.kv_heads, p.kend,
                             kTileRows, 1);
  if (!err) err = encode<HD>(&p.tv, v, vs, p.batch, p.kv_heads, p.kend,
                             kTileRows, 1);
  if (err) return err;
  static bool kv_configured = false, q_configured = false;
  if (int e = allow_smem(dkdv_kernel<HD>, C::kSmemKv, &kv_configured))
    return e;
  if (int e = allow_smem(dq_kernel<HD>, C::kSmemQ, &q_configured)) return e;

  const int64_t rows = (int64_t)p.batch * p.heads * p.sq;
  const int64_t rows_a_block = 8 * (32 / delta_lanes<HD>());
  delta_kernel<HD><<<(unsigned)((rows + rows_a_block - 1) / rows_a_block),
                     256, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((int64_t)p.batch * p.kv_heads * p.cluster *
                                p.n_ktiles));
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmemKv;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dkdv_kernel<HD>, p);
  if (e != cudaSuccess) return (int)e;

  const int64_t q_blocks =
      (int64_t)p.batch * (p.heads / p.q_hpt) * p.n_qtiles;
  dq_kernel<HD><<<(unsigned)q_blocks, C::kThreads, C::kSmemQ, st>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The float32 route: SIMT on the CUDA cores (the forward's float32 prefill
// route, flash_kernel<float, HD> in flash_attention.cu, writes the lse it
// reads). The same three steps and the same contract as the bf16 route:
// Delta, then dK/dV, then dQ, every sum in float32 in a fixed order and no
// float atomics, so two calls give bit-equal gradients; no rounding of P or
// dS, so the plain version (flash_attention_bwd_ref) is the exact gradient.
//
// Bound by operations on the CUDA cores (67 TFLOP/s in float32): the five
// products of the bf16 route, ~21.5 GFLOP at gemma3-1b's global layer and
// at granite-moe-1b-a400m's layer, ~0.32 ms. This first form is simple, not
// fast: 32 x 32 tiles in shared memory (rows padded by one float, so a
// warp's 16 key rows fall in 16 banks), 256 threads, each thread two rows
// by two keys of S and dP, then eight threads a key (dK/dV) or a query row
// (dQ) along hd. dkdv_f32_kernel is one block per (batch, KV head, 32-key
// tile) that walks the G heads of its KV head one after another, so the
// group's sum is a loop in one block, not a cluster; dq_f32_kernel is one
// block per (batch, head, 32-query tile).

constexpr int kF32Threads = 256;
constexpr int kF32Tile = 32;                 // keys of a key tile, queries
constexpr int kF32PsPitch = kF32Tile + 1;    // floats a P / dS row

struct F32Params {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  int64_t qs[3], ks[3], vs[3], os[3], dos[3];   // batch, head, position
  const float* lse;            // (B, H, Sq), natural log
  float* delta;                // (B, H, Sq)
  float* dq;
  float* dk;
  float* dv;
  int64_t dqs[3], dks[3], dvs[3];
  int64_t batch;
  int heads, kv_heads, group;
  int64_t sq, skv, kend;
  int causal;
  int64_t window;              // <= 0: no window
  float softcap;               // <= 0: no softcap
  int64_t q_offset;
  float scale;
};

template <int HD>
constexpr size_t f32_smem_bytes() {
  // K, V, Q, dO tiles (pitch HD + 1), P and dS, lse and Delta
  return sizeof(float) * (4 * kF32Tile * (HD + 1) +
                          2 * kF32Tile * kF32PsPitch + 2 * kF32Tile);
}

// Delta_i = sum_d dO_i,d O_i,d, one warp a (batch, head, query) row.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    delta_f32_kernel(const F32Params p) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kF32Threads / 32) +
                      (threadIdx.x >> 5);
  if (row >= p.batch * p.heads * p.sq) return;   // the whole warp
  const int64_t i = row % p.sq;
  const int64_t h = (row / p.sq) % p.heads;
  const int64_t b = row / (p.sq * p.heads);
  const float* orow = p.o + b * p.os[0] + h * p.os[1] + i * p.os[2];
  const float* drow = p.dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
  float sum = 0.f;
  for (int d = lane; d < HD; d += 32) sum += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[row] = sum;
}

// Copies rows [pos0, pos0 + 32) of one head into a padded tile; rows at or
// past `end` are zeros.
template <int HD>
__device__ inline void f32_tile(float* dst, const float* base,
                                const int64_t* st, int64_t b, int64_t h,
                                int64_t pos0, int64_t end) {
  for (int e = threadIdx.x; e < kF32Tile * HD; e += kF32Threads) {
    const int r = e / HD;
    const int d = e % HD;
    const int64_t pos = pos0 + r;
    dst[r * (HD + 1) + d] =
        pos < end ? base[b * st[0] + h * st[1] + pos * st[2] + d] : 0.f;
  }
}

// S and dP of the 32 x 32 tile pair, two rows by two keys a thread, then P
// and dS into shared memory (zero where the pair is masked or the row
// does not exist). Writes dS only when `ps` is null.
template <int HD>
__device__ inline void f32_scores(const F32Params& p, const float* sQ,
                                  const float* sdO, const float* sK,
                                  const float* sV, const float* sLse,
                                  const float* sDelta, int64_t q0,
                                  int64_t key0, float* ps, float* ds) {
  constexpr int P = HD + 1;
  const int i0 = (threadIdx.x / 16) * 2;
  const int j0 = (threadIdx.x % 16) * 2;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  float dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float qa = sQ[i0 * P + d], qb = sQ[(i0 + 1) * P + d];
    const float oa = sdO[i0 * P + d], ob = sdO[(i0 + 1) * P + d];
    const float ka = sK[j0 * P + d], kb = sK[(j0 + 1) * P + d];
    const float va = sV[j0 * P + d], vb = sV[(j0 + 1) * P + d];
    s[0][0] += qa * ka;
    s[0][1] += qa * kb;
    s[1][0] += qb * ka;
    s[1][1] += qb * kb;
    dp[0][0] += oa * va;
    dp[0][1] += oa * vb;
    dp[1][0] += ob * va;
    dp[1][1] += ob * vb;
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = i0 + a;
    const int64_t qi = q0 + i;
    const int64_t qpos = p.q_offset + qi;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + c;
      const int64_t key = key0 + j;
      const bool ok = qi < p.sq && key < p.kend &&
                      (!p.causal || key <= qpos) &&
                      (p.window <= 0 || key > qpos - p.window);
      float x = s[a][c] * p.scale;
      float g = p.scale;
      if (p.softcap > 0.f) {
        const float th = tanhf(x / p.softcap);
        x = p.softcap * th;
        g = (1.f - th * th) * p.scale;
      }
      const float pr = ok ? expf(x - sLse[i]) : 0.f;
      if (ps != nullptr) ps[i * kF32PsPitch + j] = pr;
      ds[i * kF32PsPitch + j] = pr * (dp[a][c] - sDelta[i]) * g;
    }
  }
}

// lse and Delta of rows [q0, q0 + 32) of head h (zero past Sq).
__device__ inline void f32_row_stats(const F32Params& p, float* sLse,
                                     float* sDelta, int64_t b, int64_t h,
                                     int64_t q0) {
  if (threadIdx.x < kF32Tile) {
    const int64_t qi = q0 + threadIdx.x;
    const int64_t at = (b * p.heads + h) * p.sq + qi;
    sLse[threadIdx.x] = qi < p.sq ? p.lse[at] : 0.f;
    sDelta[threadIdx.x] = qi < p.sq ? p.delta[at] : 0.f;
  }
}

// dK and dV of one 32-key tile of one KV head: the G query heads in
// ascending order, each over the query tiles that see the key tile, each
// tile's rows in ascending order; eight threads a key, dims t % 8 + 8 m.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    dkdv_f32_kernel(const F32Params p) {
  constexpr int P = HD + 1;
  constexpr int kDims = HD / 8;
  extern __shared__ float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + kF32Tile * P;
  float* sQ = sV + kF32Tile * P;
  float* sdO = sQ + kF32Tile * P;
  float* sP = sdO + kF32Tile * P;
  float* sdS = sP + kF32Tile * kF32PsPitch;
  float* sLse = sdS + kF32Tile * kF32PsPitch;
  float* sDelta = sLse + kF32Tile;

  const int64_t key0 = (int64_t)blockIdx.x * kF32Tile;
  const int64_t kvh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int j = threadIdx.x / 8;
  const int dlane = threadIdx.x % 8;
  float dk[kDims], dv[kDims];
#pragma unroll
  for (int m = 0; m < kDims; ++m) dk[m] = dv[m] = 0.f;

  // queries [lo, hi) that can see some key of the tile
  const int64_t k1 = key0 + kF32Tile < p.kend ? key0 + kF32Tile : p.kend;
  int64_t lo = 0, hi = 0;
  if (k1 > key0) {
    lo = p.causal && key0 - p.q_offset > 0 ? key0 - p.q_offset : 0;
    hi = p.sq;
    if (p.window > 0 && k1 - 1 + p.window - p.q_offset < hi)
      hi = k1 - 1 + p.window - p.q_offset;
  }
  if (hi > lo) {
    f32_tile<HD>(sK, p.k, p.ks, b, kvh, key0, p.kend);
    f32_tile<HD>(sV, p.v, p.vs, b, kvh, key0, p.kend);
  }
  for (int g = 0; g < p.group; ++g) {
    const int64_t h = kvh * p.group + g;
    for (int64_t q0 = lo - lo % kF32Tile; q0 < hi; q0 += kF32Tile) {
      __syncthreads();   // the last tile's Q, dO, P and dS are read
      f32_tile<HD>(sQ, p.q, p.qs, b, h, q0, p.sq);
      f32_tile<HD>(sdO, p.dout, p.dos, b, h, q0, p.sq);
      f32_row_stats(p, sLse, sDelta, b, h, q0);
      __syncthreads();
      f32_scores<HD>(p, sQ, sdO, sK, sV, sLse, sDelta, q0, key0, sP, sdS);
      __syncthreads();
      for (int i = 0; i < kF32Tile; ++i) {
        const float pr = sP[i * kF32PsPitch + j];
        const float ds = sdS[i * kF32PsPitch + j];
#pragma unroll
        for (int m = 0; m < kDims; ++m) {
          dv[m] += pr * sdO[i * P + dlane + 8 * m];
          dk[m] += ds * sQ[i * P + dlane + 8 * m];
        }
      }
    }
  }
  const int64_t key = key0 + j;
  if (key < p.skv) {
    float* dkrow = p.dk + b * p.dks[0] + kvh * p.dks[1] + key * p.dks[2];
    float* dvrow = p.dv + b * p.dvs[0] + kvh * p.dvs[1] + key * p.dvs[2];
#pragma unroll
    for (int m = 0; m < kDims; ++m) {
      dkrow[dlane + 8 * m] = dk[m];
      dvrow[dlane + 8 * m] = dv[m];
    }
  }
}

// dQ of one 32-query tile of one head: the key tiles it sees in ascending
// order, each tile's keys in ascending order; eight threads a query row.
template <int HD>
__global__ void __launch_bounds__(kF32Threads)
    dq_f32_kernel(const F32Params p) {
  constexpr int P = HD + 1;
  constexpr int kDims = HD / 8;
  extern __shared__ float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + kF32Tile * P;
  float* sQ = sV + kF32Tile * P;
  float* sdO = sQ + kF32Tile * P;
  float* sdS = sdO + kF32Tile * P + kF32Tile * kF32PsPitch;
  float* sLse = sdS + kF32Tile * kF32PsPitch;
  float* sDelta = sLse + kF32Tile;

  const int64_t q0 = (int64_t)blockIdx.x * kF32Tile;
  const int64_t h = blockIdx.y;
  const int64_t kvh = h / p.group;
  const int64_t b = blockIdx.z;
  const int i = threadIdx.x / 8;
  const int dlane = threadIdx.x % 8;
  float dq[kDims];
#pragma unroll
  for (int m = 0; m < kDims; ++m) dq[m] = 0.f;

  f32_tile<HD>(sQ, p.q, p.qs, b, h, q0, p.sq);
  f32_tile<HD>(sdO, p.dout, p.dos, b, h, q0, p.sq);
  f32_row_stats(p, sLse, sDelta, b, h, q0);
  // keys [lo, hi) that some query of the tile can see
  const int64_t last_q = (q0 + kF32Tile < p.sq ? q0 + kF32Tile : p.sq) - 1;
  int64_t lo = 0, hi = p.kend;
  if (p.window > 0 && p.q_offset + q0 - p.window + 1 > 0)
    lo = p.q_offset + q0 - p.window + 1;
  if (p.causal && p.q_offset + last_q + 1 < hi) hi = p.q_offset + last_q + 1;
  for (int64_t key0 = lo - lo % kF32Tile; key0 < hi; key0 += kF32Tile) {
    __syncthreads();   // Q, dO staged; the last tile's K, V and dS are read
    f32_tile<HD>(sK, p.k, p.ks, b, kvh, key0, p.kend);
    f32_tile<HD>(sV, p.v, p.vs, b, kvh, key0, p.kend);
    __syncthreads();
    f32_scores<HD>(p, sQ, sdO, sK, sV, sLse, sDelta, q0, key0, nullptr, sdS);
    __syncthreads();
    for (int jj = 0; jj < kF32Tile; ++jj) {
      const float ds = sdS[i * kF32PsPitch + jj];
#pragma unroll
      for (int m = 0; m < kDims; ++m) dq[m] += ds * sK[jj * P + dlane + 8 * m];
    }
  }
  const int64_t qi = q0 + i;
  if (qi < p.sq) {
    float* row = p.dq + b * p.dqs[0] + h * p.dqs[1] + qi * p.dqs[2];
#pragma unroll
    for (int m = 0; m < kDims; ++m) row[dlane + 8 * m] = dq[m];
  }
}

template <int HD>
int launch_bwd_f32(const F32Params& p, cudaStream_t st) {
  constexpr size_t smem = f32_smem_bytes<HD>();
  static bool kv_configured = false, q_configured = false;
  if (int e = allow_smem(dkdv_f32_kernel<HD>, smem, &kv_configured)) return e;
  if (int e = allow_smem(dq_f32_kernel<HD>, smem, &q_configured)) return e;
  const int64_t rows = p.batch * p.heads * p.sq;
  const int64_t rows_a_block = kF32Threads / 32;
  delta_f32_kernel<HD><<<(unsigned)((rows + rows_a_block - 1) / rows_a_block),
                         kF32Threads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_f32_kernel<HD><<<dim3((unsigned)((p.skv + kF32Tile - 1) / kF32Tile),
                             (unsigned)p.kv_heads, (unsigned)p.batch),
                        kF32Threads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_f32_kernel<HD><<<dim3((unsigned)((p.sq + kF32Tile - 1) / kF32Tile),
                           (unsigned)p.heads, (unsigned)p.batch),
                      kF32Threads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd) and dout (B, H, Sq, hd), each
// bf16, and o (B, H, Sq, hd), the forward's float32 output before its
// rounding (Delta from it is exact where a bf16 O would round away the
// difference dP - Delta of nearly equal rows), each through its element
// strides (batch, head, position; unit stride along hd, 16-byte aligned base
// and strides), which `strides` holds on the host: q, k, v, o, dout, dq, dk,
// dv, three each. lse: the forward's float32
// (B, H, Sq); delta: float32 scratch of the same shape. Writes dq (B, H, Sq,
// hd) and dk, dv (B, KV, Skv, hd), bf16, through their strides. Keys
// [0, kend) exist (1 <= kend <= Skv); window <= 0 and softcap <= 0 mean none.
// `plan` is plan_bwd's (kernels/flash_attention_bwd/kernel.py): cluster,
// heads x queries of a dK/dV row tile, heads x queries of a dQ row tile;
// `tiles` its int32 tile table on the device (BwdParams::tiles: 3 ints for
// each of the ceil(Skv / 64) dK/dV positions, then for each of the
// ceil(Sq / dQ's queries a tile) dQ positions). Three launches on `stream`
// of `device`; returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int64_t* strides, int64_t B, int64_t H, int64_t KV,
    int64_t Sq, int64_t Skv, int64_t kend, int64_t hd, int causal,
    int64_t window, float softcap, int64_t q_offset, float scale,
    const int64_t* plan, const int* tiles, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 || kend < 1 || kend > Skv)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  for (int i = 0; i < 3; ++i) {
    p.os[i] = strides[9 + i];
    p.dos[i] = strides[12 + i];
    p.dqs[i] = strides[15 + i];
    p.dks[i] = strides[18 + i];
    p.dvs[i] = strides[21 + i];
  }
  p.batch = (int)B;
  p.heads = (int)H;
  p.kv_heads = (int)KV;
  p.group = (int)(H / KV);
  p.cluster = (int)plan[0];
  p.kv_hpt = (int)plan[1];
  p.kv_bq = (int)plan[2];
  p.q_hpt = (int)plan[3];
  p.q_bq = (int)plan[4];
  p.tiles = tiles;
  // the plan's invariants (plan_bwd holds them; a wrong plan would leave
  // rows or heads unvisited)
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.group % p.cluster ||
      p.kv_hpt < 1 || (p.group / p.cluster) % p.kv_hpt || p.kv_bq < 1 ||
      p.kv_hpt * p.kv_bq > kTileRows || p.q_hpt < 1 || p.group % p.q_hpt ||
      p.q_bq < 1 || p.q_hpt * p.q_bq > kTileRows)
    return (int)cudaErrorInvalidValue;
  p.heads_per_block = p.group / p.cluster;
  p.n_ktiles = (int)((Skv + kTileRows - 1) / kTileRows);
  p.n_qtiles = (int)((Sq + p.q_bq - 1) / p.q_bq);
  if (tiles == nullptr) return (int)cudaErrorInvalidValue;
  p.sq = Sq;
  p.skv = Skv;
  p.kend = kend;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bwd<16>(p, q, k, v, strides, st);
    case 32: return launch_bwd<32>(p, q, k, v, strides, st);
    case 64: return launch_bwd<64>(p, q, k, v, strides, st);
    case 112: return launch_bwd<112>(p, q, k, v, strides, st);
    case 128: return launch_bwd<128>(p, q, k, v, strides, st);
    case 256: return launch_bwd<256>(p, q, k, v, strides, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The float32 route (see F32Params): the same tensors as
// flash_attention_bwd, float32 through their element strides (unit stride
// along hd), no plan and no tile table. Three launches on `stream` of
// `device`; returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd_f32(
    const float* q, const float* k, const float* v, const float* o,
    const float* dout, const float* lse, float* delta, float* dq, float* dk,
    float* dv, const int64_t* strides, int64_t B, int64_t H, int64_t KV,
    int64_t Sq, int64_t Skv, int64_t kend, int64_t hd, int causal,
    int64_t window, float softcap, int64_t q_offset, float scale,
    void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1 || kend < 1 ||
      kend > Skv || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  F32Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
    p.dos[i] = strides[12 + i];
    p.dqs[i] = strides[15 + i];
    p.dks[i] = strides[18 + i];
    p.dvs[i] = strides[21 + i];
  }
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.batch = B;
  p.heads = (int)H;
  p.kv_heads = (int)KV;
  p.group = (int)(H / KV);
  p.sq = Sq;
  p.skv = Skv;
  p.kend = kend;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bwd_f32<16>(p, st);
    case 32: return launch_bwd_f32<32>(p, st);
    case 64: return launch_bwd_f32<64>(p, st);
    case 112: return launch_bwd_f32<112>(p, st);
    case 128: return launch_bwd_f32<128>(p, st);
    case 256: return launch_bwd_f32<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
