// Flash attention backward, bf16 on the tensor cores: dQ, dK and dV of every
// attention layer of gemma3-1b at each training step.
//
// The TPU kernel it stands beside, _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:29, pallas_call at :113), has
// no backward: the reference trains through jax.value_and_grad of a jnp
// stand-in (src/repro/models/attention.py, attention_blockwise). The port's
// models call the CUDA forward (flash_attention.cu), so training needs this
// kernel; its plain version is flash_attention_bwd_ref
// (kernels/flash_attention_bwd/ref.py).
//
// Bound by operations: the gemma3-1b global layer (B 4, H 4, KV 1, S 1,024,
// hd 256) needs 2.5 times the forward's 4 B H pairs hd, ~21.5 GFLOP, ~21.7 us
// at 989 TFLOP/s. This first form recomputes S and dP in both kernels below
// (7 products of the forward's size, not 5) so that neither needs atomics.
//
// The forward wrote lse = m + ln l per (batch, head, query) row. With
// Delta_i = sum_d dO_i,d O_i,d, the backward of O = softmax(C) V, where
// C = softcap(S * scale) (C = S * scale without a softcap), is
//
//   P = exp(C - lse)        dV = P^T dO          dP = dO V^T
//   dC = P o (dP - Delta)   dS = dC o (1 - (C / cap)^2) * scale
//   dQ = dS K               dK = dS^T Q
//
// Rounding: S, dP, P, dS and every sum are float32; P and dS are rounded to
// bf16 as the A operands of their tensor-core products (dV, dK, dQ), as the
// forward rounds P before P V. The plain version rounds them at the same
// places, so the two differ only in the order of float32 sums.
//
// Three launches:
//   delta_kernel: one warp per row, Delta in float32 (B, H, Sq).
//   dkdv_kernel: one block of 8 warps per (batch, KV head, tile of 32 keys).
//     It walks every row tile that can see its keys: the G query heads of
//     the group packed into 64-row tiles with their queries (as the forward
//     packs them), only the query tiles inside the causal, window and kend
//     bounds, each tile's Q and dO rows double-buffered through cp.async.
//     Per row tile: the 8 warps compute S and dP (64 x 32, a 16 x 16 block
//     each) and write P and dS to shared memory in bf16; then each warp owns
//     16 keys x HD/4 dims of dV += P^T dO and dK += dS^T Q (ldmatrix.trans
//     reads P^T and dS^T). Summing the group's heads inside the block keeps
//     GQA free of atomics. At hd 256 a 32-key dK + dV accumulator is 64 KB of
//     float32: 64 registers a thread over 256 threads.
//   dq_kernel: one block of 8 warps per (batch, KV group, 64-row tile), the
//     rows packed as in the forward; it walks the key tiles the rows can see
//     (K and V double-buffered), recomputes S, dP and dS the same way and
//     accumulates dQ += dS K, each warp 16 rows x HD/2 dims. Deterministic:
//     no float atomics anywhere.
// Both big kernels read q, k, v, dO and O through element strides (the
// model's (B, S, H, hd) storage seen as (B, H, S, hd)) and write dQ, dK, dV
// through the strides of the (B, S, heads, hd) storage the wrapper allocates.
// Keys past kend and keys no query sees get zero dK and dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using T = __nv_bfloat16;

struct BwdParams {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;     // (B, H, Sq), natural log
  float* delta;         // (B, H, Sq)
  T* dq;
  T* dk;
  T* dv;
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int batch;
  int heads;            // H
  int kv_heads;         // KV
  int group;            // G = H / KV
  int heads_per_block;  // query heads packed into a 64-row tile
  int block_q;          // queries per row tile
  int n_hblocks;        // G / heads_per_block
  int64_t n_qtiles;     // ceil(Sq / block_q)
  int64_t n_ktiles;     // ceil(Skv / kBwdKeys)
  int64_t sq, skv, kend;
  int causal;
  int64_t window;       // <= 0: no window
  float softcap;        // <= 0: no softcap
  int64_t q_offset;
  float scale;
};

constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 64;   // (head, query) rows per tile
constexpr int kBwdKeys = 32;   // keys per tile
constexpr int kLdp = kBwdKeys + 8;   // bf16 per row of P / dS: 16-byte pad

template <int HD>
struct BwdTile {
  static constexpr int kLd = HD + 8;   // bf16 per shared row: 16-byte pad
  // dK/dV: K, V; two stages of Q and dO rows; P and dS
  static constexpr size_t kSmemKV =
      sizeof(T) * (kLd * (2 * kBwdKeys + 4 * kBwdRows) + 2 * kBwdRows * kLdp);
  // dQ: Q and dO rows; two stages of K and V; dS
  static constexpr size_t kSmemQ =
      sizeof(T) * (kLd * (2 * kBwdRows + 4 * kBwdKeys) + kBwdRows * kLdp);
};

// Delta_i = sum_d dO_i,d O_i,d: one warp per (batch, head, query) row.
__global__ void __launch_bounds__(kBwdThreads) delta_kernel(BwdParams p,
                                                            int hd) {
  const int64_t row = (int64_t)blockIdx.x * kBwdWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int64_t rows = (int64_t)p.batch * p.heads * p.sq;
  if (row >= rows) return;
  const int64_t i = row % p.sq;
  const int64_t h = (row / p.sq) % p.heads;
  const int64_t b = row / (p.sq * p.heads);
  const T* orow = p.o + b * p.os[0] + h * p.os[1] + i * p.os[2];
  const T* drow = p.dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
  float sum = 0.f;
  for (int c = lane; c < hd / 8; c += 32) {
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
    const uint4 dv = *reinterpret_cast<const uint4*>(drow + 8 * c);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = __bfloat1622float2(o2[e]);
      const float2 df = __bfloat1622float2(d2[e]);
      sum += of.x * df.x + of.y * df.y;
    }
  }
  sum = warp_sum(sum);
  if (lane == 0) p.delta[row] = sum;
}

// One row tile: hpb heads from h0, block_q queries from q0, packed
// r -> (head h0 + r / block_q, query q0 + r % block_q).
struct RowTile {
  int64_t b;
  int h0;
  int64_t q0;
};

// Copies the tile's Q and dO rows to shared memory; rows past the tile are
// zero.
template <int HD>
__device__ inline void load_rows(const BwdParams& p, const RowTile& t, T* sQ,
                                 T* sdO) {
  constexpr int LD = BwdTile<HD>::kLd;
  constexpr int kChunks = HD / 8;
  const int rows = p.heads_per_block * p.block_q;
  for (int c = threadIdx.x; c < kBwdRows * kChunks; c += kBwdThreads) {
    const int r = c / kChunks;
    const int d0 = (c % kChunks) * 8;
    const int64_t qi = t.q0 + r % p.block_q;
    const bool ok = r < rows && qi < p.sq;
    const int64_t h = t.h0 + r / p.block_q;
    cp_async16(sQ + r * LD + d0,
               ok ? p.q + t.b * p.qs[0] + h * p.qs[1] + qi * p.qs[2] + d0 : p.q,
               ok);
    cp_async16(sdO + r * LD + d0,
               ok ? p.dout + t.b * p.dos[0] + h * p.dos[1] + qi * p.dos[2] + d0
                  : p.dout,
               ok);
  }
}

// Copies keys [key0, key0 + kBwdKeys) of K and V; keys past kend are zero.
template <int HD>
__device__ inline void load_keys(const BwdParams& p, int64_t b, int64_t kvh,
                                 int64_t key0, T* sK, T* sV) {
  constexpr int LD = BwdTile<HD>::kLd;
  constexpr int kChunks = HD / 8;
  const T* kb = p.k + b * p.ks[0] + kvh * p.ks[1];
  const T* vb = p.v + b * p.vs[0] + kvh * p.vs[1];
  for (int c = threadIdx.x; c < kBwdKeys * kChunks; c += kBwdThreads) {
    const int j = c / kChunks;
    const int d0 = (c % kChunks) * 8;
    const int64_t key = key0 + j;
    const bool ok = key < p.kend;
    cp_async16(sK + j * LD + d0, ok ? kb + key * p.ks[2] + d0 : p.k, ok);
    cp_async16(sV + j * LD + d0, ok ? vb + key * p.vs[2] + d0 : p.v, ok);
  }
}

// S = Q K^T and dP = dO V^T for the 64 x 32 tile, warp w taking rows
// 16 (w % 4).. and keys 16 (w / 4)..; then P and dS (see the head comment)
// go to shared memory in bf16, row-major (row, key). sP may be null.
template <int HD>
__device__ inline void score_tile(const BwdParams& p, const RowTile& t,
                                  int64_t key0, const T* sQ, const T* sdO,
                                  const T* sK, const T* sV, T* sP, T* sdS) {
  constexpr int LD = BwdTile<HD>::kLd;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = warp & 3;
  const int kg = warp >> 2;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int a_off = (16 * rg + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8;
    const int b_off = (16 * kg + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8;
    uint32_t a[4], b[4];
    ldsm_x4(a, sQ + a_off);
    ldsm_x4(b, sK + b_off);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
    ldsm_x4(a, sdO + a_off);
    ldsm_x4(b, sV + b_off);
    mma_bf16(dp[0], a, b[0], b[1]);
    mma_bf16(dp[1], a, b[2], b[3]);
  }

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rows = p.heads_per_block * p.block_q;
  int r[2];
  int64_t qpos[2];
  float lse2[2], delta[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r[i] = 16 * rg + g + 8 * i;
    const int64_t qi = t.q0 + r[i] % p.block_q;
    valid[i] = r[i] < rows && qi < p.sq;
    qpos[i] = p.q_offset + qi;
    lse2[i] = 0.f;
    delta[i] = 0.f;
    if (valid[i]) {
      const int64_t idx = (t.b * p.heads + t.h0 + r[i] / p.block_q) * p.sq + qi;
      lse2[i] = p.lse[idx] * kLog2e;
      delta[i] = p.delta[idx];
    }
  }
  const float cap_in = p.softcap > 0.f ? p.scale / p.softcap : 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float pv[2], dsv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * half + c;
        const int64_t key = key0 + 16 * kg + 8 * j + 2 * tq + c;
        const int64_t qp = qpos[half];
        const bool ok = valid[half] && key < p.kend &&
                        (!p.causal || key <= qp) &&
                        (p.window <= 0 || key > qp - p.window);
        float x, grad = p.scale;
        if (p.softcap > 0.f) {
          const float th = tanhf(s[j][e] * cap_in);
          x = p.softcap * th;
          grad *= 1.f - th * th;
        } else {
          x = s[j][e] * p.scale;
        }
        const float pr = ok ? exp2f(x * kLog2e - lse2[half]) : 0.f;
        pv[c] = pr;
        dsv[c] = pr * (dp[j][e] - delta[half]) * grad;
      }
      const int off = r[half] * kLdp + 16 * kg + 8 * j + 2 * tq;
      if (sP != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(sP + off) =
            __floats2bfloat162_rn(pv[0], pv[1]);
      *reinterpret_cast<__nv_bfloat162*>(sdS + off) =
          __floats2bfloat162_rn(dsv[0], dsv[1]);
    }
  }
}

// The query rows [lo, hi) that can see some key of [k0, k1).
__device__ inline void query_bounds(const BwdParams& p, int64_t k0, int64_t k1,
                                    int64_t* lo, int64_t* hi) {
  *lo = 0;
  *hi = p.sq;
  if (k1 <= k0) {
    *hi = 0;
    return;
  }
  if (p.causal) {
    const int64_t c = k0 - p.q_offset;
    *lo = c > 0 ? c : 0;
  }
  if (p.window > 0) {
    const int64_t w = k1 - 1 + p.window - p.q_offset;
    *hi = w < *hi ? w : *hi;
  }
  if (*hi < *lo) *hi = *lo;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1) dkdv_kernel(BwdParams p) {
  constexpr int LD = BwdTile<HD>::kLd;
  constexpr int kCG = HD >= 64 ? 4 : HD / 16;   // column groups of dK, dV
  constexpr int CW = HD / kCG;                  // dims per warp, 16 | CW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);      // kBwdKeys x LD
  T* sV = sK + kBwdKeys * LD;
  T* sQ = sV + kBwdKeys * LD;                  // 2 stages x kBwdRows x LD
  T* sdO = sQ + 2 * kBwdRows * LD;
  T* sP = sdO + 2 * kBwdRows * LD;             // kBwdRows x kLdp
  T* sdS = sP + kBwdRows * kLdp;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // key tile 0 first: under the causal mask it sees the most queries
  int64_t bid = blockIdx.x;
  const int64_t b = bid % p.batch;
  bid /= p.batch;
  const int64_t kvh = bid % p.kv_heads;
  const int64_t kt = bid / p.kv_heads;
  const int64_t key0 = kt * kBwdKeys;
  const int64_t key1 = key0 + kBwdKeys < p.kend ? key0 + kBwdKeys : p.kend;

  load_keys<HD>(p, b, kvh, key0, sK, sV);
  cp_async_commit();
  int64_t i_lo, i_hi;
  query_bounds(p, key0, key1, &i_lo, &i_hi);
  const int64_t qt_lo = i_lo / p.block_q;
  const int64_t nq = i_hi > i_lo ? (i_hi + p.block_q - 1) / p.block_q - qt_lo : 0;
  const int64_t n_tiles = nq * p.n_hblocks;
  auto tile = [&](int64_t t) {
    RowTile rt;
    rt.b = b;
    rt.h0 = (int)(kvh * p.group + (t / nq) * p.heads_per_block);
    rt.q0 = (qt_lo + t % nq) * p.block_q;
    return rt;
  };
  if (n_tiles > 0) load_rows<HD>(p, tile(0), sQ, sdO);
  cp_async_commit();

  const int kgp = warp & 1;
  const int cg = warp >> 1;
  float dv[CW / 8][4], dk[CW / 8][4];
#pragma unroll
  for (int j = 0; j < CW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = dk[j][e] = 0.f;

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int stage = (int)(t & 1);
    if (t + 1 < n_tiles)
      load_rows<HD>(p, tile(t + 1), sQ + (stage ^ 1) * kBwdRows * LD,
                    sdO + (stage ^ 1) * kBwdRows * LD);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and row tile t have landed
    __syncthreads();
    const T* tQ = sQ + stage * kBwdRows * LD;
    const T* tdO = sdO + stage * kBwdRows * LD;
    score_tile<HD>(p, tile(t), key0, tQ, tdO, sK, sV, sP, sdS);
    __syncthreads();
    if (cg < kCG) {
#pragma unroll
      for (int ks = 0; ks < kBwdRows / 16; ++ks) {
        // A = P^T and dS^T (16 keys x 16 rows), read transposed
        const int a_off = (16 * ks + (lane & 7) + ((lane >> 4) & 1) * 8) * kLdp +
                          16 * kgp + ((lane >> 3) & 1) * 8;
        uint32_t ap[4], ad[4];
        ldsm_x4_trans(ap, sP + a_off);
        ldsm_x4_trans(ad, sdS + a_off);
#pragma unroll
        for (int dp2 = 0; dp2 < CW / 16; ++dp2) {
          // B = dO and Q rows (16 rows x 16 dims), read transposed
          const int b_off = (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                            cg * CW + dp2 * 16 + (lane >> 4) * 8;
          uint32_t bb[4];
          ldsm_x4_trans(bb, tdO + b_off);
          mma_bf16(dv[2 * dp2], ap, bb[0], bb[1]);
          mma_bf16(dv[2 * dp2 + 1], ap, bb[2], bb[3]);
          ldsm_x4_trans(bb, tQ + b_off);
          mma_bf16(dk[2 * dp2], ad, bb[0], bb[1]);
          mma_bf16(dk[2 * dp2 + 1], ad, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the stage, P and dS are free
  }
  cp_async_wait<0>();

  // every key of [0, Skv) gets its row: zero past kend or unseen
  if (cg >= kCG) return;
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t key = key0 + 16 * kgp + g + 8 * half;
    if (key >= p.skv) continue;
    T* dkrow = p.dk + b * p.dks[0] + kvh * p.dks[1] + key * p.dks[2] + cg * CW;
    T* dvrow = p.dv + b * p.dvs[0] + kvh * p.dvs[1] + key * p.dvs[2] + cg * CW;
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkrow + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(dk[j][2 * half], dk[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvrow + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(dv[j][2 * half], dv[j][2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1) dq_kernel(BwdParams p) {
  constexpr int LD = BwdTile<HD>::kLd;
  constexpr int kCG = HD >= 32 ? 2 : 1;   // column groups of dQ
  constexpr int CW = HD / kCG;            // dims per warp, 16 | CW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // kBwdRows x LD
  T* sdO = sQ + kBwdRows * LD;
  T* sK = sdO + kBwdRows * LD;             // 2 stages x kBwdKeys x LD
  T* sV = sK + 2 * kBwdKeys * LD;
  T* sdS = sV + 2 * kBwdKeys * LD;         // kBwdRows x kLdp

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the last query tile first: under the causal mask it sees the most keys
  int64_t bid = blockIdx.x;
  const int64_t b = bid % p.batch;
  bid /= p.batch;
  const int n_groups = p.heads / p.heads_per_block;
  const int grp = (int)(bid % n_groups);
  bid /= n_groups;
  RowTile rt;
  rt.b = b;
  rt.h0 = grp * p.heads_per_block;
  rt.q0 = (p.n_qtiles - 1 - bid) * p.block_q;
  const int64_t kvh = rt.h0 / p.group;

  load_rows<HD>(p, rt, sQ, sdO);
  cp_async_commit();
  const int64_t last_q = (rt.q0 + p.block_q < p.sq ? rt.q0 + p.block_q : p.sq) - 1;
  int64_t key_lo = 0, key_hi = p.kend;
  if (p.window > 0) {
    const int64_t w = p.q_offset + rt.q0 - p.window + 1;
    key_lo = w > 0 ? w : 0;
  }
  if (p.causal) {
    const int64_t c = p.q_offset + last_q + 1;
    key_hi = c < key_hi ? c : key_hi;
  }
  const int64_t t_lo = key_lo / kBwdKeys;
  const int64_t t_hi = key_hi > key_lo ? (key_hi + kBwdKeys - 1) / kBwdKeys : t_lo;
  if (t_lo < t_hi) load_keys<HD>(p, b, kvh, t_lo * kBwdKeys, sK, sV);
  cp_async_commit();

  const int rg = warp & 3;
  const int cg = warp >> 2;
  float acc[CW / 8][4];
#pragma unroll
  for (int j = 0; j < CW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int64_t t = t_lo; t < t_hi; ++t) {
    const int stage = (int)((t - t_lo) & 1);
    if (t + 1 < t_hi)
      load_keys<HD>(p, b, kvh, (t + 1) * kBwdKeys,
                    sK + (stage ^ 1) * kBwdKeys * LD,
                    sV + (stage ^ 1) * kBwdKeys * LD);
    cp_async_commit();
    cp_async_wait<1>();  // the rows and key tile t have landed
    __syncthreads();
    const T* tK = sK + stage * kBwdKeys * LD;
    score_tile<HD>(p, rt, t * kBwdKeys, sQ, sdO, tK, sV + stage * kBwdKeys * LD,
                   nullptr, sdS);
    __syncthreads();
    if (cg < kCG) {
#pragma unroll
      for (int ks = 0; ks < kBwdKeys / 16; ++ks) {
        uint32_t a[4];   // dS (16 rows x 16 keys)
        ldsm_x4(a, sdS + (16 * rg + (lane & 15)) * kLdp + 16 * ks + (lane >> 4) * 8);
#pragma unroll
        for (int dp2 = 0; dp2 < CW / 16; ++dp2) {
          uint32_t bb[4];   // K (16 keys x 16 dims), read transposed
          ldsm_x4_trans(bb, tK + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                cg * CW + dp2 * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dp2], a, bb[0], bb[1]);
          mma_bf16(acc[2 * dp2 + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // the stage and dS are free
  }
  cp_async_wait<0>();

  if (cg >= kCG) return;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rows = p.heads_per_block * p.block_q;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * rg + g + 8 * half;
    const int64_t qi = rt.q0 + r % p.block_q;
    if (r >= rows || qi >= p.sq) continue;
    const int64_t h = rt.h0 + r / p.block_q;
    T* row = p.dq + b * p.dqs[0] + h * p.dqs[1] + qi * p.dqs[2] + cg * CW;
#pragma unroll
    for (int j = 0; j < CW / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launches

template <int HD>
int launch_bwd(const BwdParams& p, cudaStream_t st) {
  static bool kv_configured = false, q_configured = false;
  if (int err = allow_smem(dkdv_kernel<HD>, BwdTile<HD>::kSmemKV, &kv_configured))
    return err;
  if (int err = allow_smem(dq_kernel<HD>, BwdTile<HD>::kSmemQ, &q_configured))
    return err;
  const int64_t rows = (int64_t)p.batch * p.heads * p.sq;
  delta_kernel<<<(unsigned)((rows + kBwdWarps - 1) / kBwdWarps), kBwdThreads,
                 0, st>>>(p, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t kv_blocks = (int64_t)p.batch * p.kv_heads * p.n_ktiles;
  dkdv_kernel<HD><<<(unsigned)kv_blocks, kBwdThreads, BwdTile<HD>::kSmemKV,
                    st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t q_blocks =
      (int64_t)p.batch * (p.heads / p.heads_per_block) * p.n_qtiles;
  dq_kernel<HD><<<(unsigned)q_blocks, kBwdThreads, BwdTile<HD>::kSmemQ, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o and dout (B, H, Sq, hd), each
// bf16 through its element strides (batch, head, position; unit stride along
// hd, 16-byte aligned rows), which `strides` holds on the host: q, k, v, o,
// dout, dq, dk, dv, three each. lse: the forward's float32 (B, H, Sq); delta:
// float32 scratch of the same shape. Writes dq (B, H, Sq, hd) and dk, dv (B,
// KV, Skv, hd), bf16, through their strides. Keys [0, kend) exist (kend <=
// Skv); window <= 0 and softcap <= 0 mean none. Three launches on `stream` of
// `device`; returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int64_t* strides, int64_t B, int64_t H, int64_t KV,
    int64_t Sq, int64_t Skv, int64_t kend, int64_t hd, int causal,
    int64_t window, float softcap, int64_t q_offset, float scale, void* stream,
    int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (KV < 1 || H % KV != 0 || Sq < 1 || Skv < 1)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.o = static_cast<const T*>(o);
  p.dout = static_cast<const T*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<T*>(dq);
  p.dk = static_cast<T*>(dk);
  p.dv = static_cast<T*>(dv);
  int64_t* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int a = 0; a < 8; ++a)
    for (int i = 0; i < 3; ++i) dst[a][i] = strides[3 * a + i];
  p.batch = (int)B;
  p.heads = (int)H;
  p.kv_heads = (int)KV;
  p.group = (int)(H / KV);
  // query heads per row tile: the largest divisor of G that fits 64 rows,
  // then as many queries per head as fit (the forward's packing)
  int hpb = p.group < kBwdRows ? p.group : kBwdRows;
  while (p.group % hpb) --hpb;
  p.heads_per_block = hpb;
  const int64_t per_head = kBwdRows / hpb;
  p.block_q = (int)(Sq < per_head ? Sq : per_head);
  p.n_hblocks = p.group / hpb;
  p.n_qtiles = (Sq + p.block_q - 1) / p.block_q;
  p.n_ktiles = (Skv + kBwdKeys - 1) / kBwdKeys;
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
    case 16: return launch_bwd<16>(p, st);
    case 32: return launch_bwd<32>(p, st);
    case 64: return launch_bwd<64>(p, st);
    case 128: return launch_bwd<128>(p, st);
    case 256: return launch_bwd<256>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
