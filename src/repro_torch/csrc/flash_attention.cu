// Flash attention for the serving path: every attention layer of gemma3-1b,
// in prefill (a 1,024-token prompt) and in decode (one query against the
// cache).
//
// Replaces the Pallas TPU kernel _flash_kernel
// (src/repro/kernels/flash_attention/kernel.py:29, pallas_call at :113). That
// kernel ran a (batch, q head, q tile, kv tile) grid with the kv axis
// innermost, so the online-softmax state (m, l, acc) lived in VMEM across
// the sequential kv steps, and the K/V index_map fetched one tile per GQA
// group. Blocks of a CUDA grid run in no order, so here the kv walk is a
// loop inside the block:
//
//   one block per (batch, group of query heads sharing one KV head, query
//   tile). Its rows are (head, query) pairs, at most kRows of them, so every
//   K/V tile staged in shared memory serves all G heads of the group. Each
//   warp owns kRowsPerWarp rows; lane l owns keys l and l + 32 of a 64-key
//   tile for the scores, and head dims l, l + 32, ... for the output.
//   Per tile: stage K and V (float32, K rows padded by one to spread the
//   banks); scores for the warp's rows, scale, tanh softcap, mask with the
//   finite -1e30 sentinel (exp(s - m) never meets inf - inf); the running
//   max and sum by warp shuffles; p to shared memory; acc = acc * corr + p.V.
//   At the end acc / max(l, 1e-30), cast to the output type.
//
// The tile range of a block comes from its query positions: keys
// [max(0, q_lo - window + 1), min(kend, q_hi + 1)) under causal and window
// masks, so fully masked tiles are never visited (the TPU kernel tested each
// tile with pl.when). kend = min(Skv, kv_len): decode passes q_offset = pos
// and kv_len = pos + 1 against the whole cache. Rows with no valid key are
// not on the serving path (every causal row sees its own key); their output
// is not the plain version's and no test compares it.
//
// Inputs are read in the caller's layout through element strides (batch,
// head, position; unit stride along hd): the model hands its (B, S, H, hd)
// projections and its (B, max_len, KV, hd) caches over without a transpose.
// Scores, max, sum and acc are float32; inputs and output are bf16 or f32.
//
// What bounds it: the gemma3-1b global-layer prefill (B 4, H 4, KV 1, S 1024,
// hd 256) does ~8.6 GFLOP causal, ~9 us at the 989 TFLOP/s bf16 tensor-core
// rate; decode reads a ~4.3 MB cache, ~1.3 us at 3.35 TB/s. This simple
// kernel does its products with float32 FMAs on the CUDA cores out of shared
// memory (about one shared-memory read per two FMAs), far from either bound;
// decode runs only B * KV blocks, each walking the whole cache. wgmma, TMA
// and a split of the key range for decode are later work (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;                      // (head, query) rows per block
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kKeysPerLane = 2;
constexpr int kBlockK = 32 * kKeysPerLane;     // keys per tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qs[3], ks[3], vs[3], os[3];  // element strides: batch, head, pos
  int group;            // G: query heads per KV head
  int heads_per_block;  // query heads of one group served by a block
  int block_q;          // query positions per block
  int64_t sq;           // queries
  int64_t kend;         // keys [0, kend) exist (min(Skv, kv_len))
  int causal;
  int64_t window;       // <= 0: no window
  float softcap;        // <= 0: no softcap
  int64_t q_offset;
  float scale;
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

__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

  // the keys some row of this block may see
  const int64_t last_q = (q0 + p.block_q < p.sq ? q0 + p.block_q : p.sq) - 1;
  int64_t key_lo = 0, key_hi = p.kend;
  if (p.window > 0) {
    const int64_t lo = p.q_offset + q0 - p.window + 1;
    key_lo = lo > 0 ? lo : 0;
  }
  if (p.causal) {
    const int64_t hi = p.q_offset + last_q + 1;
    key_hi = hi < key_hi ? hi : key_hi;
  }
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
  }
}

template <typename T, int HD>
int launch(const Params& p, dim3 grid, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HD>();
  static bool configured = false;  // the attribute is set once per kernel
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  flash_kernel<T, HD><<<grid, kThreads, bytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int64_t hd, const Params& p, dim3 grid, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(p, grid, st);
    case 32: return launch<T, 32>(p, grid, st);
    case 64: return launch<T, 64>(p, grid, st);
    case 128: return launch<T, 128>(p, grid, st);
    case 256: return launch<T, 256>(p, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Skv, hd), o (B, H, Sq, hd), each through
// its element strides (batch, head, position), which `strides` holds on the
// host: q, k, v, o, three each. Keys [0, kend) exist (kend <= Skv). One launch
// on `stream` of `device`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const int64_t* strides, int64_t B,
                               int64_t H, int64_t KV, int64_t Sq, int64_t Skv,
                               int64_t kend, int64_t hd, int bf16, int causal,
                               int64_t window, float softcap, int64_t q_offset,
                               float scale, void* stream, int device) {
  (void)Skv;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.group = (int)(H / KV);
  // the largest divisor of G that fits the block's rows
  int hpb = p.group < kRows ? p.group : kRows;
  while (p.group % hpb) --hpb;
  p.heads_per_block = hpb;
  const int64_t per_head = kRows / hpb;
  p.block_q = (int)(Sq < per_head ? Sq : per_head);
  p.sq = Sq;
  p.kend = kend;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.q_offset = q_offset;
  p.scale = scale;
  const dim3 grid((unsigned)((Sq + p.block_q - 1) / p.block_q),
                  (unsigned)(H / hpb), (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(hd, p, grid, st)
              : dispatch<float>(hd, p, grid, st);
}
