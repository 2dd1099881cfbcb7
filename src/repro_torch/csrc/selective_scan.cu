// Mamba-1 selective scan for the serving path: every layer of
// falcon-mamba-7b, in prefill (S = the prompt) and in decode (S = 1, h0 = the
// cached state).
//
// Replaces the Pallas TPU kernel _scan_kernel
// (src/repro/kernels/selective_scan/kernel.py:29, pallas_call at :76). That
// kernel ran a (batch, channel block, sequence chunk) grid with the chunk
// axis innermost, carrying the (channels, N) state in VMEM across chunks and
// stepping through each chunk with a fori_loop on the VPU. Here the state of
// one (batch, channel) pair is split across kLanes = 4 neighbouring lanes,
// each keeping kPer = 4 of its N <= 16 states in registers for the whole
// sequence:
//
//   h = exp(dt * A) * h + (dt * x) * B_t;   y_t = h . C_t + D * x_t
//
// walked in time order. A lane's step is 4 exponentials and 8 FMAs; it
// writes its partial dot product, lane 0's starting at D * x, to a shared
// tile [step][channel][lane], and once a round the block sums each step's
// 4 partials and writes y as coalesced rows. (Combining by two xor
// shuffles a step, y written by lane 0, measured slower: PERF.md.) A block
// serves kCh = 64 neighbouring channels of one batch row (256 threads).
// Per round of kSteps = 16 steps it stages its channels' x and dt rows
// (256 B each in float32, 128 B in bf16) and the round's B and C (one
// contiguous run each) in shared memory with cp.async, double-buffered:
// round r + 1's copies are issued before round r is walked. The copy
// granule is the widest of 16, 8 or 4 bytes that every row start allows
// (element by element, synchronously, only for bf16 rows of odd length);
// which granules a thread copies is worked out once (CopyPlan), so a round
// costs no integer division. The state rows h0, A and h_last are read and
// written with neighbouring lanes on neighbouring addresses: at N = 16
// each lane moves one 16-byte vector, a warp 8 whole rows (512 B); below
// 16 the surplus states are masked off. A is scaled by log2(e) once, so
// each factor is one exp2f, one MUFU.EX2 (still exp2f, not __expf: the
// kernel is held to the plain version's tolerance over 1,024 steps). A, D
// and h0 are float32, as is the arithmetic; x, dt, B, C and y are bf16 or
// f32. Shared memory: 20 KB of stages and 16 KB of partials a block in
// float32, so 6 blocks fit an SM; registers (48 a thread at N = 16)
// allow 5.
//
// What bounds it: at the falcon-mamba-7b prefill shape (Bz 4, S 1024,
// Di 8192, N 16, f32) it must read x and dt and write y, ~408 MB: 121.8 us
// at 3.35 TB/s; its 536,870,912 exponentials take 128.4 us on the
// special-function units (16 a clock per SM), so the exponentials bind.
// Decode (S 1) moves the state rows, ~5.1 MB: 1.54 us. On an NVIDIA H100
// 80GB HBM3 at 700 W the kernel takes ~320 us at prefill and ~4.3 us at
// cold decode (chip_smoke.py phase 8; PERF.md section 6, row 7). Prefill
// is bound by instruction issue, not by the exponentials: beside its
// MUFU.EX2 each exp2f issues three instructions of subnormal handling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kLanes = 4;                // lanes a channel
constexpr int kPer = 4;                  // states a lane
constexpr int kMaxN = kLanes * kPer;     // widest state
constexpr int kCh = 64;                  // channels a block
constexpr int kThreads = kCh * kLanes;   // threads a block
constexpr int kSteps = 16;               // time steps a round
constexpr float kLog2e = 1.4426950408889634f;

// One round's inputs as they lie in device memory: x and dt rows of the
// block's channels, B and C of the round's steps (stride N).
template <typename T>
struct __align__(16) Stage {
  T x[kSteps][kCh];
  T dt[kSteps][kCh];
  T b[kSteps * kMaxN];
  T c[kSteps * kMaxN];
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four neighbouring values at a 16-byte (float) or 8-byte (bf16) aligned
// address, as floats.
__device__ inline void load4(const float* p, float (&v)[kPer]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ inline void load4(const __nv_bfloat16* p, float (&v)[kPer]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo);
  v[2] = __low2float(hi), v[3] = __high2float(hi);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One granule of g bytes: 16 through L2 only, 8 and 4 through L1, 2 (bf16
// rows of odd length) as a plain load and store.
__device__ inline void copy_granule(char* dst, const char* src, int g) {
  switch (g) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of every round's copies, fixed for the sequence:
// granule m of the x and dt tiles (m < kRowCopies, the most a thread
// takes when a granule is one element) lies `row[m]` steps into the round
// and `col[m]` bytes into the row (row kSteps: none).
constexpr int kRowCopies = kSteps * kCh / kThreads;

struct CopyPlan {
  int row[kRowCopies], col[kRowCopies];
};

__device__ inline CopyPlan plan_copies(int row_bytes, int g, int tid) {
  CopyPlan p;
  const int per_row = row_bytes / g;
#pragma unroll
  for (int m = 0; m < kRowCopies; ++m) {
    const int k = tid + m * kThreads, i = k / per_row;
    p.row[m] = i < kSteps ? i : kSteps;
    p.col[m] = (k - i * per_row) * g;
  }
  return p;
}

// Issue the copies of the round of `steps` steps from t0 into `s`.
template <typename T>
__device__ inline void stage_round(Stage<T>& s, const T* x, const T* dt,
                                   const T* bm, const T* cm,
                                   const CopyPlan& plan, int64_t b,
                                   int64_t t0, int steps, int64_t S,
                                   int64_t Di, int64_t d0, int N, int gx,
                                   int gb, int tid) {
  constexpr int sz = sizeof(T);
  const int64_t row = ((b * S + t0) * Di + d0) * sz;
  const char* xs = reinterpret_cast<const char*>(x) + row;
  const char* ds = reinterpret_cast<const char*>(dt) + row;
#pragma unroll
  for (int m = 0; m < kRowCopies; ++m) {
    const int i = plan.row[m], c = plan.col[m];
    if (i >= steps) continue;
    copy_granule(reinterpret_cast<char*>(s.x[i]) + c, xs + i * Di * sz + c,
                 gx);
    copy_granule(reinterpret_cast<char*>(s.dt[i]) + c, ds + i * Di * sz + c,
                 gx);
  }
  // B and C of the round: one run of steps * N values each
  const char* bs = reinterpret_cast<const char*>(bm) + (b * S + t0) * N * sz;
  const char* cs = reinterpret_cast<const char*>(cm) + (b * S + t0) * N * sz;
  for (int at = tid * gb; at < steps * N * sz; at += kThreads * gb) {
    copy_granule(reinterpret_cast<char*>(s.b) + at, bs + at, gb);
    copy_granule(reinterpret_cast<char*>(s.c) + at, cs + at, gb);
  }
}

// A lane's kPer values of a state row (n0 .. n0 + 3 of `row`); masked
// states read as 0. kFull: N = 16 and the row 16-byte aligned.
template <bool kFull>
__device__ inline void load_state(const float* row, int n0, int N, bool live,
                                  float (&v)[kPer]) {
  if (kFull && live) {
    load4(row + n0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = live && n0 + j < N ? row[n0 + j] : 0.f;
  }
}

// x, dt, y (Bz, S, Di); bm, cm (Bz, S, N); a (Di, N); dskip (Di,); h0,
// h_last (Bz, Di, N). Grid (ceil(Di / kCh), Bz); gx, gb: the copy granules
// of the x / dt rows and of the B / C runs.
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int64_t S, int64_t Di, int N,
                int gx, int gb) {
  __shared__ Stage<T> stage[2];
  __shared__ __align__(16) float s_p[kSteps][kCh][kLanes];  // y partials
  const int tid = threadIdx.x;
  const int ch = tid / kLanes, lane = tid % kLanes, n0 = lane * kPer;
  const int64_t b = blockIdx.y;
  const int64_t d0 = (int64_t)blockIdx.x * kCh;
  const int nch = (int)(Di - d0 < kCh ? Di - d0 : kCh);
  const int64_t d = d0 + ch;
  const bool live = ch < nch;
  const int64_t rounds = (S + kSteps - 1) / kSteps;

  // round 0's copies fly while the state rows are read
  const CopyPlan plan = plan_copies(nch * (int)sizeof(T), gx, tid);
  stage_round(stage[0], x, dt, bm, cm, plan, b, 0,
              (int)(S < kSteps ? S : kSteps), S, Di, d0, N, gx, gb, tid);
  cp_async_commit();
  float h[kPer], a2[kPer];
  load_state<kFull>(h0 + (b * Di + d) * N, n0, N, live, h);
  load_state<kFull>(a + d * N, n0, N, live, a2);
#pragma unroll
  for (int j = 0; j < kPer; ++j) a2[j] *= kLog2e;
  const float dd = live && lane == 0 ? dskip[d] : 0.f;  // lane 0 adds D * x

  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t t0 = r * kSteps;
    const int steps = (int)(S - t0 < kSteps ? S - t0 : kSteps);
    if (r + 1 < rounds) {
      const int64_t t1 = t0 + kSteps;
      stage_round(stage[(r + 1) & 1], x, dt, bm, cm, plan, b, t1,
                  (int)(S - t1 < kSteps ? S - t1 : kSteps), S, Di, d0, N, gx,
                  gb, tid);
    }
    cp_async_commit();   // empty on the last round
    cp_async_wait<1>();  // this thread's copies of round r have landed
    __syncthreads();     // and every thread's
    const Stage<T>& s = stage[r & 1];
    for (int i = 0; i < steps; ++i) {
      const float dtv = to_float(s.dt[i][ch]), xv = to_float(s.x[i][ch]);
      const float dx = dtv * xv;
      float bv[kPer], cv[kPer];
      if (kFull) {
        load4(&s.b[i * kMaxN + n0], bv);
        load4(&s.c[i * kMaxN + n0], cv);
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool on = n0 + j < N;
          bv[j] = on ? to_float(s.b[i * N + n0 + j]) : 0.f;
          cv[j] = on ? to_float(s.c[i * N + n0 + j]) : 0.f;
        }
      }
      float part = dd * xv;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        h[j] = exp2f(dtv * a2[j]) * h[j] + dx * bv[j];
        part += h[j] * cv[j];
      }
      s_p[i][ch][lane] = part;
    }
    __syncthreads();  // s_p is whole; stage r is no longer read
    for (int k = tid; k < steps * kCh; k += kThreads) {
      const int i = k / kCh, c = k % kCh;
      if (c < nch) {
        const float4 p = *reinterpret_cast<const float4*>(s_p[i][c]);
        store(y + (b * S + t0 + i) * Di + d0 + c, (p.x + p.y) + (p.z + p.w));
      }
    }
  }
  if (!live) return;
  float* out = h_last + (b * Di + d) * N;
  if (kFull) {
    *reinterpret_cast<float4*>(out + n0) = make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (n0 + j < N) out[n0 + j] = h[j];
  }
}

// The widest granule (16, 8 or 4 bytes) that every pointer and
// `row_bytes` are multiples of; the element size when none is.
int granule(const void* p, const void* q, int64_t row_bytes, int elem) {
  const auto at = [](const void* v) { return reinterpret_cast<uintptr_t>(v); };
  for (int g = 16; g >= 4; g /= 2)
    if (at(p) % g == 0 && at(q) % g == 0 && row_bytes % g == 0) return g;
  return elem;
}

template <typename T>
int launch(const T* x, const T* dt, const T* bm, const T* cm, const float* a,
           const float* dskip, const float* h0, T* y, float* h_last,
           int64_t Bz, int64_t S, int64_t Di, int N, cudaStream_t st) {
  const int sz = (int)sizeof(T);
  const int gx = granule(x, dt, Di * sz, sz);
  const int gb = granule(bm, cm, S * N * sz, sz);
  const auto at16 = [](const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0;
  };
  const dim3 grid((unsigned)((Di + kCh - 1) / kCh), (unsigned)Bz);
  if (N == kMaxN && at16(a) && at16(h0) && at16(h_last))
    scan_kernel<T, true><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, y, h_last, S, Di, N, gx, gb);
  else
    scan_kernel<T, false><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, y, h_last, S, Di, N, gx, gb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y (Bz, S, Di); bm, cm (Bz, S, N); a (Di, N); dskip (Di,); h0 and
// h_last (Bz, Di, N): all contiguous, N <= 16; x, dt, bm, cm, y bf16 when
// `bf16` is set, else float32; a, dskip, h0, h_last float32. One launch on
// `stream` of `device`; returns cudaGetLastError() (0 on success).
extern "C" int selective_scan(const void* x, const void* dt, const void* bm,
                              const void* cm, const float* a,
                              const float* dskip, const float* h0, void* y,
                              float* h_last, int64_t Bz, int64_t S,
                              int64_t Di, int64_t N, int bf16, void* stream,
                              int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const T*>(bm), static_cast<const T*>(cm), a,
                  dskip, h0, static_cast<T*>(y), h_last, Bz, S, Di, (int)N,
                  st);
  }
  return launch(static_cast<const float*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(bm), static_cast<const float*>(cm),
                a, dskip, h0, static_cast<float*>(y), h_last, Bz, S, Di,
                (int)N, st);
}
