// Mamba-1 selective scan for the serving and training paths: every layer of
// falcon-mamba-7b, in prefill (S = the prompt) and in decode (S = 1, h0 = the
// cached state), and the training forward, which also saves h at the end of
// every 16-step round for the backward (selective_scan_bwd.cu) to start its
// rounds from. That store sits behind a template flag (kSave), so the
// serving path's kernel is compiled without it.
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

#include <math.h>

#include <cstdint>

#include "selective_scan.cuh"

namespace {

// One round's inputs as they lie in device memory: x and dt rows of the
// block's channels, B and C of the round's steps (stride N).
template <typename T>
struct __align__(16) Stage {
  T x[kSteps][kCh];
  T dt[kSteps][kCh];
  T b[kSteps * kMaxN];
  T c[kSteps * kMaxN];
};

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

// x, dt, y (Bz, S, Di); bm, cm (Bz, S, N); a (Di, N); dskip (Di,); h0,
// h_last (Bz, Di, N); states (Bz, ceil(S / kSteps), Di, N), written only
// when kSave (the training forward): h at the end of every round, which
// the backward (selective_scan_bwd.cu) starts its rounds from. Grid
// (ceil(Di / kCh), Bz); gx, gb: the copy granules of the x / dt rows and
// of the B / C runs.
template <typename T, bool kFull, bool kSave>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, float* __restrict__ states,
                int64_t S, int64_t Di, int N, int gx, int gb) {
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
    if (kSave && live)
      store_state<kFull>(states + ((b * rounds + r) * Di + d) * N, n0, N, h);
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
  store_state<kFull>(h_last + (b * Di + d) * N, n0, N, h);
}

template <typename T, bool kSave>
void launch_as(bool full, dim3 grid, cudaStream_t st, const T* x,
               const T* dt, const T* bm, const T* cm, const float* a,
               const float* dskip, const float* h0, T* y, float* h_last,
               float* states, int64_t S, int64_t Di, int N, int gx, int gb) {
  if (full)
    scan_kernel<T, true, kSave><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, y, h_last, states, S, Di, N, gx, gb);
  else
    scan_kernel<T, false, kSave><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, y, h_last, states, S, Di, N, gx, gb);
}

template <typename T>
int launch(const T* x, const T* dt, const T* bm, const T* cm, const float* a,
           const float* dskip, const float* h0, T* y, float* h_last,
           float* states, int64_t Bz, int64_t S, int64_t Di, int N,
           cudaStream_t st) {
  const int sz = (int)sizeof(T);
  const int gx = granule(x, dt, Di * sz, sz);
  const int gb = granule(bm, cm, S * N * sz, sz);
  const dim3 grid((unsigned)((Di + kCh - 1) / kCh), (unsigned)Bz);
  const bool full = N == kMaxN && at16(a) && at16(h0) && at16(h_last) &&
                    (states == nullptr || at16(states));
  if (states == nullptr)
    launch_as<T, false>(full, grid, st, x, dt, bm, cm, a, dskip, h0, y,
                        h_last, states, S, Di, N, gx, gb);
  else
    launch_as<T, true>(full, grid, st, x, dt, bm, cm, a, dskip, h0, y,
                       h_last, states, S, Di, N, gx, gb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, dt, y (Bz, S, Di); bm, cm (Bz, S, N); a (Di, N); dskip (Di,); h0 and
// h_last (Bz, Di, N); states null, or (Bz, ceil(S / 16), Di, N) to receive
// h at the end of every 16-step round: all contiguous, N <= 16; x, dt, bm,
// cm, y bf16 when `bf16` is set, else float32; a, dskip, h0, h_last,
// states float32. One launch on `stream` of `device`; returns
// cudaGetLastError() (0 on success).
extern "C" int selective_scan(const void* x, const void* dt, const void* bm,
                              const void* cm, const float* a,
                              const float* dskip, const float* h0, void* y,
                              float* h_last, float* states, int64_t Bz,
                              int64_t S, int64_t Di, int64_t N, int bf16,
                              void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > kMaxN) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const T*>(bm), static_cast<const T*>(cm), a,
                  dskip, h0, static_cast<T*>(y), h_last, states, Bz, S, Di,
                  (int)N, st);
  }
  return launch(static_cast<const float*>(x), static_cast<const float*>(dt),
                static_cast<const float*>(bm), static_cast<const float*>(cm),
                a, dskip, h0, static_cast<float*>(y), h_last, states, Bz, S,
                Di, (int)N, st);
}
