// Mamba-1 selective scan for the serving path: every layer of
// falcon-mamba-7b, in prefill (S = the prompt) and in decode (S = 1, h0 = the
// cached state).
//
// Replaces the Pallas TPU kernel _scan_kernel
// (src/repro/kernels/selective_scan/kernel.py:29, pallas_call at :76). That
// kernel ran a (batch, channel block, sequence chunk) grid with the chunk
// axis innermost, carrying the (channels, N) state in VMEM across chunks and
// stepping through each chunk with a fori_loop on the VPU. Here one thread
// owns one (batch, channel) pair and keeps its N-wide state h in registers
// for the whole sequence:
//
//   h = exp(dt * A) * h + (dt * x) * B_t;   y_t = h . C_t + D * x_t
//
// walked in time order, so no state leaves the thread between steps. A block
// serves kThreads neighbouring channels of one batch row. Per round of
// kSteps time steps it stages B_t and C_t (N values each, shared by all its
// channels) and its channels' x and dt in shared memory, every load of the
// round issued before the walk, so the load latency is paid once a round and
// not once a step. y is written per step (neighbouring threads, neighbouring
// channels: coalesced); h_last at the end. A, D and h0 are float32, as is
// the arithmetic; x, dt, B, C and y are bf16 or f32. expf, not __expf: the
// kernel is held to the plain version's tolerance over 1,024 steps.
//
// What bounds it: at the falcon-mamba-7b prefill shape (Bz 4, S 1024,
// Di 8192, N 16, f32) it must read x and dt and write y, ~400 MB: ~120 us at
// 3.35 TB/s; its ~0.5 G exponentials are below that at the SFU rate. With
// one thread per channel the grid is Bz * Di = 32,768 threads, ~8 warps per
// SM, and each step is a chain of N dependent-free exp/FMA pairs, so latency
// rather than bytes is the likely limit (PERF.md). Splitting N across lanes
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // channels per block
constexpr int kSteps = 32;      // time steps staged per round
constexpr int kMaxN = 16;       // state width held in registers

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ h_last, int64_t S, int64_t Di, int N) {
  __shared__ float s_x[kSteps][kThreads];
  __shared__ float s_dt[kSteps][kThreads];
  __shared__ float s_b[kSteps][kMaxN];
  __shared__ float s_c[kSteps][kMaxN];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t d = (int64_t)blockIdx.x * kThreads + tid;
  const bool live = d < Di;

  float h[kMaxN], an[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool on = live && n < N;
    h[n] = on ? h0[(b * Di + d) * N + n] : 0.f;
    an[n] = on ? a[d * N + n] : 0.f;
  }
  const float dd = live ? dskip[d] : 0.f;

  for (int64_t t0 = 0; t0 < S; t0 += kSteps) {
    const int steps = (int)(S - t0 < kSteps ? S - t0 : kSteps);
    __syncthreads();  // the last round's staged values are no longer read
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < steps && live) {
        const int64_t at = (b * S + t0 + i) * Di + d;
        s_x[i][tid] = to_float(x[at]);
        s_dt[i][tid] = to_float(dt[at]);
      }
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      const int t = i / N, n = i - t * N;
      const int64_t at = (b * S + t0 + t) * N + n;
      s_b[t][n] = to_float(bm[at]);
      s_c[t][n] = to_float(cm[at]);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < steps; ++i) {
      const float dtv = s_dt[i][tid];
      const float xv = s_x[i][tid];
      const float dx = dtv * xv;
      float out = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          h[n] = expf(dtv * an[n]) * h[n] + dx * s_b[i][n];
          out += h[n] * s_c[i][n];
        }
      }
      store(y + (b * S + t0 + i) * Di + d, out + dd * xv);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_last[(b * Di + d) * N + n] = h[n];
  }
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
  const dim3 grid((unsigned)((Di + kThreads - 1) / kThreads), (unsigned)Bz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    scan_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(dt),
        static_cast<const T*>(bm), static_cast<const T*>(cm), a, dskip, h0,
        static_cast<T*>(y), h_last, S, Di, (int)N);
  } else {
    scan_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(bm), static_cast<const float*>(cm), a,
        dskip, h0, static_cast<float*>(y), h_last, S, Di, (int)N);
  }
  return (int)cudaGetLastError();
}
