// Incremental re-rate + next-completion scan for the net="numpy", "pallas"
// and "topmost" network engines.
//
// Replaces the Pallas TPU kernel _rerate_scan_kernel
// (src/repro/kernels/net_rerate/kernel.py:38, pallas_call at :62). The
// reference re-rates the union batch of the changed links' member slots
// (src/repro/core/network.py:407-438) and then scans the whole slot array for
// the earliest now + rem/rate over live slots (:439-444). Here the first
// launch re-rates the batch in place with the same gather-min device function
// as the event engine (share_rate.cuh); the second reduces the scan over the
// whole array into one device scalar. All float64 with true divides, built
// with -fmad=false: bit-identical to the float64 oracle.
//
// What bounds it: one re-rate per transfer start or finish touches a few
// hundred slots and the scan reads 16 bytes per slot, under a microsecond of
// memory traffic at the main-path shapes, so the launches and the host round
// trip for the returned minimum bound it. The design keeps it to two launches
// with no allocation, and reads the paths and the index list as int32.

#include <cuda_runtime.h>

#include "share_rate.cuh"

__global__ void rerate_kernel(const int32_t* __restrict__ idx, int64_t n_idx,
                              const int32_t* __restrict__ path, int64_t depth,
                              double* __restrict__ rate,
                              const double* __restrict__ link_bw,
                              const double* __restrict__ link_act) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_idx) return;
  const int64_t s = idx[i];
  rate[s] = slot_share_rate(path + s * depth, depth, link_bw, link_act);
}

__global__ void next_completion_kernel(const double* __restrict__ rem,
                                       const double* __restrict__ rate,
                                       int64_t n, double now,
                                       double* __restrict__ out) {
  double m = INFINITY;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const double r = rate[i];
    if (r > 0.0) {
      const double v = now + rem[i] / r;
      m = v < m ? v : m;
    }
  }
  m = block_min(m);
  if (threadIdx.x == 0) *out = m;
}

// Re-rate `n_idx` slots in place and write min(now + rem/rate) over the live
// slots (rate > 0) of all `n_slots` slots to `eta_min` (a device scalar; inf
// when none is live). Launches on `stream` of `device`; returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int net_rerate(const int32_t* idx, int64_t n_idx,
                          const int32_t* path, int64_t depth,
                          const double* rem, double* rate, int64_t n_slots,
                          const double* link_bw, const double* link_act,
                          double now, double* eta_min, void* stream,
                          int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_idx > 0) {
    const int64_t blocks = (n_idx + kSlotThreads - 1) / kSlotThreads;
    rerate_kernel<<<(unsigned)blocks, kSlotThreads, 0, st>>>(
        idx, n_idx, path, depth, rate, link_bw, link_act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  next_completion_kernel<<<1, kReduceThreads, 0, st>>>(rem, rate, n_slots,
                                                       now, eta_min);
  return (int)cudaGetLastError();
}
