// Device helpers shared by event_engine.cu and net_rerate.cu.
//
// slot_share_rate is the per-slot fair-share gather-min of the fluid network
// model: the min over a transfer's -1-padded link path of
// bandwidth / max(1, active), or 0 for a row with no link. It replaces the
// `share` gather + static level unroll that both Pallas kernels
// (src/repro/kernels/event_engine/kernel.py:39 and
// src/repro/kernels/net_rerate/kernel.py:38) carried inline. Every operation
// is an exact IEEE double op (divide, compare), so the result is bit-identical
// to the float64 oracles whatever order the levels are visited in.
//
// block_min reduces one double per thread to a block-wide minimum. Min is
// exact, so the reduction tree's shape cannot change the result.

#pragma once

#include <cstdint>
#include <math.h>

__device__ __forceinline__ double slot_share_rate(
    const int32_t* __restrict__ path_row, int64_t depth,
    const double* __restrict__ link_bw, const double* __restrict__ link_act) {
  double r = INFINITY;
  for (int64_t d = 0; d < depth; ++d) {
    const int32_t l = path_row[d];
    if (l >= 0) {
      const double a = link_act[l];
      const double sh = link_bw[l] / (a > 1.0 ? a : 1.0);
      r = sh < r ? sh : r;
    }
  }
  return isfinite(r) ? r : 0.0;
}

// Block-wide min of `v`; every thread must call it. The result is valid in
// thread 0. blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ double block_min(double v) {
  __shared__ double warp_min[32];
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? warp_min[lane] : INFINITY;
    for (int off = 16; off > 0; off >>= 1) {
      const double o = __shfl_down_sync(0xffffffffu, v, off);
      v = o < v ? o : v;
    }
  }
  return v;
}

// Threads of the single block that runs each whole-array min reduction.
constexpr int kReduceThreads = 1024;
// Threads per block of the per-slot update kernels.
constexpr int kSlotThreads = 256;
