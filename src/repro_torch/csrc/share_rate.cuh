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
//
// The rest is the call shape both network kernels share: one thread-block
// cluster of kClusterBlocks blocks per engine call. NetInputs reads the
// call's packed host inputs (kernels/net_call.py packs them; one
// host-to-device copy brings them up), scatter_staged applies the slot
// writes that alloc/release staged on the host, cluster_min reduces the
// whole-array minimum across the cluster through distributed shared memory,
// and cluster_threads sizes the blocks from the slot count.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <math.h>

// `path_row` is a plain pointer, not const __restrict__: the cluster kernels
// write the path rows of staged slots in phase (a) and read them here in
// phase (b), so a non-coherent read-only load could return a stale row.
// The link rows are read-only for the whole launch.
__device__ __forceinline__ double slot_share_rate(
    const int32_t* path_row, int64_t depth,
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

// Blocks per cluster of the network kernels (__cluster_dims__): 8, the
// portable maximum. A 16-block cluster measured slower at the paths'
// shapes (PERF.md, kernel table rows 1-2).
constexpr int kClusterBlocks = 8;
// Most threads per block of the cluster kernels.
constexpr int kClusterThreads = 1024;

// Threads per block for `n_slots` slots: enough warps that the cluster holds
// a thread per slot, at most kClusterThreads. Every loop of the kernels
// strides over the cluster, so any width is correct; a narrow block makes
// the block reduction and the cluster barriers cheaper on a small array.
inline int cluster_threads(int64_t n_slots) {
  const int64_t per_block = (n_slots + kClusterBlocks - 1) / kClusterBlocks;
  const int64_t warps = (per_block + 31) / 32;
  return (int)(warps < 1 ? 32 : warps > kClusterThreads / 32
                                    ? kClusterThreads
                                    : 32 * warps);
}

// The packed inputs of one call, in the order net_call.NetInputs.pack writes
// them: float64 link_bw[n_links], link_act[n_links], st_rem[n_staged]; then
// int32 st_slot[n_staged], st_active[n_staged], st_path[n_staged * depth],
// idx[n_idx]. The float64 part comes first, so every field is aligned.
struct NetInputs {
  const double* link_bw;
  const double* link_act;
  const double* st_rem;
  const int32_t* st_slot;
  const int32_t* st_active;
  const int32_t* st_path;
  const int32_t* idx;
  int64_t n_staged;
  int64_t n_idx;
};

inline size_t net_input_bytes(int64_t n_links, int64_t n_staged,
                              int64_t depth, int64_t n_idx) {
  return 8 * (size_t)(2 * n_links + n_staged) +
         4 * (size_t)(n_staged * (2 + depth) + n_idx);
}

inline NetInputs net_inputs(const void* buf, int64_t n_links,
                            int64_t n_staged, int64_t depth, int64_t n_idx) {
  const double* f = static_cast<const double*>(buf);
  const int32_t* i = reinterpret_cast<const int32_t*>(f + 2 * n_links +
                                                      n_staged);
  NetInputs in;
  in.link_bw = f;
  in.link_act = f + n_links;
  in.st_rem = f + 2 * n_links;
  in.st_slot = i;
  in.st_active = i + n_staged;
  in.st_path = i + 2 * n_staged;
  in.idx = i + n_staged * (2 + depth);
  in.n_staged = n_staged;
  in.n_idx = n_idx;
  return in;
}

// Phase (a): the staged alloc/release writes, as the engine's _apply_staged
// makes them: rem and the active flag from the row, rate 0, eta and due inf
// (an unrated slot), the path row. No slot is staged twice (the host keeps
// them in a dict), so no two threads write one slot. `tid` / `n_threads`
// stride over the whole cluster.
__device__ __forceinline__ void scatter_staged(
    const NetInputs& in, int64_t depth, int32_t* path, double* rem,
    double* rate, double* eta, double* due, bool* active, int64_t tid,
    int64_t n_threads) {
  for (int64_t j = tid; j < in.n_staged; j += n_threads) {
    const int64_t s = in.st_slot[j];
    rem[s] = in.st_rem[j];
    rate[s] = 0.0;
    eta[s] = INFINITY;
    due[s] = INFINITY;
    active[s] = in.st_active[j] != 0;
    for (int64_t d = 0; d < depth; ++d)
      path[s * depth + d] = in.st_path[j * depth + d];
  }
}

// Cluster-wide min of `v`; every thread of the cluster must call it. Each
// block reduces with block_min, block rank 0 gathers the other blocks'
// partial minima from their shared memory (distributed shared memory) and
// its thread 0 writes the result to `out` (a mapped host word). The last
// cluster.sync() keeps every block, and so its shared memory, alive until
// rank 0 has read it.
__device__ __forceinline__ void cluster_min(double v, double* out) {
  namespace cg = cooperative_groups;
  __shared__ double block_part;
  cg::cluster_group cluster = cg::this_cluster();
  v = block_min(v);
  if (threadIdx.x == 0) block_part = v;
  cluster.sync();
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    double m = INFINITY;
    for (unsigned r = 0; r < cluster.num_blocks(); ++r) {
      const double p = *cluster.map_shared_rank(&block_part, r);
      m = p < m ? p : m;
    }
    *out = m;
  }
  cluster.sync();
}

// The host side of one engine call, around the launch: select the device,
// copy the packed inputs up in one cudaMemcpyAsync on `st` from page-locked
// memory, and find the device address of the mapped result word. Both host
// buffers are reused across calls: every call ends in net_call_finish's
// stream sync, so the previous copy and the previous result write are done.
inline cudaError_t net_call_start(int device, cudaStream_t st,
                                  const void* host_buf, void* dev_buf,
                                  size_t bytes, double* result_host,
                                  double** result_dev) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(dev_buf, host_buf, bytes, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return err;
  return cudaHostGetDevicePointer(reinterpret_cast<void**>(result_dev),
                                  result_host, 0);
}

// Wait for the launch (errors of the run come back here); the result word
// is then final.
inline cudaError_t net_call_finish(cudaError_t launch_err, cudaStream_t st) {
  if (launch_err != cudaSuccess) return launch_err;
  return cudaStreamSynchronize(st);
}
