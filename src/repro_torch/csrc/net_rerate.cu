// Incremental re-rate + next-completion scan for the net="numpy", "pallas"
// and "topmost" network engines: one thread-block cluster per engine call.
//
// Replaces the Pallas TPU kernel _rerate_scan_kernel
// (src/repro/kernels/net_rerate/kernel.py:38, pallas_call at :62). The
// reference re-rates the union batch of the changed links' member slots
// (src/repro/core/network.py:407-438) and then scans the whole slot array for
// the earliest now + rem/rate over live slots (:439-444).
//
// What bounds it: a call touches a few hundred slots and reads 16 bytes per
// slot for the scan, under a microsecond of memory traffic at the path's
// shapes, so the per-call fixed costs bound it: on the host, the ops that
// staged the slot writes and the copies of the inputs; on the device, the
// launches and the host round trip for the returned minimum. The design
// makes the whole engine call one copy, one launch and one sync:
//   - the host packs the link rows, the staged alloc/release slot writes and
//     the int32 index list into one page-locked buffer, copied up in one
//     cudaMemcpyAsync (share_rate.cuh, net_call_start);
//   - one cluster of 8 blocks (__cluster_dims__, a plain <<<>>> launch) of
//     up to 1024 threads, sized from the slot count, runs three phases
//     separated by cluster.sync(), which orders global memory at cluster
//     scope: (a) the staged scatter, (b) the per-slot re-rate over the index
//     list, (c) a strided min over the whole slot array, reduced per block
//     and then across the cluster through distributed shared memory;
//   - thread 0 of block rank 0 writes the minimum into a mapped page-locked
//     host word, read after the stream sync: no device scalar, no second copy.
// All float64 with true divides, built with -fmad=false: bit-identical to
// the float64 oracle. The slot arrays, path included, are written in phase
// (a) and read in (b) and (c), so they are plain pointers here and in
// slot_share_rate, never const __restrict__ (which would allow
// non-coherent read-only loads).

#include "share_rate.cuh"

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kClusterThreads)
rerate_cluster_kernel(NetInputs in, int32_t* path, int64_t depth, double* rem,
                      double* rate, double* eta, double* due, bool* active,
                      int64_t n_slots, double now, double* out) {
  namespace cg = cooperative_groups;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_threads = (int64_t)gridDim.x * blockDim.x;
  scatter_staged(in, depth, path, rem, rate, eta, due, active, tid,
                 n_threads);
  cg::this_cluster().sync();
  for (int64_t i = tid; i < in.n_idx; i += n_threads) {
    const int64_t s = in.idx[i];
    rate[s] = slot_share_rate(path + s * depth, depth, in.link_bw,
                              in.link_act);
  }
  cg::this_cluster().sync();
  double m = INFINITY;
  for (int64_t i = tid; i < n_slots; i += n_threads) {
    const double r = rate[i];
    if (r > 0.0) {
      const double v = now + rem[i] / r;
      m = v < m ? v : m;
    }
  }
  cluster_min(m, out);
}

// One engine call: copy the packed inputs (`host_buf`, page-locked, laid out
// as NetInputs) to `dev_buf`, apply the `n_staged` staged slot writes,
// re-rate the `n_idx` listed slots in place, and write min(now + rem/rate)
// over the live slots (rate > 0) of all `n_slots` slots to `result` (a
// page-locked host word; inf when none is live). Launches one cluster on
// `stream` of `device` and waits for it; returns the first CUDA error (0 on
// success).
extern "C" int net_rerate(const void* host_buf, void* dev_buf,
                          int64_t n_links, int64_t n_staged, int64_t n_idx,
                          int32_t* path, double* rem, double* rate,
                          double* eta, double* due, bool* active,
                          int64_t depth, int64_t n_slots, double now,
                          double* result, void* stream, int device) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* out = nullptr;
  cudaError_t err = net_call_start(
      device, st, host_buf, dev_buf,
      net_input_bytes(n_links, n_staged, depth, n_idx), result, &out);
  if (err != cudaSuccess) return (int)err;
  const NetInputs in = net_inputs(dev_buf, n_links, n_staged, depth, n_idx);
  rerate_cluster_kernel<<<kClusterBlocks, cluster_threads(n_slots), 0, st>>>(
      in, path, depth, rem, rate, eta, due, active, n_slots, now, out);
  err = cudaGetLastError();
  return (int)net_call_finish(err, st);
}
