// Batched event-engine flush for the net="device" network engine: one
// thread-block cluster per flush.
//
// Replaces the Pallas TPU kernel _event_flush_kernel
// (src/repro/kernels/event_engine/kernel.py:39, pallas_call at :74). That
// kernel re-flushed every slot of the array in one VMEM-resident program;
// this one takes the dirty-slot index list of the drained instant (the merged
// members of the links whose occupancy moved) and updates only those slots in
// place, exactly like the reference's CPU route (src/repro/core/network.py
// :492-545). Re-flushing an untouched slot would rebuild its eta as
// now + rate*(eta-now)/rate and move it by an ulp, so the dirty-slot form is
// what keeps the engine bit-identical to the float64 oracle.
//
// Per dirty slot: the gather-min re-rate (share_rate.cuh), the remaining-bytes
// reconstruction rem = max(rate_old > 0 ? rate_old*(eta-now) : rem, 0), the new
// eta = now + rem/rate and the completion deadline due = eta - 1/rate (inf for
// a dead slot). Then min(eta) over the whole slot array, the next NET
// wake-up. Everything is float64 with true divides; the build passes
// -fmad=false so rate_old*(eta-now) and eta-1/rate are never contracted into
// an FMA. The result is bit-identical to the oracle.
//
// What bounds it: at the path's shapes (16,384 slots, 679 dirty on average)
// a flush moves about 200 KB, well under a microsecond of the card's
// 3.35 TB/s, so fixed per-call costs bound it, on the host more than on the
// device. The design is net_rerate.cu's: one page-locked input buffer (link
// rows, staged slot writes, int32 index list) in one copy, one cluster of
// 8 blocks of up to 1024 threads whose phases (a) scatter the staged writes,
// (b) flush the dirty slots, (c) reduce min(eta) across the cluster through
// distributed shared memory, and the result in a mapped host word after one
// stream sync. The slot arrays are plain pointers: phase (a) writes what
// (b) and (c) read, the path rows included.

#include "share_rate.cuh"

__global__ void __cluster_dims__(kClusterBlocks, 1, 1)
    __launch_bounds__(kClusterThreads)
flush_cluster_kernel(NetInputs in, int32_t* path, int64_t depth, double* rem,
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
    const double r_new = slot_share_rate(path + s * depth, depth, in.link_bw,
                                         in.link_act);
    const double r_old = rate[s];
    double rn = r_old > 0.0 ? r_old * (eta[s] - now) : rem[s];
    rn = rn < 0.0 ? 0.0 : rn;
    rem[s] = rn;
    rate[s] = r_new;
    if (r_new > 0.0) {
      const double e = now + rn / r_new;
      eta[s] = e;
      due[s] = e - 1.0 / r_new;
    } else {
      eta[s] = INFINITY;
      due[s] = INFINITY;
    }
  }
  cg::this_cluster().sync();
  double m = INFINITY;
  for (int64_t i = tid; i < n_slots; i += n_threads) {
    const double v = eta[i];
    m = v < m ? v : m;
  }
  cluster_min(m, out);
}

// One flush: copy the packed inputs (`host_buf`, page-locked, laid out as
// NetInputs) to `dev_buf`, apply the `n_staged` staged slot writes, flush the
// `n_idx` dirty slots in place, and write min(eta) over all `n_slots` slots
// to `result` (a page-locked host word). Launches one cluster on `stream`
// of `device` and waits for it; returns the first CUDA error (0 on success).
extern "C" int event_engine_flush(const void* host_buf, void* dev_buf,
                                  int64_t n_links, int64_t n_staged,
                                  int64_t n_idx, int32_t* path, double* rem,
                                  double* rate, double* eta, double* due,
                                  bool* active, int64_t depth,
                                  int64_t n_slots, double now, double* result,
                                  void* stream, int device) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* out = nullptr;
  cudaError_t err = net_call_start(
      device, st, host_buf, dev_buf,
      net_input_bytes(n_links, n_staged, depth, n_idx), result, &out);
  if (err != cudaSuccess) return (int)err;
  const NetInputs in = net_inputs(dev_buf, n_links, n_staged, depth, n_idx);
  flush_cluster_kernel<<<kClusterBlocks, cluster_threads(n_slots), 0, st>>>(
      in, path, depth, rem, rate, eta, due, active, n_slots, now, out);
  err = cudaGetLastError();
  return (int)net_call_finish(err, st);
}
