// Batched event-engine flush for the net="device" network engine.
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
// a dead slot). A second launch reduces min(eta) over the whole slot array,
// the next NET wake-up. Everything is float64 with true divides; the build
// passes -fmad=false so rate_old*(eta-now) and eta-1/rate are never
// contracted into an FMA. The result is bit-identical to the oracle.
//
// What bounds it: at the main-path shapes (16,384 slots, 679 dirty on
// average) a flush moves about 200 KB, well under a microsecond of the card's
// 3.35 TB/s, so the launch and the host round trip for the returned minimum
// bound it, not bytes or flops. The design keeps it to two launches with no
// allocation and no host-side staging in between, and reads the paths and the
// index list as int32 (as the TPU kernel did: 555 links and 16,384 slots both
// fit), so a dirty slot costs 16 B of indices at depth 3; fusing it with the
// simulator's other per-instant device work is left to a later change.

#include <cuda_runtime.h>

#include "share_rate.cuh"

__global__ void event_flush_kernel(const int32_t* __restrict__ idx,
                                   int64_t n_idx,
                                   const int32_t* __restrict__ path,
                                   int64_t depth, double* __restrict__ rem,
                                   double* __restrict__ rate,
                                   double* __restrict__ eta,
                                   double* __restrict__ due,
                                   const double* __restrict__ link_bw,
                                   const double* __restrict__ link_act,
                                   double now) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_idx) return;
  const int64_t s = idx[i];
  const double r_new = slot_share_rate(path + s * depth, depth, link_bw,
                                       link_act);
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

__global__ void eta_min_kernel(const double* __restrict__ eta, int64_t n,
                               double* __restrict__ out) {
  double m = INFINITY;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const double v = eta[i];
    m = v < m ? v : m;
  }
  m = block_min(m);
  if (threadIdx.x == 0) *out = m;
}

// Flush `n_idx` dirty slots in place and write min(eta) over all `n_slots`
// slots to `eta_min` (a device scalar). Launches on `stream` of `device`;
// returns cudaGetLastError() after the launches (0 on success).
extern "C" int event_engine_flush(const int32_t* idx, int64_t n_idx,
                                  const int32_t* path, int64_t depth,
                                  double* rem, double* rate, double* eta,
                                  double* due, int64_t n_slots,
                                  const double* link_bw,
                                  const double* link_act, double now,
                                  double* eta_min, void* stream,
                                  int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_idx > 0) {
    const int64_t blocks = (n_idx + kSlotThreads - 1) / kSlotThreads;
    event_flush_kernel<<<(unsigned)blocks, kSlotThreads, 0, st>>>(
        idx, n_idx, path, depth, rem, rate, eta, due, link_bw, link_act, now);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  eta_min_kernel<<<1, kReduceThreads, 0, st>>>(eta, n_slots, eta_min);
  return (int)cudaGetLastError();
}
