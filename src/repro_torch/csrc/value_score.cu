// Replica value-scoring pass for the replication economy (econ= flag).
//
// Replaces the Pallas TPU kernel _value_score_kernel
// (src/repro/kernels/value_score/kernel.py:38, pallas_call at :70). That
// kernel ran one fori_loop over holder rows carrying a (sites, files) running
// max in VMEM. Here one thread owns one (site, file) cell and loops over the
// holders itself: best = max of bw[h, s] over the holders h != s of file f
// (self-supply excluded, 0 when there is none). Then, as the oracle does
// (src/repro/kernels/value_score/ref.py:842): in "cost" mode
// demand * (size / best), the quotient first, and in "plain" mode demand;
// both 0 where best is 0, and the quotient is never formed there, so no
// 0 * inf arises. Max is order-free, the divide and the multiply are true
// float64 ops and nothing is contracted (-fmad=false): bit-identical to the
// oracle.
//
// What bounds it: the function reads ~10.5 MB at the 500-site x 1,000-file
// shape (demand, presence, bw once, the output written once) and needs one
// compare per (holder, site) of each file, ~2.5 M at ~3 holders a file: so
// bytes, ~3.1 us at 3.35 TB/s. This simple design walks all 500 holder flags
// for each cell, ~250 M predicated flag reads in 500-step chains, and runs at
// ~220 us on the H100 (PERF.md). Neighbouring threads own neighbouring files
// of one site row, so a holder's presence row is read coalesced and its
// bw[h, s] is one broadcast address per warp. Walking each file's holder list
// once for a block of sites is the way to the bound, left for later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void value_score_kernel(const double* __restrict__ demand,
                                   const double* __restrict__ sizes,
                                   const bool* __restrict__ presence,
                                   const double* __restrict__ bw,
                                   int64_t n_sites, int64_t n_files,
                                   int plain, double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_sites * n_files) return;
  const int64_t s = i / n_files;
  const int64_t f = i - s * n_files;
  double best = 0.0;
  for (int64_t h = 0; h < n_sites; ++h) {
    if (h != s && presence[h * n_files + f]) {
      const double v = bw[h * n_sites + s];
      best = v > best ? v : best;
    }
  }
  double v = 0.0;
  if (best > 0.0) v = plain ? demand[i] : demand[i] * (sizes[f] / best);
  out[i] = v;
}

}  // namespace

// Score the (n_sites, n_files) value matrix: demand and presence are
// (n_sites, n_files), sizes (n_files,), bw (n_sites, n_sites) [holder, site];
// plain selects "plain" over "cost" mode. One launch on `stream` of `device`;
// returns cudaGetLastError() (0 on success).
extern "C" int value_score(const double* demand, const double* sizes,
                           const bool* presence, const double* bw,
                           int64_t n_sites, int64_t n_files, int plain,
                           double* out, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t n = n_sites * n_files;
  value_score_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      demand, sizes, presence, bw, n_sites, n_files, plain, out);
  return (int)cudaGetLastError();
}
