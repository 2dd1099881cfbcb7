// Shortest-transfer cost pass for the broker="jax" shortesttransfer broker.
//
// Replaces the Pallas TPU kernel _st_cost_kernel
// (src/repro/kernels/st_cost/kernel.py:44, pallas_call at :98). That kernel
// ran two fori_loops inside one program: over holder rows, carrying a
// (files, sites) running max in VMEM, then over files, carrying a
// (jobs, sites) running sum. Blocks of a CUDA grid run in no order, so the
// two passes are two launches here, with the (files, sites) buffer in device
// memory between them:
//
//   pass 1, one thread per (f, s): best = max of bw[h, s] over the fetchable
//     holders h of file f (0 when none), then t = size / best, or inf when
//     best is 0; the thread writes 0.0 instead where s already holds f, so the
//     buffer is the per-(file, site) staging time of a *missing* file;
//   pass 2, one thread per (j, s): the sum of that buffer over the files job j
//     requires, in ascending file order, started at 0.0; then max(t, rel[s]),
//     and inf at offline sites.
//
// This is the oracle's function (src/repro/kernels/st_cost/ref.py:565): the
// max is order-free, and the oracle's per-job sum is sequential in ascending
// file order and skips the files not missing, which is exact because
// x + 0.0 == x on a nonnegative sum. No tree reduction, no atomics, true
// float64 divides and no contraction (-fmad=false): bit-identical to it.
//
// What bounds it: the function itself needs little. At the 500-site shape (a
// burst's file union of ~400 files, 50 jobs) it reads ~2.6 MB and does ~1.3 M
// compares and adds over the fetchable holders and missing files it touches,
// so bytes: ~0.8 us at 3.35 TB/s. This simple design does far more: pass 1
// walks every holder row for every (f, s), ~80 M predicated flag reads, and
// pass 2 every file for every (j, s), each a chain of dependent steps in one
// thread; it runs at ~120 us on the H100 (PERF.md). Neighbouring threads own
// neighbouring sites, so the bw row, the pass-1 buffer and the output are
// read and written coalesced, and a file's fetch and requirement flags are
// one broadcast address per warp. Walking only the nonzero holders and
// required files is the way to the bound, left for later work.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void missing_time_kernel(const double* __restrict__ bw,
                                    const bool* __restrict__ fetch,
                                    const bool* __restrict__ presence,
                                    const double* __restrict__ sizes,
                                    int64_t n_sites, int64_t n_files,
                                    double* __restrict__ t_miss) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_files * n_sites) return;
  const int64_t f = i / n_sites;
  const int64_t s = i - f * n_sites;
  double best = 0.0;
  for (int64_t h = 0; h < n_sites; ++h) {
    if (fetch[h * n_files + f]) {
      const double v = bw[h * n_sites + s];
      best = v > best ? v : best;
    }
  }
  const double t = best > 0.0 ? sizes[f] / best : INFINITY;
  t_miss[i] = presence[s * n_files + f] ? 0.0 : t;
}

__global__ void job_cost_kernel(const double* __restrict__ t_miss,
                                const bool* __restrict__ required,
                                const double* __restrict__ rel,
                                const bool* __restrict__ online,
                                int64_t n_sites, int64_t n_files,
                                int64_t n_jobs, double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_jobs * n_sites) return;
  const int64_t j = i / n_sites;
  const int64_t s = i - j * n_sites;
  const bool* req = required + j * n_files;
  double t = 0.0;
  for (int64_t f = 0; f < n_files; ++f) {
    if (req[f]) t += t_miss[f * n_sites + s];
  }
  const double r = rel[s];
  out[i] = online[s] ? (t > r ? t : r) : INFINITY;
}

}  // namespace

// Cost n_jobs jobs at n_sites sites over n_files files. bw is
// (n_sites, n_sites) [holder, site]; fetch and presence (n_sites, n_files);
// sizes (n_files,); required (n_jobs, n_files); rel and online (n_sites,);
// t_miss is (n_files, n_sites) scratch; out (n_jobs, n_sites). Two launches on
// `stream` of `device`; returns cudaGetLastError() (0 on success).
extern "C" int st_cost(const double* bw, const bool* fetch,
                       const bool* presence, const double* sizes,
                       const bool* required, const double* rel,
                       const bool* online, int64_t n_sites, int64_t n_files,
                       int64_t n_jobs, double* t_miss, double* out,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n1 = n_files * n_sites;
  missing_time_kernel<<<(unsigned)((n1 + kThreads - 1) / kThreads), kThreads,
                        0, st>>>(bw, fetch, presence, sizes, n_sites, n_files,
                                 t_miss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n2 = n_jobs * n_sites;
  job_cost_kernel<<<(unsigned)((n2 + kThreads - 1) / kThreads), kThreads, 0,
                    st>>>(t_miss, required, rel, online, n_sites, n_files,
                          n_jobs, out);
  return (int)cudaGetLastError();
}
