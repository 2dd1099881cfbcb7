// Batched replica-strategy plan pass for strategy_mode="batch".
//
// Replaces the Pallas TPU kernel _strategy_plan_kernel
// (src/repro/kernels/strategy_plan/kernel.py:45, pallas_call at :93). That
// kernel walked the site axis in one fori_loop over VMEM-resident
// (sites, pairs) blocks, the pair axis on the lanes. Here a block owns 32
// (job, missing-file) pair columns and splits the site axis over 32 groups
// of threads: thread (x, y) walks sites y, y + 32, y + 64, ... of pair x in
// ascending order, carrying two running maxima of the effective bandwidth
// bw[h, p] / (1.0 + serve[h]): over the fetchable holders (src_g) and over
// the fetchable holders in the destination's region (src_l). The sentinels
// are the oracle's (src/repro/kernels/strategy_plan/ref.py:259): masked keys
// are -1 and a running best starts at -2 and moves on a strict > only, so each
// group holds the first maximum of its sites. The groups are then combined in
// shared memory by the larger key, and on equal keys the lower site id, which
// gives the first maximum over all sites: ties keep the lowest site id and an
// all-masked column lands on site 0, exactly as np.argmax does. has_l is
// best_l >= 0 (bandwidth is nonnegative), inter_g is the winner's local flag
// negated, store_ok is free >= size. The divide is a true float64 divide and
// nothing is contracted (-fmad=false), so the result is bit-identical to the
// oracle.
//
// What bounds it: at the main-path shape (500 sites x 1,250 pairs of a
// grid_500_evict burst) it reads 10 bytes per (site, pair) cell, ~6.3 MB, or
// ~1.9 us of the card's 3.35 TB/s, against ~0.6 M float64 divides; so bytes.
// A first version gave each pair one thread walking all 500 sites: 10 blocks
// on 132 SMs and a 500-step dependent chain per thread (121.5 us on the H100,
// slower than the plain PyTorch version). Splitting the sites over 32 groups
// cuts the chain to 16 steps and puts 40 blocks of 1,024 threads on the card;
// a warp's 32 threads still read 32 neighbouring pairs of one site row
// (coalesced), and its serve value is one broadcast address.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPairs = 32;    // pair columns per block (threadIdx.x)
constexpr int kGroups = 32;   // site groups per block (threadIdx.y)

struct Pick {
  double best;
  int32_t site;
};

// b beats a: a larger key, or an equal key at a lower site id
__device__ __forceinline__ bool beats(double bk, int32_t bs, double ak,
                                      int32_t as) {
  return bk > ak || (bk == ak && bs < as);
}

__global__ void strategy_plan_kernel(
    const double* __restrict__ bw, const bool* __restrict__ fetch,
    const bool* __restrict__ local, const double* __restrict__ serve,
    const double* __restrict__ free_bytes, const double* __restrict__ size,
    int64_t n_sites, int64_t n_pairs, int32_t* __restrict__ sources,
    bool* __restrict__ flags) {
  __shared__ double s_best_g[kGroups][kPairs];
  __shared__ double s_best_l[kGroups][kPairs];
  __shared__ int32_t s_src_g[kGroups][kPairs];
  __shared__ int32_t s_src_l[kGroups][kPairs];
  __shared__ bool s_loc_g[kGroups][kPairs];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t p = (int64_t)blockIdx.x * kPairs + x;
  double best_g = -2.0, best_l = -2.0;
  int32_t src_g = INT32_MAX, src_l = INT32_MAX;
  bool loc_g = false;
  if (p < n_pairs) {
    for (int64_t h = y; h < n_sites; h += kGroups) {
      const int64_t at = h * n_pairs + p;
      const bool f = fetch[at];
      const bool l = local[at];
      const double eff = bw[at] / (1.0 + serve[h]);
      const double key_g = f ? eff : -1.0;
      const double key_l = (f && l) ? eff : -1.0;
      if (key_g > best_g) {
        best_g = key_g;
        src_g = (int32_t)h;
        loc_g = l;
      }
      if (key_l > best_l) {
        best_l = key_l;
        src_l = (int32_t)h;
      }
    }
  }
  s_best_g[y][x] = best_g;
  s_src_g[y][x] = src_g;
  s_loc_g[y][x] = loc_g;
  s_best_l[y][x] = best_l;
  s_src_l[y][x] = src_l;
  __syncthreads();
  if (y != 0 || p >= n_pairs) return;
  for (int k = 1; k < kGroups; ++k) {
    if (beats(s_best_g[k][x], s_src_g[k][x], best_g, src_g)) {
      best_g = s_best_g[k][x];
      src_g = s_src_g[k][x];
      loc_g = s_loc_g[k][x];
    }
    if (beats(s_best_l[k][x], s_src_l[k][x], best_l, src_l)) {
      best_l = s_best_l[k][x];
      src_l = s_src_l[k][x];
    }
  }
  sources[p] = src_g;
  sources[n_pairs + p] = src_l;
  flags[p] = best_l >= 0.0;
  flags[n_pairs + p] = !loc_g;
  flags[2 * n_pairs + p] = free_bytes[p] >= size[p];
}

}  // namespace

// Plan n_pairs pair columns over n_sites >= 1 sites. bw, fetch and local are
// (n_sites, n_pairs) row-major; serve is (n_sites,), free_bytes and size
// (n_pairs,). Writes sources (2, n_pairs) int32 rows src_g, src_l and flags
// (3, n_pairs) bool rows has_l, inter_g, store_ok. Launches on `stream` of
// `device`; returns cudaGetLastError() after the launch (0 on success).
extern "C" int strategy_plan(const double* bw, const bool* fetch,
                             const bool* local, const double* serve,
                             const double* free_bytes, const double* size,
                             int64_t n_sites, int64_t n_pairs,
                             int32_t* sources, bool* flags, void* stream,
                             int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (n_pairs + kPairs - 1) / kPairs;
  strategy_plan_kernel<<<(unsigned)blocks, dim3(kPairs, kGroups), 0,
                         static_cast<cudaStream_t>(stream)>>>(
      bw, fetch, local, serve, free_bytes, size, n_sites, n_pairs, sources,
      flags);
  return (int)cudaGetLastError();
}
