// Batched replica-strategy plan pass for strategy_mode="batch".
//
// Replaces the Pallas TPU kernel _strategy_plan_kernel
// (src/repro/kernels/strategy_plan/kernel.py:45, pallas_call at :93). That
// kernel walked the site axis in one fori_loop over VMEM-resident
// (sites, pairs) blocks, the pair axis on the lanes. The function, for every
// (job, missing-file) pair column p: the first argmax over sites of the
// effective bandwidth bw[h, p] / (1.0 + serve[h]) among the fetchable holders
// (src_g) and among the fetchable holders in the destination's region
// (src_l), with the oracle's sentinels (src/repro/kernels/strategy_plan/
// ref.py:44): a masked key is -1, so an all-masked column lands on site 0;
// then has_l = best_l >= 0 (bandwidth is nonnegative), inter_g = !local at
// the global pick, store_ok = free >= size.
//
// What bounds it: bytes, and fewer than the first version read. The result
// depends on fetch at every cell, on bw and local only where fetch holds
// (a masked key is -1 whatever they hold), on serve per site and on free,
// size and the outputs per pair. A grid_500_evict burst (500 sites x 1,250
// pairs, ~5 fetchable holders a pair) needs ~0.7 MB, ~0.2 us at 3.35 TB/s;
// counted at 10 bytes a cell, as the first version read, it was ~6.3 MB,
// ~1.9 us. Its divides are one per fetchable cell, ~6 K.
//
// The first version gave a block 32 pairs and 32 site groups: 40 blocks on
// the 132 SMs, and every thread loaded bw, local and serve and ran an IEEE
// float64 divide (a ~20-instruction sequence) on each of its 16 cells, 99%
// of them thrown away under the mask (8.68 us on the H100, PERF.md). Here a
// block owns kPairs = 8 pair columns and splits the sites over kGroups = 32
// groups (157 blocks of 256 threads at 1,250 pairs, all in flight at once):
// thread (x, y) owns sites y, y + 32, ... of pair x. A round of kRound = 16
// of them (one round at 500 sites) goes in three steps:
//   1. the 16 fetch flags are loaded together and kept as a bitmask;
//   2. the masked cells need no load: their key is -1, so of them only the
//      lowest site, the lowest clear bit, can be the thread's pick;
//   3. the set bits are popped with __ffs, kPop at a time: bw, serve and
//      local are loaded for those cells only, all before the divides.
// Picks are combined by the larger key, and on equal keys the lower site
// id. That is a total order, so the order of the candidates and the shape of
// the combine do not change the result: each thread holds the first maximum
// of its sites, the four groups of a warp are combined by shuffles and the
// eight warps through shared memory, which gives the first maximum over all
// sites, as np.argmax gives it. inter_g reads local at the winning row, once
// per pair, after the combine. Divides are true float64 divides and nothing
// is contracted (-fmad=false), so the result is bit-identical to the oracle.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPairs = 8;                  // pair columns a block (x)
constexpr int kGroups = 32;                // site groups a block (y)
constexpr int kThreads = kPairs * kGroups;
constexpr int kWarpGroups = 32 / kPairs;   // site groups in one warp
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 16;                 // sites a thread flags at once
constexpr int kPop = 2;                    // fetchable cells loaded at once
static_assert(kWarps >= kWarpGroups && kRound <= 32, "combine, bitmask");

struct Pick {
  double key;
  int32_t site;
};

// b beats a: a larger key, or an equal key at a lower site id
__device__ __forceinline__ bool beats(const Pick& b, const Pick& a) {
  return b.key > a.key || (b.key == a.key && b.site < a.site);
}

__device__ __forceinline__ void take(Pick& a, const Pick& b) {
  if (beats(b, a)) a = b;
}

// The better of `p` and the pick `lanes` lanes away (same pair column).
__device__ __forceinline__ Pick shfl_best(Pick p, int lanes) {
  Pick o;
  o.key = __shfl_xor_sync(0xffffffffu, p.key, lanes);
  o.site = __shfl_xor_sync(0xffffffffu, p.site, lanes);
  return beats(o, p) ? o : p;
}

__global__ void __launch_bounds__(kThreads)
strategy_plan_kernel(const double* __restrict__ bw,
                     const bool* __restrict__ fetch,
                     const bool* __restrict__ local,
                     const double* __restrict__ serve,
                     const double* __restrict__ free_bytes,
                     const double* __restrict__ size, int64_t n_sites,
                     int64_t n_pairs, int32_t* __restrict__ sources,
                     bool* __restrict__ flags) {
  __shared__ Pick warp_g[kWarps][kPairs];
  __shared__ Pick warp_l[kWarps][kPairs];
  const int x = threadIdx.x, y = threadIdx.y;
  const int64_t p = (int64_t)blockIdx.x * kPairs + x;
  const bool owns = p < n_pairs;
  // the writer's per-pair verdict, loaded now
  bool store_ok = false;
  if (owns && y == 0) store_ok = free_bytes[p] >= size[p];

  Pick g{-2.0, INT32_MAX}, l{-2.0, INT32_MAX};
  if (owns) {
    for (int64_t h0 = y; h0 < n_sites; h0 += kRound * kGroups) {
      // bit k: site h0 + k * kGroups
      bool f[kRound];
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        const int64_t h = h0 + k * kGroups;
        f[k] = h < n_sites && fetch[h * n_pairs + p];
      }
      uint32_t sites = 0, fetchable = 0;
#pragma unroll
      for (int k = 0; k < kRound; ++k) {
        sites |= (uint32_t)(h0 + k * kGroups < n_sites) << k;
        fetchable |= (uint32_t)f[k] << k;
      }
      // the masked cells' key is -1: the lowest one is their best
      uint32_t masked = sites & ~fetchable;
      if (masked)
        take(g, Pick{-1.0, (int32_t)(h0 + (__ffs(masked) - 1) * kGroups)});
      uint32_t in_region = 0, m = fetchable;
      while (m) {
        // a short round repeats the first cell, which the max absorbs
        int k[kPop];
        k[0] = __ffs(m) - 1;
        m &= m - 1;
#pragma unroll
        for (int j = 1; j < kPop; ++j) {
          k[j] = m ? __ffs(m) - 1 : k[0];
          m &= m - 1;
        }
        double b[kPop], sv[kPop];
        bool lc[kPop];
#pragma unroll
        for (int j = 0; j < kPop; ++j) {
          const int64_t h = h0 + k[j] * kGroups;
          b[j] = bw[h * n_pairs + p];
          sv[j] = serve[h];
          lc[j] = local[h * n_pairs + p];
        }
#pragma unroll
        for (int j = 0; j < kPop; ++j) {
          const Pick c{b[j] / (1.0 + sv[j]),
                       (int32_t)(h0 + k[j] * kGroups)};
          take(g, c);
          if (lc[j]) {
            take(l, c);
            in_region |= 1u << k[j];
          }
        }
      }
      // key_l is -1 where fetch or local is clear
      masked = sites & ~in_region;
      if (masked)
        take(l, Pick{-1.0, (int32_t)(h0 + (__ffs(masked) - 1) * kGroups)});
    }
  }
  // the kWarpGroups groups of a warp: lanes x, x + 8, x + 16, x + 24
#pragma unroll
  for (int lanes = kPairs; lanes < 32; lanes <<= 1) {
    g = shfl_best(g, lanes);
    l = shfl_best(l, lanes);
  }
  const int warp = y / kWarpGroups;
  if (y % kWarpGroups == 0) {
    warp_g[warp][x] = g;
    warp_l[warp][x] = l;
  }
  __syncthreads();
  if (y >= kWarpGroups) return;   // warp 0 combines the warps
  g = warp_g[y][x];
  l = warp_l[y][x];
  for (int w = y + kWarpGroups; w < kWarps; w += kWarpGroups) {
    take(g, warp_g[w][x]);
    take(l, warp_l[w][x]);
  }
#pragma unroll
  for (int lanes = kPairs; lanes < 32; lanes <<= 1) {
    g = shfl_best(g, lanes);
    l = shfl_best(l, lanes);
  }
  if (y != 0 || !owns) return;
  sources[p] = g.site;
  sources[n_pairs + p] = l.site;
  flags[p] = l.key >= 0.0;
  flags[n_pairs + p] = !local[(int64_t)g.site * n_pairs + p];
  flags[2 * n_pairs + p] = store_ok;
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
