// Shortest-transfer cost pass for the broker="jax" shortesttransfer broker.
//
// Replaces the Pallas TPU kernel _st_cost_kernel
// (src/repro/kernels/st_cost/kernel.py:44, pallas_call at :98). That kernel
// ran two fori_loops inside one program: over holder rows, carrying a
// (files, sites) running max in VMEM, then over files, carrying a
// (jobs, sites) running sum. The function, as the oracle computes it
// (src/repro/kernels/st_cost/ref.py:42):
//   best[f, s] = max of bw[h, s] over the fetchable holders h of file f
//     (0 when there is none; fetch need not lie inside presence, holders
//     need not be online, bw's diagonal need not be 0);
//   t[f, s] = 0 where s holds f, else size[f] / best, or inf where best is
//     0 (the divide is never formed there);
//   out[j, s] = the sum of t[f, s] over the files job j requires, in
//     ascending file order from 0.0, then max(sum, rel[s]); inf offline.
// Max is exact and order-free, the divide a true float64 divide, the sum
// sequential in the oracle's order (a term of a file held at s is an exact
// +0.0 and may be skipped: x + 0.0 == x on a sum that starts at +0.0), no
// atomics on floats, no tree sum and no contraction (-fmad=false): the
// result is bit-identical to the oracle. No inf - inf or 0 * inf is formed,
// so no NaN arises.
//
// What bounds it: bytes, and very few of them. Reading bw, the three masks,
// sizes, rel and online once and writing the costs once is ~59 KB at the
// bulk_shortest shape (52 sites, a 100-file union, 50 jobs), 0.018 us at
// 3.35 TB/s, and ~2.6 MB at a 500-site burst (a 401-file union, 50 jobs),
// 0.78 us. The work is a compare per (fetchable holder, site), a divide per
// (file, site) and an add per (required file, site): ~1.3 M operations at
// 500 sites. The first design ran a thread per (file, site) that walked all
// n_sites holder flags, then a thread per (job, site) that walked all
// n_files requirement flags, with presence read strided along sites: ~100 M
// predicated flag reads and 500-step dependent chains at 500 sites, 19.8 us
// at 52 sites and 122 us at 500 on the H100 (PERF.md), for ~100x the work.
//
// This design finds each file's holders and each job's files once per block
// and walks only those, in two launches joined by a (files, sites) float64
// buffer t_miss:
//   pass 1, missing_time_kernel: a block of 32 x 32 threads owns a tile of
//     32 files and a span of kChunks x 32 sites.
//     1. Lanes on neighbouring files read the tile's presence at the
//        block's own sites, one row a warp, and a ballot packs each site's
//        32 flags into one word in shared memory: presence is never read
//        strided along sites.
//     2. It sweeps the tile's fetch columns, each warp a set of holder rows
//        (kRows loads in flight), lanes on neighbouring files with byte
//        loads (any n_files and alignment), and sets bit h of the file's
//        holder mask in shared memory (atomicOr; fetch is sparse).
//     3. A warp owns one file, its lanes neighbouring sites s; it pops the
//        set bits with __ffs and keeps up to four bw loads in flight a
//        round, each a contiguous 256-byte row segment bw[h, s0 + 32c +
//        lane]; the running max stays in a register. A mask pass covers
//        kPass holders; more sites run the sweep and the gather again,
//        folding into the same max.
//     4. The same warp forms t (0 where the site's presence word has the
//        file's bit) and writes its t_miss row segment, coalesced.
//     The span is 32 sites up to 64 sites (8 blocks at bulk_shortest), else
//     128, so one fetch sweep serves four chunks (52 blocks at 500 x 401).
//   pass 2, job_cost_kernel: a block of kJobWarps warps owns as many jobs
//     and 32 sites, a warp a job, lanes on sites.
//     1. The warp reads its job's requirement row kList files at a time,
//        coalesced, one byte a lane and kAhead loads in flight; a ballot
//        turns each load into a mask word, and each required file's rank
//        (the set bits below it) puts its index in a per-warp list in
//        shared memory, in ascending file order.
//     2. It loads the listed files' t_miss values kSumLoads at a time,
//        coalesced along sites, and adds them strictly in list order from
//        0.0; then max(sum, rel[s]), inf offline.
//     Pass 2 is launched as pass 1's programmatic dependent (Hopper's
//     griddepcontrol): pass 1 lets it start at once, so its blocks load
//     rel, online and the requirement rows and build their lists while
//     pass 1 runs, and wait (griddepcontrol.wait: pass 1 complete, its
//     writes visible) only before the first t_miss load.
// Two launches, because the one-launch alternative (a block of 32 sites x
// 64 jobs walking the file axis in ascending 32-file tiles, each tile's t
// in shared memory) read 16.5-16.7 us at bulk_shortest and 94.7-95.6 us at
// 500 sites (PERF.md): each tile is a chain of dependent rounds on only 2
// or 16 blocks. Nothing is allocated, synchronised or read back, so a call
// can be captured in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;                  // files a tile, sites a chunk
constexpr int kThreads = kTile * kTile;    // pass 1: threadIdx (x, y)
constexpr int kPass = 1024;                // holders one mask pass covers
constexpr int kWords = kPass / 32;         // mask words a file holds a pass
constexpr int kRows = 8;                   // fetch rows a warp loads a round
constexpr int kLoads = 4;                  // bw loads a warp keeps in flight
constexpr int kWideSpan = 4;               // chunks a block above kNarrowSites
constexpr int64_t kNarrowSites = 2 * kTile;
constexpr int kJobWarps = 8;               // pass 2: jobs (warps) a block
constexpr int kAhead = 4;                  // pass 2: mask words a round
constexpr int kList = kAhead * kTile;      // pass 2: files a round
constexpr int kSumLoads = 8;               // pass 2: t_miss loads in flight
constexpr unsigned kAll = 0xffffffffu;
static_assert(kWords * kTile == kThreads, "one mask word a thread");

template <int kChunks>
__global__ void __launch_bounds__(kThreads)
missing_time_kernel(const double* __restrict__ bw,
                    const bool* __restrict__ fetch,
                    const bool* __restrict__ presence,
                    const double* __restrict__ sizes, int64_t n_sites,
                    int64_t n_files, double* __restrict__ t_miss) {
  constexpr int kSpan = kTile * kChunks;
  constexpr int kPop = kLoads / kChunks;           // holders a round
  // pass 2 may start now; it waits for this grid before reading t_miss
  asm volatile("griddepcontrol.launch_dependents;");
  // bit j of holders[w][i]: site pass0 + 32 w + j may send file f0 + i
  __shared__ uint32_t holders[kWords][kTile];
  // bit i of held[k]: site s0 + k holds file f0 + i
  __shared__ uint32_t held[kSpan];
  const int x = threadIdx.x, y = threadIdx.y;      // warp y, lane x
  const int64_t f0 = (int64_t)blockIdx.x * kTile;
  const int64_t s0 = (int64_t)blockIdx.y * kSpan;
  const bool file_in = f0 + x < n_files;

  // presence of file f0 + x at sites s0 + 32 c + y, one word a site
  bool here[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t s = s0 + c * kTile + y;
    here[c] = file_in && s < n_sites && presence[s * n_files + f0 + x];
  }
  // phases 2-3: file f0 + y, sites s0 + 32 c + x
  const bool gathers = f0 + y < n_files;
  const double size = gathers ? sizes[f0 + y] : 0.0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const uint32_t m = __ballot_sync(kAll, here[c]);
    if (x == 0) held[c * kTile + y] = m;
  }

  double best[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) best[c] = 0.0;
  for (int64_t pass0 = 0; pass0 < n_sites; pass0 += kPass) {
    const int64_t pass_end = n_sites < pass0 + kPass ? n_sites : pass0 + kPass;
    holders[y][x] = 0u;
    __syncthreads();
    if (file_in) {
      const bool* col = fetch + f0 + x;
      for (int64_t h = pass0 + y; h < pass_end; h += kRows * kTile) {
        bool sends[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int64_t r = h + k * kTile;
          sends[k] = r < pass_end && col[r * n_files];
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (sends[k]) {
            const int j = (int)(h + k * kTile - pass0);
            atomicOr(&holders[j >> 5][x], 1u << (j & 31));
          }
        }
      }
    }
    __syncthreads();
    if (gathers) {
      const int words = (int)((pass_end - pass0 + 31) >> 5);
      for (int w = 0; w < words; ++w) {
        uint32_t m = holders[w][y];
        const int64_t base = pass0 + 32 * w;
        while (m) {
          // a short round loads nothing for its empty places: best >= 0
          int64_t h[kPop];
          bool on[kPop];
#pragma unroll
          for (int k = 0; k < kPop; ++k) {
            on[k] = m != 0u;
            h[k] = on[k] ? base + __ffs(m) - 1 : 0;
            m &= m - 1;
          }
          double v[kPop][kChunks];
#pragma unroll
          for (int k = 0; k < kPop; ++k) {
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
              const int64_t s = s0 + c * kTile + x;
              v[k][c] = on[k] && s < n_sites ? bw[h[k] * n_sites + s] : 0.0;
            }
          }
#pragma unroll
          for (int k = 0; k < kPop; ++k)
#pragma unroll
            for (int c = 0; c < kChunks; ++c)
              best[c] = v[k][c] > best[c] ? v[k][c] : best[c];
        }
      }
    }
    if (pass_end < n_sites) __syncthreads();   // before the masks are reset
  }
  if (!gathers) return;
  double* row = t_miss + (f0 + y) * n_sites;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t s = s0 + c * kTile + x;
    if (s < n_sites) {
      double t = 0.0;
      if (!((held[c * kTile + x] >> y) & 1u))
        t = best[c] > 0.0 ? size / best[c] : INFINITY;
      row[s] = t;
    }
  }
}

__global__ void __launch_bounds__(kJobWarps * kTile)
job_cost_kernel(const double* __restrict__ t_miss,
                const bool* __restrict__ required,
                const double* __restrict__ rel,
                const bool* __restrict__ online, int64_t n_sites,
                int64_t n_files, int64_t n_jobs, double* __restrict__ out) {
  // the files warp y's job requires among the round's kList, ascending
  __shared__ int16_t list[kJobWarps][kList];
  const int x = threadIdx.x, y = threadIdx.y;      // lane: site s0 + x
  const int64_t j = (int64_t)blockIdx.x * kJobWarps + y;
  const int64_t s = (int64_t)blockIdx.y * kTile + x;
  if (j >= n_jobs) return;                         // the whole warp
  const bool site_in = s < n_sites;
  const double r = site_in ? rel[s] : 0.0;
  const bool up = site_in && online[s];
  const bool* req = required + j * n_files;
  const uint32_t below = (1u << x) - 1u;           // the lanes under x
  int16_t* mine = list[y];
  double t = 0.0;
  for (int64_t w0 = 0; w0 < n_files; w0 += kList) {
    bool needs[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int64_t f = w0 + k * kTile + x;
      needs[k] = f < n_files && req[f];
    }
    // each required file's rank among the round's: a ballot a word
    int n = 0;
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const uint32_t m = __ballot_sync(kAll, needs[k]);
      if (needs[k]) mine[n + __popc(m & below)] = (int16_t)(k * kTile + x);
      n += __popc(m);
    }
    __syncwarp();
    // pass 1 complete, its t_miss visible (at once after the first round)
    asm volatile("griddepcontrol.wait;" ::: "memory");
    // kSumLoads t_miss values loaded together, added in ascending order
    for (int i = 0; i < n; i += kSumLoads) {
      double v[kSumLoads];
#pragma unroll
      for (int q = 0; q < kSumLoads; ++q)
        v[q] = i + q < n && site_in
                   ? t_miss[(w0 + mine[i + q]) * n_sites + s] : 0.0;
#pragma unroll
      for (int q = 0; q < kSumLoads; ++q)
        if (i + q < n) t += v[q];
    }
    __syncwarp();                                  // before the next list
  }
  if (site_in) out[j * n_sites + s] = up ? (t > r ? t : r) : INFINITY;
}

template <int kChunks>
void launch_missing_time(const double* bw, const bool* fetch,
                         const bool* presence, const double* sizes,
                         int64_t n_sites, int64_t n_files, double* t_miss,
                         cudaStream_t stream) {
  constexpr int64_t span = (int64_t)kTile * kChunks;
  const dim3 grid((unsigned)((n_files + kTile - 1) / kTile),
                  (unsigned)((n_sites + span - 1) / span));
  missing_time_kernel<kChunks><<<grid, dim3(kTile, kTile), 0, stream>>>(
      bw, fetch, presence, sizes, n_sites, n_files, t_miss);
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_sites <= kNarrowSites)
    launch_missing_time<1>(bw, fetch, presence, sizes, n_sites, n_files,
                           t_miss, st);
  else
    launch_missing_time<kWideSpan>(bw, fetch, presence, sizes, n_sites,
                                   n_files, t_miss, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // launched as pass 1's programmatic dependent: its blocks start while
  // pass 1 runs and wait for it (griddepcontrol.wait) only for t_miss
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_jobs + kJobWarps - 1) / kJobWarps),
                     (unsigned)((n_sites + kTile - 1) / kTile));
  cfg.blockDim = dim3(kTile, kJobWarps);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, job_cost_kernel, t_miss, required, rel,
                           online, n_sites, n_files, n_jobs, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
