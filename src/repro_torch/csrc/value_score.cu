// Replica value-scoring pass for the replication economy (econ= flag).
//
// Replaces the Pallas TPU kernel _value_score_kernel
// (src/repro/kernels/value_score/kernel.py:38, pallas_call at :70). That
// kernel ran one fori_loop over holder rows carrying a (sites, files) running
// max in VMEM. The function: best[s, f] = max of bw[h, s] over the holders
// h != s of file f (self-supply excluded, 0 when there is none); then, as the
// oracle does (src/repro/kernels/value_score/ref.py:33): in "cost" mode
// demand * (size / best), the quotient first, and in "plain" mode demand;
// both 0 where best is 0, and the quotient is never formed there, so no
// 0 * inf arises. Max is exact and order-free, the divide and the multiply
// are true float64 ops and nothing is contracted (-fmad=false): the result is
// bit-identical to the oracle whatever order the holders are visited in.
//
// What bounds it: bytes. The function reads demand and presence once per
// cell, bw once per (holder, site) and sizes once per file, and writes one
// float64 per cell: ~110 KB at the economy_starved shape (52 sites x 100
// files) and ~10.5 MB at 500 sites x 1,000 files, ~3.1 us at 3.35 TB/s. Its
// compares are one per (holder h != s, site) of each file, ~2 M at ~4
// holders a file at the larger shape. The first version gave each cell a
// thread that walked all n_sites holder flags of its file, a chain of
// n_sites dependent flag and bw loads (17.9 us at 52 x 100, 220 us at
// 500 x 1,000 on the H100, PERF.md) for ~100x the compares the function
// needs.
//
// This design finds each file's holders once per block. A block of 32 x 32
// threads owns a tile of 32 files and a span of kChunks x 32 sites, and runs
// three phases:
//   1. holders: the block sweeps the tile's presence columns, each warp a
//      set of rows, lanes on neighbouring files (one 32-byte segment a row,
//      byte loads, so any n_files and alignment), and sets bit h of the
//      file's holder mask in shared memory (atomicOr; presence is sparse);
//   2. gather: a warp owns one file, its lanes neighbouring sites s; it pops
//      the set bits of the file's mask with __ffs and keeps four bw loads in
//      flight a round (four holders of one 32-site chunk, or one holder of
//      four), each load one contiguous 256-byte row segment
//      bw[h, s0 + 32 c + lane]. The running max of each (file, site) stays in
//      a register;
//   3. output: the maxima go through a [file][site] tile in shared memory,
//      and each thread scores kChunks cells with files on the lanes, so
//      demand is read and out written coalesced. Their demand and size are
//      loaded at the start, before phase 1, off the critical path.
// The mask buffer holds kPass holders; a larger n_sites runs phases 1-2
// again for each further kPass holders, folding into the same running max.
// The site span is picked per call: 32 sites up to 64 sites (more, smaller
// blocks, one holder round: the economy_starved shape runs 8 blocks), else
// 128, so one presence sweep serves four chunks and 500 x 1,000 runs 128
// blocks, one wave of one block an SM (64 registers a thread).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;                  // files a block, sites a chunk
constexpr int kThreads = kTile * kTile;    // threadIdx (x, y), 32 x 32
constexpr int kPass = 1024;                // holders one mask pass covers
constexpr int kWords = kPass / 32;         // mask words a file holds a pass
constexpr int kRows = 4;                   // presence rows a warp loads a round
constexpr int kLoads = 4;                  // bw loads a warp keeps in flight
constexpr int kWideSpan = 4;               // chunks a block above kNarrowSites
constexpr int64_t kNarrowSites = 2 * kTile;
static_assert(kWords * kTile == kThreads, "one mask word a thread");

template <int kChunks>
__global__ void __launch_bounds__(kThreads)
value_score_kernel(const double* __restrict__ demand,
                   const double* __restrict__ sizes,
                   const bool* __restrict__ presence,
                   const double* __restrict__ bw, int64_t n_sites,
                   int64_t n_files, int plain, double* __restrict__ out) {
  constexpr int kSpan = kTile * kChunks;
  constexpr int kPop = kLoads / kChunks;           // holders a round
  // bit j of holders[w][i]: holder pass0 + 32 w + j holds file f0 + i
  __shared__ uint32_t holders[kWords][kTile];
  __shared__ double best_tile[kTile][kSpan + 1];   // [file][site]
  const int x = threadIdx.x, y = threadIdx.y;      // warp y, lane x
  const int64_t f0 = (int64_t)blockIdx.x * kTile;
  const int64_t s0 = (int64_t)blockIdx.y * kSpan;

  // phase 3's cells (sites s0 + 32 c + y, file f0 + x): inputs loaded now
  const bool file_in = f0 + x < n_files;
  double d[kChunks];
  double size = 0.0;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t s = s0 + c * kTile + y;
    d[c] = file_in && s < n_sites ? demand[s * n_files + f0 + x] : 0.0;
  }
  if (file_in && !plain) size = sizes[f0 + x];

  // phase 2: file f0 + y, sites s0 + 32 c + x
  const bool gathers = f0 + y < n_files;
  double best[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) best[c] = 0.0;
  for (int64_t pass0 = 0; pass0 < n_sites; pass0 += kPass) {
    const int64_t pass_end = n_sites < pass0 + kPass ? n_sites : pass0 + kPass;
    holders[y][x] = 0u;
    __syncthreads();
    if (file_in) {
      const bool* col = presence + f0 + x;
      for (int64_t h = pass0 + y; h < pass_end; h += kRows * kTile) {
        bool held[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int64_t r = h + k * kTile;
          held[k] = r < pass_end && col[r * n_files];
        }
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (held[k]) {
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
          // a short round repeats the first holder, which max absorbs
          int h[kPop];
          h[0] = __ffs(m) - 1;
          m &= m - 1;
#pragma unroll
          for (int k = 1; k < kPop; ++k) {
            h[k] = m ? __ffs(m) - 1 : h[0];
            m &= m - 1;
          }
          double v[kPop][kChunks];
#pragma unroll
          for (int k = 0; k < kPop; ++k) {
            const int64_t hh = base + h[k];
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
              const int64_t s = s0 + c * kTile + x;
              v[k][c] = hh != s && s < n_sites ? bw[hh * n_sites + s] : 0.0;
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
  if (gathers) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) best_tile[y][c * kTile + x] = best[c];
  }
  __syncthreads();
  if (!file_in) return;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t s = s0 + c * kTile + y;
    if (s < n_sites) {
      const double b = best_tile[x][c * kTile + y];
      double v = 0.0;
      if (b > 0.0) v = plain ? d[c] : d[c] * (size / b);
      out[s * n_files + f0 + x] = v;
    }
  }
}

template <int kChunks>
void launch(const double* demand, const double* sizes, const bool* presence,
            const double* bw, int64_t n_sites, int64_t n_files, int plain,
            double* out, cudaStream_t stream) {
  constexpr int64_t span = (int64_t)kTile * kChunks;
  const dim3 grid((unsigned)((n_files + kTile - 1) / kTile),
                  (unsigned)((n_sites + span - 1) / span));
  value_score_kernel<kChunks><<<grid, dim3(kTile, kTile), 0, stream>>>(
      demand, sizes, presence, bw, n_sites, n_files, plain, out);
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
  const auto st = static_cast<cudaStream_t>(stream);
  if (n_sites <= kNarrowSites)
    launch<1>(demand, sizes, presence, bw, n_sites, n_files, plain, out, st);
  else
    launch<kWideSpan>(demand, sizes, presence, bw, n_sites, n_files, plain,
                      out, st);
  return (int)cudaGetLastError();
}
