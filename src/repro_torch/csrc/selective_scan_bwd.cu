// Backward of the Mamba-1 selective scan (selective_scan.cu) for the
// training path: every mamba1 layer of falcon-mamba-7b, once a step.
//
// Replaces no TPU kernel: the reference differentiates its jnp scan
// _selective_scan_chunked (src/repro/models/mamba.py:69) with jax.grad,
// and its Pallas kernel _scan_kernel (src/repro/kernels/selective_scan/
// kernel.py:29) has no backward. The forward, per (batch, channel d,
// state n),
//
//   a_t = exp(dt_t A);  h_t = a_t h_{t-1} + dt_t x_t B_t;
//   y_t = h_t . C_t + D x_t,
//
// has, from dy and the final state's gradient dh_last, the reverse
// recurrence
//
//   g_t = dy_t C_t + a_{t+1} g_{t+1}   (g_{S-1} = dy C + dh_last),
//   dx_t = dt_t (g_t . B_t) + D dy_t,
//   ddt_t = x_t (g_t . B_t) + (g_t a_t h_{t-1}) . A,
//   dB_t = sum_d g_t dt_t x_t,   dC_t = sum_d dy_t h_t,
//   dA = sum_{b,t} g_t a_t h_{t-1} dt_t,   dD = sum_{b,t} dy_t x_t,
//   dh0 = a_0 g_0.
//
// It needs h_{t-1} and a_t at every step, walked last to first; stepping h
// back by dividing by a_t is unstable. So the forward saves h at the end
// of each 16-step round (`states`, (Bz, ceil(S / 16), Di, N) float32), and
// this kernel walks the rounds last to first. The grid and the lanes are
// the forward's: a block serves 64 channels of one batch row, 4 lanes of
// 4 states a channel; each round's x, dt, dy rows and B, C runs (B and C
// padded to 16 states a step) are staged in shared memory by cp.async,
// double-buffered: round r - 1's copies, and its starting state into
// registers, fly while round r is walked. A round, from its starting
// state h_s (the previous round's saved state, or h0), in four passes:
//
//   1. forward through its 16 steps: each a_t by one ex2.approx.ftz into
//      the round's history in shared memory (a float4 a thread a step,
//      64 KB a block), h_{t-1} of steps 8-15 into registers;
//   2. back through steps 15-8;
//   3. forward through steps 0-7 again from h_s with the saved a_t (no
//      exponential), h_{t-1} into the same registers;
//   4. back through steps 7-0.
//
// So each (batch, channel, state, step) takes one exponential, and a
// thread keeps 8 steps of h_{t-1} (32 floats), not 16. Registers are what
// sets the occupancy: at 128 a thread (__launch_bounds__(256, 2); ptxas
// gives 124-128 and no spill) two blocks, 16 warps, share an SM, and
// their 2 x 108 KB of shared memory in float32 (94 KB in bf16) fit its
// 228 KB. What keeps it there: the copy plan packed two granules an int,
// A kept only as A log2(e) (ddt's A term is scaled by ln 2 once a step),
// channels past Di and states past N read as zeros staged once, and the
// walk back forming h_t = a_t h_{t-1} + dt x B for dC, so dB's and dC's
// terms meet in one step.
//
// The sums, in a fixed order and without float atomics, so two calls are
// bit-equal: dx and ddt over a channel's 4 lanes by two xor shuffles
// (lane 0 writes dx, lane 1 ddt); dB's and dC's 8 terms of a lane over the
// 8 channels of a warp by one scattering xor-shuffle sum (7 shuffles; each
// thread is left one of the 8 sums), then over the block's 8 warps in
// ascending order once a round, written as per-block partials (Bz, S,
// ceil(Di / 64), N); dA and dD kept in registers across time and written
// as per-row partials (Bz, Di, N) and (Bz, Di). A second launch sums the
// partials in ascending block (dB, dC) and batch (dA, dD) order and
// rounds dB and dC to the streams' dtype. A, D, h0, the states, dh_last,
// dA, dD, dh0 and all arithmetic are float32; x, dt, B, C, dy, dx, ddt, dB
// and dC are bf16 or float32. The exponential is ex2.approx.ftz, not the
// forward's exp2f: the same MUFU.EX2 without exp2f's subnormal handling,
// held to the plain version's tolerance.
//
// What bounds it: at falcon-mamba-7b's shape (Bz 4, S 1024, Di 8192,
// N 16, float32) it must read x, dt and dy and write dx and ddt:
// 5 x 134,217,728 B = 671.1 MB, 200.3 us at 3.35 TB/s; its 536,870,912
// exponentials take 128.4 us on the special-function units. The bound is
// the bytes. The kernel also reads the states (134.2 MB) and recomputes
// half of each round's h; it is bound by instruction issue and latency at
// 16 warps an SM, not by bytes or exponentials: taken out one at a time,
// the dB/dC channel sums cost the most, then the copies and the
// recompute, the exponentials least (dev/ablate_scan_bwd.py; the times,
// beside the first version's in dev/scan_bwd_first, are in PERF.md
// section 6, row 7b).

#include <cstdint>

#include "selective_scan.cuh"

namespace {

constexpr int kWarps = kThreads / 32;   // warps a block
constexpr int kHalf = kSteps / 2;       // steps of h_{t-1} in registers
constexpr int kBlocksPerSm = 2;         // resident blocks the design wants
constexpr float kLn2 = 0.6931471805599453f;

// One round's inputs: x, dt and dy rows of the block's channels, B and C
// of the round's steps (kMaxN states a step).
template <typename T>
struct __align__(16) Stage {
  T x[kSteps][kCh];
  T dt[kSteps][kCh];
  T dy[kSteps][kCh];
  T b[kSteps * kMaxN];
  T c[kSteps * kMaxN];
};

// A block's dynamic shared memory.
template <typename T>
struct __align__(16) Smem {
  Stage<T> stage[2];
  float4 hist[kSteps][kThreads];           // the round's a_t, by thread
  float sums[kSteps][kWarps][2 * kMaxN];   // dB | dC over a warp's channels
};

// A CopyPlan (selective_scan.cuh) two granules an int, to spare
// registers: the granule's row in bits 0-4 of a 16-bit half, its byte
// column in bits 5-15.
struct PackedPlan {
  uint32_t w[kRowCopies / 2];
};

__device__ inline PackedPlan pack_plan(const CopyPlan& p) {
  PackedPlan q;
#pragma unroll
  for (int m = 0; m < kRowCopies / 2; ++m)
    q.w[m] = (uint32_t)(p.row[2 * m] | p.col[2 * m] << 5) |
             (uint32_t)(p.row[2 * m + 1] | p.col[2 * m + 1] << 5) << 16;
  return q;
}

// Issue the copies of the round of `steps` steps from t0 into `s`. B and
// C land kMaxN states a step apart: in one run when N = 16 (kFull), else
// element by element (states past N are never written).
template <typename T, bool kFull>
__device__ inline void stage_round(Stage<T>& s, const T* x, const T* dt,
                                   const T* dy, const T* bm, const T* cm,
                                   const PackedPlan& plan, int64_t b,
                                   int64_t t0, int steps, int64_t S,
                                   int64_t Di, int64_t d0, int N, int gx,
                                   int gb, int tid) {
  constexpr int sz = sizeof(T);
  const int64_t row = ((b * S + t0) * Di + d0) * sz;
  const char* xs = reinterpret_cast<const char*>(x) + row;
  const char* ds = reinterpret_cast<const char*>(dt) + row;
  const char* ys = reinterpret_cast<const char*>(dy) + row;
#pragma unroll
  for (int m = 0; m < kRowCopies; ++m) {
    const uint32_t half = plan.w[m / 2] >> (16 * (m % 2));
    const int i = half & 31, c = (half >> 5) & 2047;
    if (i >= steps) continue;
    const int64_t at = i * Di * sz + c;
    copy_granule(reinterpret_cast<char*>(s.x[i]) + c, xs + at, gx);
    copy_granule(reinterpret_cast<char*>(s.dt[i]) + c, ds + at, gx);
    copy_granule(reinterpret_cast<char*>(s.dy[i]) + c, ys + at, gx);
  }
  const char* bs = reinterpret_cast<const char*>(bm) + (b * S + t0) * N * sz;
  const char* cs = reinterpret_cast<const char*>(cm) + (b * S + t0) * N * sz;
  if (kFull) {
    for (int at = tid * gb; at < steps * N * sz; at += kThreads * gb) {
      copy_granule(reinterpret_cast<char*>(s.b) + at, bs + at, gb);
      copy_granule(reinterpret_cast<char*>(s.c) + at, cs + at, gb);
    }
  } else {
    for (int e = tid; e < steps * N; e += kThreads) {
      const int i = e / N, at = i * kMaxN + e - i * N;
      copy_granule(reinterpret_cast<char*>(&s.b[at]), bs + e * sz, sz);
      copy_granule(reinterpret_cast<char*>(&s.c[at]), cs + e * sz, sz);
    }
  }
}

// Row i of a staged B or C run, this lane's 4 states.
template <typename T>
__device__ inline void read_row(const T* m, int i, int n0,
                                float (&v)[kPer]) {
  load4(&m[i * kMaxN + n0], v);
}

// a_t = 2^x, one MUFU.EX2, subnormal results flushed to zero.
__device__ inline float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline void store_history(float4 (*hist)[kThreads], int i,
                                     int tid, const float (&av)[kPer]) {
  hist[i][tid] = make_float4(av[0], av[1], av[2], av[3]);
}

__device__ inline void load_history(const float4 (*hist)[kThreads], int i,
                                    int tid, float (&av)[kPer]) {
  const float4 q = hist[i][tid];
  av[0] = q.x, av[1] = q.y, av[2] = q.z, av[3] = q.w;
}

// The sums of v[0..7] over the 8 channels of a warp (lane bits 2-4) that
// share this thread's lane (bits 0-1), scattered: a thread gets the sum of
// v[wl >> 2], by seven xor shuffles (four at 16, two at 8, one at 4) in a
// fixed order.
__device__ inline float channel_sum8(const float (&v)[2 * kPer], int wl) {
  const bool hi = wl & 16, mid = wl & 8, lo = wl & 4;
  float k4[4], k2[2];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    k4[m] = (hi ? v[4 + m] : v[m]) +
            __shfl_xor_sync(~0u, hi ? v[m] : v[4 + m], 16);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    k2[m] = (mid ? k4[2 + m] : k4[m]) +
            __shfl_xor_sync(~0u, mid ? k4[m] : k4[2 + m], 8);
  return (lo ? k2[1] : k2[0]) + __shfl_xor_sync(~0u, lo ? k2[0] : k2[1], 4);
}

// Over a channel's 4 lanes: the sum of p on lanes of even bit 0, of q on
// odd ones, by two xor shuffles (1, 2).
__device__ inline float lane_sum2(float p, float q, int wl) {
  const bool odd = wl & 1;
  float k = odd ? q : p;
  k += __shfl_xor_sync(~0u, odd ? p : q, 1);
  return k + __shfl_xor_sync(~0u, k, 2);
}

// x, dt, dy, dx, ddt (Bz, S, Di); bm, cm (Bz, S, N); a (Di, N); dskip
// (Di,); h0, dh_last (null: zero), dh0 (Bz, Di, N); states (Bz, rounds,
// Di, N); part_db, part_dc (Bz, S, gridDim.x, N); part_da (Bz, Di, N);
// part_dd (Bz, Di). Grid (ceil(Di / kCh), Bz); sizeof(Smem<T>) bytes of
// dynamic shared memory.
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ a,
                    const float* __restrict__ dskip,
                    const float* __restrict__ h0,
                    const float* __restrict__ states,
                    const T* __restrict__ dy,
                    const float* __restrict__ dh_last, T* __restrict__ dx,
                    T* __restrict__ ddt, float* __restrict__ dh0,
                    float* __restrict__ part_db, float* __restrict__ part_dc,
                    float* __restrict__ part_da, float* __restrict__ part_dd,
                    int64_t S, int64_t Di, int N, int gx, int gb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x, wl = tid % 32, warp = tid / 32;
  const int ch = tid / kLanes, lane = tid % kLanes, n0 = lane * kPer;
  const int64_t b = blockIdx.y, nblk = gridDim.x;
  const int64_t d0 = (int64_t)blockIdx.x * kCh;
  const int nch = (int)(Di - d0 < kCh ? Di - d0 : kCh);
  const int64_t d = d0 + ch;
  const bool live = ch < nch;
  const int64_t rounds = (S + kSteps - 1) / kSteps;
  // where this thread's one sum of channel_sum8 goes in a sums row: dB
  // (terms 0-3) or dC (4-7) of state n0 + (term & 3)
  const int term = wl >> 2;
  const int slot = (term >> 2) * kMaxN + n0 + (term & 3);

  // the last round's copies fly while the state rows are read
  const PackedPlan plan =
      pack_plan(plan_copies(nch * (int)sizeof(T), gx, tid));
  {
    const int64_t t0 = (rounds - 1) * kSteps;
    stage_round<T, kFull>(sm.stage[(rounds - 1) & 1], x, dt, dy, bm, cm,
                          plan, b, t0, (int)(S - t0), S, Di, d0, N, gx, gb,
                          tid);
  }
  cp_async_commit();
  if (nch < kCh) {   // channels past Di read zeros from both stages
    for (int k = tid; k < 2 * 3 * kSteps * kCh; k += kThreads) {
      T* rows = &sm.stage[k / (3 * kSteps * kCh)].x[0][0];
      if (k % kCh >= nch) store(rows + k % (3 * kSteps * kCh), 0.f);
    }
  }
  if (!kFull) {   // and states past N
    for (int k = tid; k < 2 * 2 * kSteps * kMaxN; k += kThreads) {
      T* runs = &sm.stage[k / (2 * kSteps * kMaxN)].b[0];
      if (k % kMaxN >= N) store(runs + k % (2 * kSteps * kMaxN), 0.f);
    }
  }
  float g_next[kPer], a2[kPer], da[kPer], hs_next[kPer];
  if (dh_last != nullptr) {
    load_state<kFull>(dh_last + (b * Di + d) * N, n0, N, live, g_next);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) g_next[j] = 0.f;
  }
  load_state<kFull>(a + d * N, n0, N, live, a2);
#pragma unroll
  for (int j = 0; j < kPer; ++j) a2[j] *= kLog2e, da[j] = 0.f;
  // the starting state of round r: h0, or the state saved at the end of
  // round r - 1
  const float* h0_row = h0 + (b * Di + d) * N;
  const float* state_rows = states + (b * rounds * Di + d) * N;
  const int64_t round_stride = Di * N;
  load_state<kFull>(rounds == 1 ? h0_row
                                : state_rows + (rounds - 2) * round_stride,
                    n0, N, live, hs_next);
  // lane 0 writes dx (adding D dy), lane 1 ddt
  const bool writes = live && lane < 2;
  const float dd = live && lane == 0 ? dskip[d] : 0.f;
  float dsum = 0.f;   // dD's share of this row: dy * x over time

  for (int64_t r = rounds - 1; r >= 0; --r) {
    const int64_t t0 = r * kSteps;
    const int steps = (int)(S - t0 < kSteps ? S - t0 : kSteps);
    if (r > 0)
      stage_round<T, kFull>(sm.stage[(r - 1) & 1], x, dt, dy, bm, cm, plan,
                            b, t0 - kSteps, kSteps, S, Di, d0, N, gx, gb,
                            tid);
    cp_async_commit();   // empty on the first round
    float hs[kPer];      // h_s, the round's starting state
#pragma unroll
    for (int j = 0; j < kPer; ++j) hs[j] = hs_next[j];
    if (r > 0)   // read ahead: round r - 1's starting state
      load_state<kFull>(r == 1 ? h0_row : state_rows + (r - 2) * round_stride,
                        n0, N, live, hs_next);
    cp_async_wait<1>();  // this thread's copies of round r have landed
    __syncthreads();     // and every thread's
    const Stage<T>& s = sm.stage[r & 1];
    T* const out = (lane == 1 ? ddt : dx) + (b * S + t0) * Di + d;

    // 1. forward through the round: a_t into the history, h_{t-1} of the
    // second half into hp
    float h[kPer], hp[kHalf][kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) h[j] = hs[j];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < steps) {
        const float dtv = to_float(s.dt[i][ch]);
        const float xv = to_float(s.x[i][ch]);
        const float dtx = dtv * xv;
        float bv[kPer], av[kPer];
        read_row(s.b, i, n0, bv);
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          av[j] = ex2_ftz(dtv * a2[j]);
          if (i >= kHalf) hp[i % kHalf][j] = h[j];
          h[j] = av[j] * h[j] + dtx * bv[j];
        }
        store_history(sm.hist, i, tid, av);
      }
    }

    // 2-4. back through the round, last step first; before step kHalf - 1,
    // forward through the first half again from h_s with the saved a_t
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      if (i == kHalf - 1) {
#pragma unroll
        for (int j = 0; j < kPer; ++j) h[j] = hs[j];
#pragma unroll
        for (int k = 0; k < kHalf; ++k) {
          if (k < steps) {
            const float dtv = to_float(s.dt[k][ch]);
            const float xv = to_float(s.x[k][ch]);
            const float dtx = dtv * xv;
            float bv[kPer], av[kPer];
            read_row(s.b, k, n0, bv);
            load_history(sm.hist, k, tid, av);
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
              hp[k][j] = h[j];
              h[j] = av[j] * h[j] + dtx * bv[j];
            }
          }
        }
      }
      if (i >= steps) continue;
      // step i: g from dy C and the carry, the step's terms of every
      // gradient, the carry a_t g for the step before
      const float dtv = to_float(s.dt[i][ch]);
      const float xv = to_float(s.x[i][ch]);
      const float dyv = to_float(s.dy[i][ch]);
      const float dtx = dtv * xv;
      float bv[kPer], cv[kPer], av[kPer], v[2 * kPer];
      read_row(s.b, i, n0, bv);
      read_row(s.c, i, n0, cv);
      load_history(sm.hist, i, tid, av);
      float gdotb = 0.f, gpa2 = 0.f;   // g . B, (g a h_{t-1}) . A log2(e)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float g = dyv * cv[j] + g_next[j];
        const float ah = av[j] * hp[i % kHalf][j];   // a_t h_{t-1}
        const float gp = g * ah;
        gdotb += g * bv[j];
        gpa2 += gp * a2[j];
        da[j] += gp * dtv;
        v[j] = g * dtx;                          // dB's term
        v[kPer + j] = dyv * (ah + dtx * bv[j]);  // dC's: dy h_t
        g_next[j] = av[j] * g;
      }
      sm.sums[i][warp][slot] = channel_sum8(v, wl);
      const float both =
          lane_sum2(gdotb * dtv, gdotb * xv + kLn2 * gpa2, wl);
      if (writes) store(out + i * Di, both + dd * dyv);
      dsum += dyv * xv;
    }

    __syncthreads();  // sums are whole; stage r is no longer read
    // the block's dB and dC of the round: one (step, state) a thread, its
    // 8 warps summed in ascending order
    const int i = tid / kMaxN, n = tid % kMaxN;
    if (i < steps && n < N) {
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        sb += sm.sums[i][w][n], sc += sm.sums[i][w][kMaxN + n];
      const int64_t at = ((b * S + t0 + i) * nblk + blockIdx.x) * N + n;
      part_db[at] = sb;
      part_dc[at] = sc;
    }
  }
  if (!live) return;
  store_state<kFull>(dh0 + (b * Di + d) * N, n0, N, g_next);
  store_state<kFull>(part_da + (b * Di + d) * N, n0, N, da);
  if (lane == 0) part_dd[b * Di + d] = dsum;
}

// The second launch: one output a thread. dB, dC (Bz, S, N) sum their
// nblk per-block partials in ascending block order; dA (Di, N) and dD
// (Di,) their Bz per-row partials in ascending batch order.
template <typename T>
__global__ void __launch_bounds__(256)
    scan_bwd_sum_kernel(const float* __restrict__ part_db,
               const float* __restrict__ part_dc,
               const float* __restrict__ part_da,
               const float* __restrict__ part_dd, T* __restrict__ db,
               T* __restrict__ dc, float* __restrict__ da,
               float* __restrict__ dd, int64_t Bz, int64_t S, int64_t Di,
               int N, int64_t nblk) {
  const int64_t bsn = Bz * S * N, dn = Di * N;
  int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < 2 * bsn) {
    const bool is_c = k >= bsn;
    const int64_t e = is_c ? k - bsn : k;
    const int64_t bt = e / N, n = e - bt * N;
    const float* p = (is_c ? part_dc : part_db) + bt * nblk * N + n;
    float acc = 0.f;
    for (int64_t j = 0; j < nblk; ++j) acc += p[j * N];
    store((is_c ? dc : db) + e, acc);
    return;
  }
  k -= 2 * bsn;
  if (k < dn) {
    float acc = 0.f;
    for (int64_t j = 0; j < Bz; ++j) acc += part_da[j * dn + k];
    da[k] = acc;
    return;
  }
  k -= dn;
  if (k < Di) {
    float acc = 0.f;
    for (int64_t j = 0; j < Bz; ++j) acc += part_dd[j * Di + k];
    dd[k] = acc;
  }
}

// Lets `kern` take Smem<T> of dynamic shared memory, the SM's whole
// carveout for it.
template <typename T, typename K>
cudaError_t prepare(K kern) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem<T>));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch(const T* x, const T* dt, const T* bm, const T* cm, const float* a,
           const float* dskip, const float* h0, const float* states,
           const T* dy, const float* dh_last, T* dx, T* ddt, T* db, T* dc,
           float* da, float* dd, float* dh0, float* part_db, float* part_dc,
           float* part_da, float* part_dd, int64_t Bz, int64_t S, int64_t Di,
           int N, cudaStream_t st) {
  const int sz = (int)sizeof(T);
  const int gxd = granule(x, dt, Di * sz, sz);
  const int gy = granule(dy, dy, Di * sz, sz);
  const int gx = gxd < gy ? gxd : gy;
  const int gb = granule(bm, cm, S * N * sz, sz);
  const int64_t nblk = (Di + kCh - 1) / kCh;
  const dim3 grid((unsigned)nblk, (unsigned)Bz);
  const bool full = N == kMaxN && at16(a) && at16(h0) && at16(states) &&
                    (dh_last == nullptr || at16(dh_last)) && at16(dh0) &&
                    at16(part_da);
  const auto kern = full ? scan_bwd_kernel<T, true> : scan_bwd_kernel<T, false>;
  cudaError_t err = prepare<T>(kern);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, sizeof(Smem<T>), st>>>(
      x, dt, bm, cm, a, dskip, h0, states, dy, dh_last, dx, ddt, dh0,
      part_db, part_dc, part_da, part_dd, S, Di, N, gx, gb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = 2 * Bz * S * N + Di * N + Di;
  scan_bwd_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part_db, part_dc, part_da, part_dd, db, dc, da, dd, Bz, S, Di, N, nblk);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(bool full, int* blocks) {
  const auto kern = full ? scan_bwd_kernel<T, true> : scan_bwd_kernel<T, false>;
  cudaError_t err = prepare<T>(kern);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, kThreads, sizeof(Smem<T>));
}

}  // namespace

// x, dt, dy, dx, ddt (Bz, S, Di); bm, cm, db, dc (Bz, S, N); a, da (Di, N);
// dskip, dd (Di,); h0, dh_last (null: zero), dh0 (Bz, Di, N); states
// (Bz, ceil(S / 16), Di, N) from the forward; scratch part_db, part_dc
// (Bz, S, ceil(Di / 64), N), part_da (Bz, Di, N), part_dd (Bz, Di): all
// contiguous, S >= 1, N <= 16; x, dt, bm, cm, dy, dx, ddt, db, dc bf16
// when `bf16` is set, else float32; the rest float32. Two launches on
// `stream` of `device`; returns cudaGetLastError() (0 on success).
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* bm, const void* cm,
    const float* a, const float* dskip, const float* h0, const float* states,
    const void* dy, const float* dh_last, void* dx, void* ddt, void* db,
    void* dc, float* da, float* dd, float* dh0, float* part_db,
    float* part_dc, float* part_da, float* part_dd, int64_t Bz, int64_t S,
    int64_t Di, int64_t N, int bf16, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N > kMaxN || S < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    return launch(static_cast<const T*>(x), static_cast<const T*>(dt),
                  static_cast<const T*>(bm), static_cast<const T*>(cm), a,
                  dskip, h0, states, static_cast<const T*>(dy), dh_last,
                  static_cast<T*>(dx), static_cast<T*>(ddt),
                  static_cast<T*>(db), static_cast<T*>(dc), da, dd, dh0,
                  part_db, part_dc, part_da, part_dd, Bz, S, Di, (int)N, st);
  }
  using T = float;
  return launch(static_cast<const T*>(x), static_cast<const T*>(dt),
                static_cast<const T*>(bm), static_cast<const T*>(cm), a,
                dskip, h0, states, static_cast<const T*>(dy), dh_last,
                static_cast<T*>(dx), static_cast<T*>(ddt), static_cast<T*>(db),
                static_cast<T*>(dc), da, dd, dh0, part_db, part_dc, part_da,
                part_dd, Bz, S, Di, (int)N, st);
}

// The reverse walk's resident blocks an SM on `device` (as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor counts them, with its
// dynamic shared memory) into *blocks: bf16 or float32 streams, the N = 16
// vector build (`full`) or the masked one. Returns the CUDA error (0 on
// success).
extern "C" int selective_scan_bwd_occupancy(int bf16, int full, int device,
                                            int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return bf16 ? occupancy<__nv_bfloat16>(full != 0, blocks)
              : occupancy<float>(full != 0, blocks);
}
