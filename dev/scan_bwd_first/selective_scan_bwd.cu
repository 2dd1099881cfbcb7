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
// It needs h_{t-1} at every step, walked last to first; stepping h back by
// dividing by a_t is unstable. So the forward saves h at the end of each
// 16-step round (`states`, (Bz, ceil(S / 16), Di, N) float32), and this
// kernel walks the rounds last to first: it loads the state at the round's
// start (the previous round's saved state, or h0), recomputes the round's
// steps forward keeping each step's h_{t-1} in registers (16 x 4 floats a
// thread), then steps back through them. The grid is the forward's: a
// block serves 64 channels of one batch row, 4 lanes of 4 states a
// channel; each round's x, dt, dy rows and B, C runs are staged in shared
// memory by cp.async, double-buffered (round r - 1's copies fly while
// round r is walked).
//
// The sums, in a fixed order and without float atomics, so two calls are
// bit-equal: dx and ddt over a channel's 4 lanes by two xor shuffles
// (lane 0 writes dx, lane 1 ddt); dB and dC over the 8 channels of a warp
// by a scattering xor-shuffle sum (4 shuffles for 4 states), then over the
// block's 8 warps in ascending order once a round, written as per-block
// partials (Bz, S, ceil(Di / 64), N); dA and dD kept in registers across
// time and written as per-row partials (Bz, Di, N) and (Bz, Di). A second
// launch sums the partials in ascending block (dB, dC) and batch (dA, dD)
// order and rounds dB and dC to the streams' dtype. A, D, h0, the states,
// dh_last, dA, dD, dh0 and all arithmetic are float32; x, dt, B, C, dy, dx,
// ddt, dB and dC are bf16 or float32.
//
// What bounds it: at falcon-mamba-7b's shape (Bz 4, S 1024, Di 8192,
// N 16, float32) it must read x, dt and dy and write dx and ddt:
// 5 x 134,217,728 B = 671.1 MB, 200.3 us at 3.35 TB/s; its 536,870,912
// exponentials take 128.4 us on the special-function units. The bound is
// the bytes. This first version reads the states (134.2 MB more) and
// computes each exponential twice (forward recompute and backward step);
// its time is in PERF.md section 6, row 7b.

#include <math.h>

#include <cstdint>

#include "selective_scan.cuh"

namespace {

constexpr int kWarps = kThreads / 32;   // warps a block

// One round's inputs: x, dt and dy rows of the block's channels, B and C
// of the round's steps (stride N).
template <typename T>
struct __align__(16) Stage {
  T x[kSteps][kCh];
  T dt[kSteps][kCh];
  T dy[kSteps][kCh];
  T b[kSteps * kMaxN];
  T c[kSteps * kMaxN];
};

// Issue the copies of the round of `steps` steps from t0 into `s`.
template <typename T>
__device__ inline void stage_round(Stage<T>& s, const T* x, const T* dt,
                                   const T* dy, const T* bm, const T* cm,
                                   const CopyPlan& plan, int64_t b,
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
    const int i = plan.row[m], c = plan.col[m];
    if (i >= steps) continue;
    const int64_t at = i * Di * sz + c;
    copy_granule(reinterpret_cast<char*>(s.x[i]) + c, xs + at, gx);
    copy_granule(reinterpret_cast<char*>(s.dt[i]) + c, ds + at, gx);
    copy_granule(reinterpret_cast<char*>(s.dy[i]) + c, ys + at, gx);
  }
  const char* bs = reinterpret_cast<const char*>(bm) + (b * S + t0) * N * sz;
  const char* cs = reinterpret_cast<const char*>(cm) + (b * S + t0) * N * sz;
  for (int at = tid * gb; at < steps * N * sz; at += kThreads * gb) {
    copy_granule(reinterpret_cast<char*>(s.b) + at, bs + at, gb);
    copy_granule(reinterpret_cast<char*>(s.c) + at, cs + at, gb);
  }
}

// Step i of the staged round as this thread reads it; a channel past Di
// reads zeros, so it adds nothing to the sums over channels.
template <typename T, bool kFull>
__device__ inline void read_step(const Stage<T>& s, int i, int ch, int n0,
                                 int N, bool live, float& dtv, float& xv,
                                 float& dyv, float (&bv)[kPer],
                                 float (&cv)[kPer]) {
  dtv = live ? to_float(s.dt[i][ch]) : 0.f;
  xv = live ? to_float(s.x[i][ch]) : 0.f;
  dyv = live ? to_float(s.dy[i][ch]) : 0.f;
  if (kFull) {
    load4(&s.b[i * kMaxN + n0], bv);
    load4(&s.c[i * kMaxN + n0], cv);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool on = n0 + j < N;
      bv[j] = on ? to_float(s.b[i * N + n0 + j]) : 0.f;
      cv[j] = on ? to_float(s.c[i * N + n0 + j]) : 0.f;
    }
  }
}

// The sum of v over the 8 channels of a warp (lane bits 2-4) that share
// this thread's lane (bits 0-1), scattered: a thread gets the sum of
// v[2 * bit4 + bit3], by three xor shuffles (16, 8, 4) in a fixed order.
__device__ inline float channel_sum(const float (&v)[kPer], int wl) {
  const bool hi = wl & 16, mid = wl & 8;
  float k0 = hi ? v[2] : v[0], k1 = hi ? v[3] : v[1];
  k0 += __shfl_xor_sync(~0u, hi ? v[0] : v[2], 16);
  k1 += __shfl_xor_sync(~0u, hi ? v[1] : v[3], 16);
  float k = mid ? k1 : k0;
  k += __shfl_xor_sync(~0u, mid ? k0 : k1, 8);
  return k + __shfl_xor_sync(~0u, k, 4);
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
// part_dd (Bz, Di). Grid (ceil(Di / kCh), Bz).
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads)
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
  __shared__ Stage<T> stage[2];
  // per-warp sums over channels of dB and dC: [step][warp][state]
  __shared__ __align__(16) float s_db[kSteps][kWarps][kMaxN];
  __shared__ __align__(16) float s_dc[kSteps][kWarps][kMaxN];
  const int tid = threadIdx.x, wl = tid % 32, warp = tid / 32;
  const int ch = tid / kLanes, lane = tid % kLanes, n0 = lane * kPer;
  const int64_t b = blockIdx.y, nblk = gridDim.x;
  const int64_t d0 = (int64_t)blockIdx.x * kCh;
  const int nch = (int)(Di - d0 < kCh ? Di - d0 : kCh);
  const int64_t d = d0 + ch;
  const bool live = ch < nch;
  const int64_t rounds = (S + kSteps - 1) / kSteps;
  const int sn = (wl >> 3) & 3;     // which of n0 .. n0 + 3 channel_sum gives

  // the last round's copies fly while the state rows are read
  const CopyPlan plan = plan_copies(nch * (int)sizeof(T), gx, tid);
  {
    const int64_t t0 = (rounds - 1) * kSteps;
    stage_round(stage[(rounds - 1) & 1], x, dt, dy, bm, cm, plan, b, t0,
                (int)(S - t0), S, Di, d0, N, gx, gb, tid);
  }
  cp_async_commit();
  float g_next[kPer], af[kPer], a2[kPer], da[kPer];
  if (dh_last != nullptr) {
    load_state<kFull>(dh_last + (b * Di + d) * N, n0, N, live, g_next);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j) g_next[j] = 0.f;
  }
  load_state<kFull>(a + d * N, n0, N, live, af);
#pragma unroll
  for (int j = 0; j < kPer; ++j) a2[j] = af[j] * kLog2e, da[j] = 0.f;
  const float dd = live ? dskip[d] : 0.f;
  float dsum = 0.f;   // dD's share of this row: dy * x over time

  for (int64_t r = rounds - 1; r >= 0; --r) {
    const int64_t t0 = r * kSteps;
    const int steps = (int)(S - t0 < kSteps ? S - t0 : kSteps);
    if (r > 0)
      stage_round(stage[(r - 1) & 1], x, dt, dy, bm, cm, plan, b,
                  t0 - kSteps, kSteps, S, Di, d0, N, gx, gb, tid);
    cp_async_commit();   // empty on the first round
    cp_async_wait<1>();  // this thread's copies of round r have landed
    __syncthreads();     // and every thread's
    const Stage<T>& s = stage[r & 1];

    // forward through the round from its starting state, keeping h_{t-1}
    float h[kPer], hp[kSteps][kPer];
    load_state<kFull>(r == 0 ? h0 + (b * Di + d) * N
                             : states + ((b * rounds + r - 1) * Di + d) * N,
                      n0, N, live, h);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      if (i < steps) {
        float dtv, xv, dyv, bv[kPer], cv[kPer], dc[kPer];
        read_step<T, kFull>(s, i, ch, n0, N, live, dtv, xv, dyv, bv, cv);
        const float dtx = dtv * xv;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          hp[i][j] = h[j];
          h[j] = exp2f(dtv * a2[j]) * h[j] + dtx * bv[j];
          dc[j] = dyv * h[j];
        }
        const float sum = channel_sum(dc, wl);
        if (!(wl & 4)) s_dc[i][warp][n0 + sn] = sum;
      }
    }
    // back through it
#pragma unroll
    for (int i = kSteps - 1; i >= 0; --i) {
      if (i < steps) {
        float dtv, xv, dyv, bv[kPer], cv[kPer], db[kPer];
        read_step<T, kFull>(s, i, ch, n0, N, live, dtv, xv, dyv, bv, cv);
        const float dtx = dtv * xv;
        float gdotb = 0.f, gpa = 0.f;   // g . B and (g a h_{t-1}) . A
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const float av = exp2f(dtv * a2[j]);
          const float g = dyv * cv[j] + g_next[j];
          const float gp = g * (av * hp[i][j]);
          gdotb += g * bv[j];
          gpa += gp * af[j];
          da[j] += gp * dtv;
          db[j] = g * dtx;
          g_next[j] = av * g;
        }
        const float sum = channel_sum(db, wl);
        if (!(wl & 4)) s_db[i][warp][n0 + sn] = sum;
        const float both = lane_sum2(gdotb * dtv, gdotb * xv + gpa, wl);
        if (live && lane < 2) {
          const int64_t at = (b * S + t0 + i) * Di + d;
          if (lane == 0)
            store(dx + at, both + dd * dyv);
          else
            store(ddt + at, both);
        }
        dsum += dyv * xv;
      }
    }
    __syncthreads();  // s_db, s_dc are whole; stage r is no longer read
    // the block's dB and dC of the round: one (step, state) a thread, its
    // 8 warps summed in ascending order
    const int i = tid / kMaxN, n = tid % kMaxN;
    if (i < steps && n < N) {
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sb += s_db[i][w][n], sc += s_dc[i][w][n];
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

template <typename T>
int launch(const T* x, const T* dt, const T* bm, const T* cm, const float* a,
           const float* dskip, const float* h0, const float* states,
           const T* dy, const float* dh_last, T* dx, T* ddt, T* db, T* dc,
           float* da, float* dd, float* dh0, float* part_db, float* part_dc,
           float* part_da, float* part_dd, int64_t Bz, int64_t S, int64_t Di,
           int N, cudaStream_t st) {
  const int sz = (int)sizeof(T);
  const int gxd = granule(x, dt, Di * sz, sz), gy = granule(dy, dy, Di * sz, sz);
  const int gx = gxd < gy ? gxd : gy;
  const int gb = granule(bm, cm, S * N * sz, sz);
  const int64_t nblk = (Di + kCh - 1) / kCh;
  const dim3 grid((unsigned)nblk, (unsigned)Bz);
  const bool full = N == kMaxN && at16(a) && at16(h0) && at16(states) &&
                    (dh_last == nullptr || at16(dh_last)) && at16(dh0) &&
                    at16(part_da);
  if (full)
    scan_bwd_kernel<T, true><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, states, dy, dh_last, dx, ddt, dh0,
        part_db, part_dc, part_da, part_dd, S, Di, N, gx, gb);
  else
    scan_bwd_kernel<T, false><<<grid, kThreads, 0, st>>>(
        x, dt, bm, cm, a, dskip, h0, states, dy, dh_last, dx, ddt, dh0,
        part_db, part_dc, part_da, part_dd, S, Di, N, gx, gb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = 2 * Bz * S * N + Di * N + Di;
  scan_bwd_sum_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      part_db, part_dc, part_da, part_dd, db, dc, da, dd, Bz, S, Di, N, nblk);
  return (int)cudaGetLastError();
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
