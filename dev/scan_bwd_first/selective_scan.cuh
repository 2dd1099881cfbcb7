// What the selective scan's forward (selective_scan.cu) and backward
// (selective_scan_bwd.cu) share: the block layout, the cp.async copy
// granules and the state-row loads.
//
// A block serves kCh = 64 neighbouring channels of one batch row with
// kThreads = 256 threads: the state of one (batch, channel) pair is split
// across kLanes = 4 neighbouring lanes, each keeping kPer = 4 of its
// N <= 16 states in registers. Time is walked in rounds of kSteps = 16
// steps, each round's inputs staged in shared memory by cp.async.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 4;                // lanes a channel
constexpr int kPer = 4;                  // states a lane
constexpr int kMaxN = kLanes * kPer;     // widest state
constexpr int kCh = 64;                  // channels a block
constexpr int kThreads = kCh * kLanes;   // threads a block
constexpr int kSteps = 16;               // time steps a round
constexpr float kLog2e = 1.4426950408889634f;

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void store(float* p, float x) { *p = x; }
__device__ inline void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four neighbouring values at a 16-byte (float) or 8-byte (bf16) aligned
// address, as floats.
__device__ inline void load4(const float* p, float (&v)[kPer]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
__device__ inline void load4(const __nv_bfloat16* p, float (&v)[kPer]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo), v[1] = __high2float(lo);
  v[2] = __low2float(hi), v[3] = __high2float(hi);
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One granule of g bytes: 16 through L2 only, 8 and 4 through L1, 2 (bf16
// rows of odd length) as a plain load and store.
__device__ inline void copy_granule(char* dst, const char* src, int g) {
  switch (g) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       smem_u32(dst)), "l"(src));
      break;
    default:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's share of every round's copies, fixed for the sequence:
// granule m of the per-channel row tiles (m < kRowCopies, the most a
// thread takes when a granule is one element) lies `row[m]` steps into the
// round and `col[m]` bytes into the row (row kSteps: none).
constexpr int kRowCopies = kSteps * kCh / kThreads;

struct CopyPlan {
  int row[kRowCopies], col[kRowCopies];
};

__device__ inline CopyPlan plan_copies(int row_bytes, int g, int tid) {
  CopyPlan p;
  const int per_row = row_bytes / g;
#pragma unroll
  for (int m = 0; m < kRowCopies; ++m) {
    const int k = tid + m * kThreads, i = k / per_row;
    p.row[m] = i < kSteps ? i : kSteps;
    p.col[m] = (k - i * per_row) * g;
  }
  return p;
}

// A lane's kPer values of a state row (n0 .. n0 + 3 of `row`); masked
// states read as 0. kFull: N = 16 and the row 16-byte aligned.
template <bool kFull>
__device__ inline void load_state(const float* row, int n0, int N, bool live,
                                  float (&v)[kPer]) {
  if (kFull && live) {
    load4(row + n0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      v[j] = live && n0 + j < N ? row[n0 + j] : 0.f;
  }
}

// The same, written: masked states are not.
template <bool kFull>
__device__ inline void store_state(float* row, int n0, int N,
                                   const float (&v)[kPer]) {
  if (kFull) {
    *reinterpret_cast<float4*>(row + n0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (n0 + j < N) row[n0 + j] = v[j];
  }
}

// The widest granule (16, 8 or 4 bytes) that every pointer and
// `row_bytes` are multiples of; the element size when none is.
int granule(const void* p, const void* q, int64_t row_bytes, int elem) {
  const auto at = [](const void* v) { return reinterpret_cast<uintptr_t>(v); };
  for (int g = 16; g >= 4; g /= 2)
    if (at(p) % g == 0 && at(q) % g == 0 && row_bytes % g == 0) return g;
  return elem;
}

bool at16(const void* v) { return reinterpret_cast<uintptr_t>(v) % 16 == 0; }

}  // namespace
