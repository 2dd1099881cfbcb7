// Hopper (sm_90a) building blocks of the flash attention backward
// (flash_attention_bwd.cu): mbarriers, TMA tensor loads, warpgroup matrix
// products (wgmma) with their shared-memory descriptors, register
// rebalancing between warpgroups, and thread-block cluster barriers and
// distributed shared memory. Each wraps one PTX instruction (PTX ISA 8.x,
// sm_90a); nothing here allocates or launches.
//
// Shared-memory operand layouts (PTX ISA, "Matrix Descriptor Format";
// CUTLASS's canonical GMMA layouts). A tile is stored as rows of one
// swizzle span: 128 bytes (64 bf16) for head dims >= 64, else 2 * hd bytes
// (64-byte or 32-byte swizzle), a head dim wider than 64 as ceil(hd / 64)
// such tiles one after another ("atoms"; past hd the last one holds TMA's
// zero fill, at hd 112). TMA writes this layout with
// CU_TENSOR_MAP_SWIZZLE_{128,64,32}B; a 16-byte chunk c of row r lands at
// chunk c ^ ((r / (128 / span)) % (span / 16)), which is the address-bit
// swizzle wgmma reads back, as long as every tile starts on a 1,024-byte
// boundary.
//   K-major operand (the reduction dim contiguous, e.g. Q or K for
//   S = Q K^T): 8-row core groups SBO = 8 * span bytes apart; LBO unused
//   (1); one k16 step is 32 bytes further along the row, the next atom
//   64 * span bytes further.
//   MN-major operand (the M or N dim contiguous, e.g. dO as the B of
//   dV = P^T dO, transposed through the instruction's imm-trans-b): rows
//   of the tile are the reduction dim, 8 of them a core group SBO =
//   8 * span bytes apart; atoms along N LBO = 64 * span bytes apart; one
//   k16 step is 16 rows further.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

// -- mbarriers ---------------------------------------------------------------

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ inline void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// -- TMA ---------------------------------------------------------------------

// Copies the box at coordinates (c0, c1, c2, c3) of the 4-D tensor map
// `map` (a __grid_constant__ kernel parameter) to shared memory at `dst`;
// completion is counted in bytes on `bar`. Boxes reaching past the tensor
// are zero-filled.
__device__ inline void tma_load_4d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over the first `threads` threads that reach it.
__device__ inline void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- register rebalancing between warpgroups ---------------------------------

template <int R>
__device__ inline void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ inline void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// -- thread-block clusters ---------------------------------------------------

// Every thread of every block of the cluster; orders shared-memory writes
// before it with reads after it, cluster-wide.
__device__ inline void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of this block's shared `addr` in block `rank` of the cluster.
__device__ inline uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// No memory clobber, so several loads can be in flight: call it only
// between cluster_sync()s, which order it.
__device__ inline float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units, 14 bits each), base offset 0 (every tile starts
// on a 1,024-byte boundary), layout type in bits 62-63: 1 = 128-byte
// swizzle, 2 = 64-byte, 3 = 32-byte.
__device__ inline uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo, int layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// Before the first wgmma of a batch: the accumulators' earlier register
// writes are visible to it.
__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of `d` across the
// asynchronous products (which it cannot see writing them).
template <int R>
__device__ inline void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, float32, the warpgroup's fragments) = A B + (scale_d ? d : 0)
// for A (64 x 16) and B (16 x N) bf16 in shared memory, both by
// descriptor; A K-major, B K-major (TB = 0) or MN-major (TB = 1).
// Accumulator layout: warp w of the warpgroup holds rows 16 w + g and
// 16 w + g + 8 (lane = 4 g + t); d[4 i + 0, 1] are row 16 w + g, columns
// 8 i + 2 t and + 1, d[4 i + 2, 3] the same columns of row 16 w + g + 8.
template <int TB>
__device__ inline void wgmma_m64n16(float (&d)[8], uint64_t a, uint64_t b,
                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      "%8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ inline void wgmma_m64n32(float (&d)[16], uint64_t a, uint64_t b,
                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15},"
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ inline void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b,
                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ inline void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b,
                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},"
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

// The product of width N (16, 32, 64 or 128).
template <int N, int TB>
__device__ inline void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                  int scale_d) {
  if constexpr (N == 16) wgmma_m64n16<TB>(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_m64n32<TB>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_m64n64<TB>(d, a, b, scale_d);
  else wgmma_m64n128<TB>(d, a, b, scale_d);
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
}

}  // namespace
