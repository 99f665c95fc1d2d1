// Hopper building blocks (sm_90a): mbarriers, TMA tensor maps and loads,
// shared-memory matrix descriptors of 128-byte-swizzled tiles, register
// rebalancing between warpgroups (setmaxnreg) and the warpgroup products
// (wgmma) with their fence, commit and wait, the tile helpers the
// attention kernels share, and the 2-D tensor maps, TMA stores and named
// barriers of the MLP's GEMMs. Header-only, for the kernels that run on
// Hopper's asynchronous path (csrc/flash_attention_bwd_sm90.cu,
// csrc/flash_attention_fwd_sm90.cu, csrc/mlp_sm90.cu).
//
// Tiles. A TMA load with the 128-byte swizzle copies a box of 64 bf16
// columns (128 bytes a row) by up to 256 rows into shared memory, the
// 16-byte chunk c of row r landing at chunk c ^ (r % 8). A tile wider than 64
// columns is several such "atoms", one region each; every region starts at a
// multiple of 1024 bytes, so the swizzle's phase is the row's. Columns and
// rows past the tensor's end read as zeros.
//
// Descriptors (64 bits): start address >> 4 in bits 0-13, the leading byte
// offset >> 4 in 16-29, the stride byte offset >> 4 in 32-45, the layout in
// 62-63 (1: 128-byte swizzle). A K-major operand (a row of the tile holds
// consecutive k): stride offset 1024 (8 rows of 128 bytes), leading offset
// unused; a 16-wide k-step moves the start by 32 bytes inside an atom, and k
// past 64 starts in the next region. An MN-major B (the tile's rows are k,
// an atom's 64 columns are n; the transpose bit of the instruction): stride
// offset 1024 (8 k-rows), leading offset the region size (the next 64 n), a
// k-step of 16 rows moves the start by 2048 bytes. A K-major operand only
// 32 columns wide (64 bytes a row) takes the 64-byte swizzle instead: the
// chunk c of row r at c ^ ((r / 2) % 4), stride offset 512 (8 rows), regions
// at multiples of 512 bytes (`desc_k64`).
//
// Fragments. The fp32 accumulator of an m64nN product holds, in lane `lane`
// of warp w of the warpgroup, element i at row 16 w + lane / 4 + 8 ((i / 2)
// % 2) and column 8 (i / 4) + 2 (lane % 4) + i % 2. The A operand of a
// register-A product (m64k16) holds four bf16 pairs at those rows and
// columns 2 (lane % 4) and 8 + 2 (lane % 4) of its 16, so columns 16 kk ..
// 16 kk + 15 of an accumulator, its elements 8 kk .. 8 kk + 7 taken in
// pairs, are the A fragment of k-step kk without any exchange (`to_a_frags`).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One arrival that also expects `bytes` of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first, of parity 1, as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ------------------------------------------------------------------- TMA

// The box at element coordinates (c0 innermost .. c3) of a 4-D tensor map
// into shared memory at `dst`, its bytes completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box at element coordinates (c0 innermost, c1) of a 2-D tensor map.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The box at (c0, c1) of a 2-D tensor map written from shared memory at
// `src`; elements past the tensor's end are not written. Commit with
// `bulk_commit`; `bulk_wait_read` before `src` is written again.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed stores still read shared
// memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's committed stores are incomplete.
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's shared-memory writes before later reads of the
// async proxy (a TMA store).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ----------------------------------------------------------- descriptors

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead_bytes >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// A K-major operand whose rows start at `addr`.
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return desc_sw128(addr, 16); }

// An MN-major B operand whose next 64 columns of n lie `region` bytes on.
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t region) {
  return desc_sw128(addr, region);
}

// A K-major operand of 64-byte rows (32 bf16 columns), 64-byte swizzled.
__device__ __forceinline__ uint64_t desc_k64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16)
         | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// ------------------------------------------------ warpgroup scheduling

// The registers a thread of this warpgroup may hold from here on (a
// multiple of 8 in 24 .. 256; every warp of the warpgroup executes it).
template <int N> __device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// This thread's warpgroup, broadcast from lane 0, so that the compiler
// sees a warp-uniform branch around setmaxnreg.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending (the
// groups complete in the order they were committed).
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product reads or writes across its window (issue .. wait).
template <int N> __device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The bf16 A fragments of the K16 16-wide k-steps of a 64 x (16 K16) fp32
// accumulator (the layout above), each value rounded to nearest even.
template <int K16>
__device__ __forceinline__ void to_a_frags(const float* s, uint32_t (*a)[4]) {
#pragma unroll
  for (int kk = 0; kk < K16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// ----------------------------------------------------------------- wgmma

// d (64 x 64, fp32) (+)= a (64 x 16) b (16 x 64), both bf16 in shared memory
// through descriptors, both K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += a (64 x 16, bf16 pairs in registers) b (16 x 64, bf16
// in shared memory through a descriptor, MN-major: the transpose
// bit); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 96, fp32) += a (64 x 16, bf16 pairs in registers) b (16 x 96, bf16
// in shared memory through a descriptor, MN-major: the transpose
// bit); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_m64n96k16(float* d, const uint32_t* a,
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 128, fp32) += a (64 x 16, bf16 pairs in registers) b (16 x 128, bf16
// in shared memory through a descriptor, MN-major: the transpose
// bit); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a,
                                                    uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x N, fp32) (+)= a (64 x 16) b (16 x N): a bf16 in shared memory
// through a descriptor, K-major; b likewise, K-major (TB 0) or MN-major (TB
// 1, the transpose bit); `accumulate` 0 overwrites d. N 32, 96, 128, 144 or
// 192 (the widths csrc/mlp_sm90.cu's products take).
template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n96k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47}"
      ", %48, %49, p, 1, 1, 0, %51;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n144k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71}"
      ", %72, %73, p, 1, 1, 0, %75;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_m64n192k16(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95}"
      ", %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TB));
}

// d (64 x 64, fp32) (+)= a (64 x 16, bf16 pairs in registers) b (16 x 64,
// bf16 in shared memory through a descriptor, K-major with TB 0 or MN-major
// with TB 1); `accumulate` 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64k16_t(float* d, const uint32_t* a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 96 || N == 128 || N == 144 || N == 192, "wgmma width");
  if constexpr (N == 32) wgmma_ss_m64n32k16<TB>(d, a, b, accumulate);
  else if constexpr (N == 96) wgmma_ss_m64n96k16<TB>(d, a, b, accumulate);
  else if constexpr (N == 128) wgmma_ss_m64n128k16<TB>(d, a, b, accumulate);
  else if constexpr (N == 144) wgmma_ss_m64n144k16<TB>(d, a, b, accumulate);
  else wgmma_ss_m64n192k16<TB>(d, a, b, accumulate);
}

// ------------------------------------------- tiles of the attention kernels

// d (64 x N) += a b over one k-step, a in registers, b MN-major in shared
// memory whose 64-column regions lie `region` bytes apart.
template <int N>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint32_t b,
                                       uint32_t region) {
  if constexpr (N == 128) wgmma_rs_m64n128k16(d, a, desc_mn(b, region), 1);
  else if constexpr (N == 96) wgmma_rs_m64n96k16(d, a, desc_mn(b, region), 1);
  else wgmma_rs_m64n64k16(d, a, desc_mn(b, region), 1);
}

// S (64 x 64) = A B^T over head dim D: A's 64 rows at `a` (atoms `a_region`
// apart), B's 64 at `b` (atoms `b_region` apart), both K-major; the first
// k-step overwrites what s held.
template <int D>
__device__ __forceinline__ void scores(float* s, uint32_t a, uint32_t a_region, uint32_t b,
                                       uint32_t b_region) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk / 4, at = (kk % 4) * 32;
    wgmma_ss_m64n64k16(s, desc_k(a + atom * a_region + at),
                       desc_k(b + atom * b_region + at), kk > 0);
  }
}

template <int N> __device__ __forceinline__ void zero(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// The shared-memory base rounded up to 1024 bytes, the swizzle's period (a
// kernel's dynamic shared memory holds the slack).
__device__ __forceinline__ uint32_t smem_base(const void* raw) {
  return (smem_addr(raw) + 1023u) & ~1023u;
}

// Rows r and r + 8 (hh 0, 1) of this thread's accumulator fragments.
__device__ __forceinline__ int frag_row(int warp, int lane, int hh) {
  return warp * 16 + lane / 4 + 8 * hh;
}

// Columns c0 + 8 j .. + 7 of rows r (hh 0, 1) of a 64 x NO accumulator,
// times `mul`, into a bf16 view at `out` (row stride ss), only the columns
// below d (d % 8 == 0, so an 8-column group is all in or all out).
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, long long ss, const float* acc, int hh,
                                           int row, int c0, int d, int t4, float mul) {
  bf16* p = out + row * ss + c0 + 2 * t4;
#pragma unroll
  for (int j = 0; j < NO / 8; ++j) {
    if (c0 + 8 * j >= d) break;
    const int i = 4 * j + 2 * hh;
    *reinterpret_cast<uint32_t*>(p + 8 * j) = pack_bf16(acc[i] * mul, acc[i + 1] * mul);
  }
}

// The instance a head dim runs on: d padded to 64, 96, 128 or 256.
inline int padded_head_dim(int d) {
  return d <= 64 ? 64 : d <= 96 ? 96 : d <= 128 ? 128 : 256;
}

// The strides (batch, token, head) a tensor map takes for a (B, S, heads,
// d) view: the stride of an extent-1 dim is never used, so it gets a valid
// one (positive, a multiple of 8 elements).
inline void map_strides(long long* st, int B, int nh, int d, int S) {
  if (nh == 1) st[2] = d;
  if (S == 1) st[1] = st[2] * nh;
  if (B == 1) st[0] = st[1] * S;
}

// ------------------------------------------------------------ host side

// The card's SMs, once per device: a persistent grid's size.
inline int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!count[dev] && cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev)
                         != cudaSuccess)
    return 132;
  return count[dev];
}

// Raises a kernel's dynamic shared memory limit to `bytes` once per device:
// `raised` is the caller's own flag for each device, kept beside the kernel
// instance. The attribute stays with the kernel, so later launches skip the
// cudaFuncSetAttribute call.
inline cudaError_t smem_limit_once(const void* kernel, int bytes, bool (&raised)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < 64;
  if (kept && raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) raised[dev] = true;
  return e;
}

// cuTensorMapEncodeTiled, looked up at run time (cudaGetDriverEntryPoint)
// so that the library links no libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map over a bf16 (B, S, heads, d) view with element strides (sb, ss,
// sh) and unit stride over d, dims innermost first (d, heads, S, B). The box
// is 64 columns of one head by `rows` tokens of one batch entry, 128-byte
// swizzled; columns past d and tokens past S read as zeros. The base must be
// 16-byte aligned and every stride a multiple of 8 elements.
inline bool tensor_map_bshd(CUtensorMap* map, const void* base, int B, int S, int nh,
                            int d, long long sb, long long ss, long long sh,
                            int rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)nh, (cuuint64_t)S, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t estrides[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 2-D map over a bf16 matrix of `outer` rows of `inner` elements, rows
// `row_elems` apart (a multiple of 8); the box is box_inner x box_outer, with
// the 128-byte swizzle (box_inner 64) or the 64-byte one (box_inner 32).
// Elements past either end read as zeros and are not written by a store.
// The base must be 16-byte aligned.
inline bool tensor_map_2d(CUtensorMap* map, const void* base, long long inner,
                          long long outer, long long row_elems, int box_inner,
                          int box_outer) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return false;
  cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  cuuint64_t strides[1] = {(cuuint64_t)row_elems * 2};
  cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  cuuint32_t estrides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_inner == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
