// Hopper building blocks (sm_90a): mbarriers, TMA tensor maps and loads,
// shared-memory matrix descriptors of 128-byte-swizzled tiles, register
// rebalancing between warpgroups (setmaxnreg) and the warpgroup products
// (wgmma) with their fence, commit and wait, and the tile helpers the
// attention kernels share. Header-only, for the kernels that run on Hopper's
// asynchronous path (csrc/flash_attention_bwd_sm90.cu,
// csrc/flash_attention_fwd_sm90.cu).
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
// k-step of 16 rows moves the start by 2048 bytes.
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

}  // namespace hopper
