// Shared device helpers for the SAM2-UNet Hopper kernels.
//
// Element types: __nv_bfloat16 (the working type of the model on the card)
// and float (the fp32 comparison path). Every product accumulates in fp32.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Round an fp32 value to the precision of T (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Exact-erf GELU (torch nn.GELU default).
__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Eight consecutive elements moved as one or two 16-byte transactions.
template <typename T> struct V8;
template <> struct V8<bf16> { uint4 u; };
template <> struct V8<float> { float4 a, b; };

template <typename T> __device__ __forceinline__ V8<T> v8_load(const T* p);
template <> __device__ __forceinline__ V8<bf16> v8_load<bf16>(const bf16* p) {
  V8<bf16> r;
  r.u = *reinterpret_cast<const uint4*>(p);
  return r;
}
template <> __device__ __forceinline__ V8<float> v8_load<float>(const float* p) {
  V8<float> r;
  r.a = reinterpret_cast<const float4*>(p)[0];
  r.b = reinterpret_cast<const float4*>(p)[1];
  return r;
}

template <typename T> __device__ __forceinline__ V8<T> v8_zero();
template <> __device__ __forceinline__ V8<bf16> v8_zero<bf16>() {
  V8<bf16> r;
  r.u = make_uint4(0u, 0u, 0u, 0u);
  return r;
}
template <> __device__ __forceinline__ V8<float> v8_zero<float>() {
  V8<float> r;
  r.a = make_float4(0.f, 0.f, 0.f, 0.f);
  r.b = r.a;
  return r;
}

__device__ __forceinline__ void v8_store(bf16* p, const V8<bf16>& v) {
  *reinterpret_cast<uint4*>(p) = v.u;
}
__device__ __forceinline__ void v8_store(float* p, const V8<float>& v) {
  reinterpret_cast<float4*>(p)[0] = v.a;
  reinterpret_cast<float4*>(p)[1] = v.b;
}

__device__ __forceinline__ void v8_to_floats(const V8<bf16>& v, float f[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&v.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(e[i]);
}
__device__ __forceinline__ void v8_to_floats(const V8<float>& v, float f[8]) {
  f[0] = v.a.x; f[1] = v.a.y; f[2] = v.a.z; f[3] = v.a.w;
  f[4] = v.b.x; f[5] = v.b.y; f[6] = v.b.z; f[7] = v.b.w;
}

template <typename T> __device__ __forceinline__ V8<T> v8_from_floats(const float f[8]);
template <> __device__ __forceinline__ V8<bf16> v8_from_floats<bf16>(const float f[8]) {
  V8<bf16> v;
  bf16* e = reinterpret_cast<bf16*>(&v.u);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(f[i]);
  return v;
}
template <> __device__ __forceinline__ V8<float> v8_from_floats<float>(const float f[8]) {
  V8<float> v;
  v.a = make_float4(f[0], f[1], f[2], f[3]);
  v.b = make_float4(f[4], f[5], f[6], f[7]);
  return v;
}

// Two consecutive elements as floats, and back (4- or 8-byte accesses).
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---- Ampere/Hopper warp-level primitives (bf16 tensor-core path)

// 16-byte global -> shared copy that bypasses the registers; `valid` false
// writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row (i % 8) of matrix (i / 8).
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// D += A (16x16, row) * B (16x8, col), bf16 in, fp32 accumulate. Fragment
// layouts (g = lane / 4, q = lane % 4): a {A[g][2q..], A[g+8][2q..],
// A[g][2q+8..], A[g+8][2q+8..]}; b {B[2q..][g], B[2q+8..][g]}; c/d
// {D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1]}.
__device__ __forceinline__ void mma_16816(float d[4], const unsigned a[4],
                                          const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two fp32 values as one register of two bf16 (low half first).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}
