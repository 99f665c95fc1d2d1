// The 2x2 max-pool's backward of K9's shortcut, shared by K9's entry points
// (csrc/fused_transition_bwd.cu, and csrc/block_bwd_sm90.cu's bf16 route).
#pragma once

#include "gemm.cuh"

// The 2x2 max-pool's backward of the shortcut: each pooled gradient gy
// (B, H/2, W/2, cout) goes to the first maximum (row-major) of its cell of
// the full-resolution shortcut projection sh (B, H, W, cout), channel by
// channel; the other three positions get zero. Written into columns
// [col0, col0 + cout) of rows of `ld` elements.
template <typename T>
__global__ void __launch_bounds__(256) unpool2x2_kernel(
    const T* __restrict__ sh, const T* __restrict__ gy, T* __restrict__ out,
    long long ld, int col0, int B, int H, int W, int cout) {
  const int half = cout / 2;
  const long long n = (long long)B * (H / 2) * (W / 2) * half;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const long long pr = i / half;                    // pooled row
  const int ch = (int)(i - pr * half) * 2;
  const int pw = W / 2, ph = H / 2;
  const long long b = pr / ((long long)ph * pw);
  const int rem = (int)(pr - b * ph * pw), pi = rem / pw, pj = rem - pi * pw;
  const float2 g = load2(gy + pr * cout + ch);
  long long rows[4];
  float2 cand[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rows[k] = (b * H + 2 * pi + (k >> 1)) * W + 2 * pj + (k & 1);
    cand[k] = load2(sh + rows[k] * cout + ch);
  }
  int a0 = 0, a1 = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (cand[k].x > cand[a0].x) a0 = k;
    if (cand[k].y > cand[a1].y) a1 = k;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    store2(out + rows[k] * ld + col0 + ch, k == a0 ? g.x : 0.f, k == a1 ? g.y : 0.f);
}

// The same one channel a thread, at an odd cout (the pairs above would
// straddle it) or bases a pair does not align with.
template <typename T>
__global__ void __launch_bounds__(256) unpool2x2_any_kernel(
    const T* __restrict__ sh, const T* __restrict__ gy, T* __restrict__ out,
    long long ld, int col0, int B, int H, int W, int cout) {
  const long long n = (long long)B * (H / 2) * (W / 2) * cout;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const long long pr = i / cout;                    // pooled row
  const int ch = (int)(i - pr * cout);
  const int pw = W / 2, ph = H / 2;
  const long long b = pr / ((long long)ph * pw);
  const int rem = (int)(pr - b * ph * pw), pi = rem / pw, pj = rem - pi * pw;
  const float g = to_f(gy[pr * cout + ch]);
  long long rows[4];
  float cand[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rows[k] = (b * H + 2 * pi + (k >> 1)) * W + 2 * pj + (k & 1);
    cand[k] = to_f(sh[rows[k] * cout + ch]);
  }
  int a = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (cand[k] > cand[a]) a = k;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[rows[k] * ld + col0 + ch] = from_f<T>(k == a ? g : 0.f);
}

template <typename T>
static cudaError_t launch_unpool2x2(const void* sh, const void* gy, void* out,
                                   int B, int H, int W, int cout,
                                   cudaStream_t s) {
  const T* shp = reinterpret_cast<const T*>(sh);
  const T* gyp = reinterpret_cast<const T*>(gy);
  T* o = reinterpret_cast<T*>(out);
  const long long m2 = (long long)B * (H / 2) * (W / 2);
  const unsigned pair = 2 * sizeof(T);
  if (cout % 2 == 0 && aligned_to(sh, pair) && aligned_to(gy, pair)
      && aligned_to(out, pair)) {
    const long long n = m2 * (cout / 2);
    unpool2x2_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        shp, gyp, o, 4LL * cout, 3 * cout, B, H, W, cout);
  } else {
    const long long n = m2 * cout;
    unpool2x2_any_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        shp, gyp, o, 4LL * cout, 3 * cout, B, H, W, cout);
  }
  return cudaGetLastError();
}
