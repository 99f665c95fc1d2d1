// The two passes every fused block is built from:
//
//   ln_rows:  y = LN(x) over the last axis (fp32 statistics, two-pass like
//             the reference, eps 1e-6), rounded to T exactly where the
//             reference rounds the normed activations;
//   gemm:     C = epi(A[M,K] @ W[N,K]^T), epi = + bias, [exact GELU],
//             [round_T, + R (R direct, or the 2x2 max of a full-resolution
//             tensor)], round_T.
//
// W is a torch Linear weight (out, in) row-major, which is exactly the
// column-major B operand the tensor cores want, so no transpose is made.
//
// bf16 GEMM: 128x128 output tile per block of 8 warps (2 x 4, 64x32 each),
// K in steps of 32 through a 3-stage cp.async ring in shared memory (rows
// padded to 40 elements so ldmatrix reads are bank-conflict free), operands
// fetched with ldmatrix, products on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate). The epilogue runs on the accumulator registers: bias, GELU
// and residual per element pair, paired bf16 stores. K and M edges are
// zero-filled by the copies; N % 8 == 0 and K % 8 == 0 are the wrapper's
// checks.
//
// fp32 GEMM (the comparison path): the same tiling on CUDA-core FMAs, each
// thread an 8x8 sub-tile.
//
// The LayerNorm runs as its own pass rather than inside the GEMM: a
// 128-row block cannot hold its rows' full K in shared memory at c = 1152,
// and recomputing row statistics in every column tile cost more than one
// extra read and write of the normed activations (about 1% of a hiera_l
// forward's bytes).
#pragma once

#include "common.cuh"

struct GemmParams {
  const void* A; long long lda;         // M x K activations
  const void* W;                        // N x K weight (torch Linear layout)
  const void* bias;                     // N, or null
  const void* R; long long ldr;         // residual, or null
  int res_pool;                         // 1: R is (B, 2*ph, 2*pw, ldr), 2x2 max
  int ph, pw;                           // pooled grid of C's rows (res_pool)
  void* C; long long ldc;
  long long M; int N; int K;
  int act;                              // 1: exact GELU after the bias
};

// ------------------------------------------------------------------ LN

constexpr int LN_MAXV = 8;   // K <= 32 lanes * 8 vectors * 8 = 2048

template <typename T>
__global__ void __launch_bounds__(256) ln_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ y, long long M, int K) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nv = K / 8;
  const T* xr = x + row * K;
  float f[LN_MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      v8_to_floats(v8_load(xr + v * 8), f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[i][e];
    }
  }
  const float mu = warp_sum(s) / K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[i][e] - mu;
        var += d * d;
      }
    }
  }
  const float rs = rsqrtf(warp_sum(var) / K + 1e-6f);
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      float g[8], bb[8], o[8];
      v8_to_floats(v8_load(w + v * 8), g);
      v8_to_floats(v8_load(b + v * 8), bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = (f[i][e] - mu) * rs * g[e] + bb[e];
      v8_store(y + row * K + v * 8, v8_from_floats<T>(o));
    }
  }
}

template <typename T>
static cudaError_t launch_ln(const void* x, const void* w, const void* b,
                             void* y, long long M, int K, cudaStream_t stream) {
  if (K % 8 || K > 32 * LN_MAXV * 8) return cudaErrorInvalidValue;
  const long long blocks = (M + 7) / 8;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  ln_rows_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(w),
      reinterpret_cast<const T*>(b), reinterpret_cast<T*>(y), M, K);
  return cudaGetLastError();
}

static cudaError_t launch_ln_dt(int is_bf16, const void* x, const void* w,
                                const void* b, void* y, long long M, int K,
                                cudaStream_t stream) {
  return is_bf16 ? launch_ln<bf16>(x, w, b, y, M, K, stream)
                 : launch_ln<float>(x, w, b, y, M, K, stream);
}

// ------------------------------------------------------------ epilogue

// Columns n and n + 1 of row m (n even; N even, so both are in range).
template <typename T>
__device__ __forceinline__ float2 gemm_epi2(const GemmParams& p, long long m,
                                            int n, float v0, float v1) {
  if (p.bias) {
    const float2 bb = load2(reinterpret_cast<const T*>(p.bias) + n);
    v0 += bb.x;
    v1 += bb.y;
  }
  if (p.act) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (p.R) {
    const T* R = reinterpret_cast<const T*>(p.R);
    float2 r;
    if (!p.res_pool) {
      r = load2(R + m * p.ldr + n);
    } else {
      const long long per = (long long)p.ph * p.pw;
      const long long b = m / per;
      const int rem = (int)(m - b * per);
      const int i = rem / p.pw, j = rem - i * p.pw;
      const long long wfull = 2LL * p.pw;
      const long long r00 = (b * 2 * p.ph + 2 * i) * wfull + 2 * j;
      const float2 a = load2(R + r00 * p.ldr + n);
      const float2 c = load2(R + (r00 + 1) * p.ldr + n);
      const float2 d = load2(R + (r00 + wfull) * p.ldr + n);
      const float2 e = load2(R + (r00 + wfull + 1) * p.ldr + n);
      r = make_float2(fmaxf(fmaxf(a.x, c.x), fmaxf(d.x, e.x)),
                      fmaxf(fmaxf(a.y, c.y), fmaxf(d.y, e.y)));
    }
    v0 = round_to<T>(v0) + r.x;
    v1 = round_to<T>(v1) + r.y;
  }
  return make_float2(v0, v1);
}

// ------------------------------------------------------------ bf16 GEMM

constexpr int G_BM = 128, G_BN = 128, G_BK = 32, G_LD = G_BK + 8;
constexpr int G_STAGES = 3, G_THREADS = 256;
constexpr int G_CHUNKS = G_BM * G_BK / 8 / G_THREADS;   // per thread and operand
constexpr size_t G_SMEM_BF16 = sizeof(bf16) * G_STAGES * (G_BM + G_BN) * G_LD;

__global__ void __launch_bounds__(G_THREADS, 2) gemm_bf16_kernel(GemmParams p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* As = reinterpret_cast<bf16*>(g_smem);      // [STAGES][BM][LD]
  bf16* Bs = As + G_STAGES * G_BM * G_LD;          // [STAGES][BN][LD]
  const bf16* A = reinterpret_cast<const bf16*>(p.A);
  const bf16* W = reinterpret_cast<const bf16*>(p.W);
  const long long m0 = (long long)blockIdx.y * G_BM;
  const int n0 = blockIdx.x * G_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int KT = (p.K + G_BK - 1) / G_BK;

  // each thread copies G_CHUNKS 16-byte chunks of A and as many of W
  auto load_stage = [&](int buf, int kt) {
#pragma unroll
    for (int i = 0; i < G_CHUNKS; ++i) {
      const int v = tid + i * G_THREADS;
      const int r = v / (G_BK / 8), kk = v % (G_BK / 8) * 8, k = kt * G_BK + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      const bool va = k < p.K && m < p.M, vb = k < p.K && n < p.N;
      cp_async16(As + (buf * G_BM + r) * G_LD + kk, va ? A + m * p.lda + k : A, va);
      cp_async16(Bs + (buf * G_BN + r) * G_LD + kk,
                 vb ? W + (long long)n * p.K + k : W, vb);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();   // stage kt landed for all; stage kt-1 fully consumed
    const int nk = kt + G_STAGES - 1;
    if (nk < KT) load_stage(nk % G_STAGES, nk);
    cp_async_commit();
    const int buf = kt % G_STAGES;
    const bf16* as = As + (buf * G_BM + wm * 64) * G_LD;
    const bf16* bs = Bs + (buf * G_BN + wn * 32) * G_LD;
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks) {
      unsigned bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        const int nrow = j * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(r, bs + nrow * G_LD + ks * 16 + ((lane >> 3) & 1) * 8);
        bfr[2 * j][0] = r[0];
        bfr[2 * j][1] = r[1];
        bfr[2 * j + 1][0] = r[2];
        bfr[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned afr[4];
        ldmatrix_x4(afr, as + (i * 16 + (lane & 15)) * G_LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_16816(acc[i][j], afr, bfr[j]);
      }
    }
  }

  bf16* C = reinterpret_cast<bf16*>(p.C);
  const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + q2;
        if (n < p.N) {
          const float2 v = gemm_epi2<bf16>(p, m, n, acc[i][j][2 * h],
                                           acc[i][j][2 * h + 1]);
          store2(C + m * p.ldc + n, v.x, v.y);
        }
      }
    }
  }
}

// ------------------------------------------------------------ fp32 GEMM

constexpr size_t G_SMEM_F32 = sizeof(float) * (G_BM + G_BN) * G_LD;

__global__ void __launch_bounds__(G_THREADS) gemm_f32_kernel(GemmParams p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  float* As = reinterpret_cast<float*>(g_smem);    // [BM][LD]
  float* Bs = As + G_BM * G_LD;                    // [BN][LD]
  const float* A = reinterpret_cast<const float*>(p.A);
  const float* W = reinterpret_cast<const float*>(p.W);
  const long long m0 = (long long)blockIdx.y * G_BM;
  const int n0 = blockIdx.x * G_BN;
  // rows ty + 16i; column pairs 32jp + 2tx + {0, 1}, acc[i][2jp + {0, 1}]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += G_BK) {
#pragma unroll
    for (int i = 0; i < G_CHUNKS; ++i) {
      const int v = tid + i * G_THREADS;
      const int r = v / (G_BK / 8), kk = v % (G_BK / 8) * 8, k = k0 + kk;
      const long long m = m0 + r;
      const int n = n0 + r;
      v8_store(As + r * G_LD + kk,
               (m < p.M && k < p.K) ? v8_load(A + m * p.lda + k) : v8_zero<float>());
      v8_store(Bs + r * G_LD + kk,
               (n < p.N && k < p.K) ? v8_load(W + (long long)n * p.K + k) : v8_zero<float>());
    }
    __syncthreads();
    for (int k = 0; k < G_BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * G_LD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(32 * (j >> 1) + 2 * tx + (j & 1)) * G_LD + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* C = reinterpret_cast<float*>(p.C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int n = n0 + 32 * jp + 2 * tx;
      if (n < p.N) {
        const float2 v = gemm_epi2<float>(p, m, n, acc[i][2 * jp], acc[i][2 * jp + 1]);
        store2(C + m * p.ldc + n, v.x, v.y);
      }
    }
  }
}

// ------------------------------------------------------------- launches

static cudaError_t launch_gemm_dt(int is_bf16, const GemmParams& p,
                                  cudaStream_t stream) {
  if (p.N % 8 || p.K % 8) return cudaErrorInvalidValue;
  const long long mt = (p.M + G_BM - 1) / G_BM;
  if (mt > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((p.N + G_BN - 1) / G_BN, (unsigned)mt);
  if (is_bf16) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G_SMEM_BF16);
    if (e != cudaSuccess) return e;
    gemm_bf16_kernel<<<grid, G_THREADS, G_SMEM_BF16, stream>>>(p);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)G_SMEM_F32);
    if (e != cudaSuccess) return e;
    gemm_f32_kernel<<<grid, G_THREADS, G_SMEM_F32, stream>>>(p);
  }
  return cudaGetLastError();
}
