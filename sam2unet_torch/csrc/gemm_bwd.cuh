// The backward's passes, on top of gemm.cuh's forward ones:
//
//   gemm_bwd: C = epi(A[M,K] @ W[N,K]^T), or with `nn` C = epi(A[M,K] @
//             W[K,N]) (the torch weight as a row-major B operand: the
//             backward's dY @ W, fragments by ldmatrix.trans). epi = + bias,
//             [fp32 copy of the pre-activation], [exact GELU], [x gelu'(H)
//             of a recomputed pre-activation, or H x gelu'(.)], [round_T,
//             + R], round_T; C may be null (only the fp32 copy is wanted);
//   ln_bwd:   dx = r (dxh - mean(dxh) - xh mean(dxh xh)) [+ gy], dxh = dy w,
//             the statistics recomputed from x;
//   wgrad:    dW[N1][N2] = sum_m A[m][n1] B[m][n2] and db = sum_m A[m][n1] in
//             fp32, over fixed 256-row chunks into per-chunk partials, then
//             one pass that sums the partials in chunk order (no atomics, so
//             the gradients are the same from run to run).
//
// The backward GEMM is gemm.cuh's tiling (128x128 tiles, 8 warps, 3-stage
// cp.async ring, mma.sync bf16; CUDA-core fp32) with the options above. It
// is a kernel of its own, built only into the backward's libraries: grown
// into the forward GEMM, these options made the forward slower on the H100
// (PERF.md, PR 3), so the forward's kernels stay as they were. As in
// gemm.cuh, the launchers send every width, stride or base these instances
// do not take (`gemm_vec16`, `ln_vec16`) to gemm_any.cu.
#pragma once

#include "gemm.cuh"

// GemmBwd and GemmBwdArgs: gemm_any.cuh.

// Columns n and n + 1 of row m (n even; N even, so both are in range).
template <typename T>
__device__ __forceinline__ void gemm_bwd_store2(const GemmBwdArgs& p, long long m,
                                                int n, float v0, float v1) {
  if (p.bias) {
    const float2 bb = load2(reinterpret_cast<const T*>(p.bias) + n);
    v0 += bb.x;
    v1 += bb.y;
  }
  const GemmBwd& q = p.b;
  if (q.pre) store2(q.pre + m * q.ldpre + n, v0, v1);
  if (p.act) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  }
  if (q.dgelu) {
    const float2 h = q.h_f32 ? load2(reinterpret_cast<const float*>(q.H) + m * q.ldh + n)
                             : load2(reinterpret_cast<const T*>(q.H) + m * q.ldh + n);
    if (q.dgelu == 1) {
      v0 *= dgelu_erf(h.x);
      v1 *= dgelu_erf(h.y);
    } else {
      v0 = h.x * dgelu_erf(v0);
      v1 = h.y * dgelu_erf(v1);
    }
  }
  if (p.R) {
    const float2 r = load2(reinterpret_cast<const T*>(p.R) + m * p.ldr + n);
    v0 = round_to<T>(v0) + r.x;
    v1 = round_to<T>(v1) + r.y;
  }
  if (p.C) store2(reinterpret_cast<T*>(p.C) + m * p.ldc + n, v0, v1);
}

// ------------------------------------------------------- bf16 GEMM (bwd)

constexpr int G_LDN = G_BN + 8;       // row-major B tile rows (nn)
static_assert(G_BK * G_LDN <= G_BN * G_LD, "nn B tile fits the B ring");

template <bool NN>
__global__ void __launch_bounds__(G_THREADS, 2) gemm_bf16_bwd_kernel(GemmBwdArgs p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* As = reinterpret_cast<bf16*>(g_smem);      // [STAGES][BM][LD]
  bf16* Bs = As + G_STAGES * G_BM * G_LD;          // [STAGES][BN][LD] or [BK][LDN]
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
      const bool va = k < p.K && m < p.M;
      cp_async16(As + (buf * G_BM + r) * G_LD + kk, va ? A + m * p.lda + k : A, va);
      if constexpr (!NN) {
        const int n = n0 + r;
        const bool vb = k < p.K && n < p.N;
        cp_async16(Bs + (buf * G_BN + r) * G_LD + kk,
                   vb ? W + (long long)n * p.K + k : W, vb);
      } else {
        const int br = v / (G_BN / 8), bc = v % (G_BN / 8) * 8;
        const int bk = kt * G_BK + br, n = n0 + bc;
        const bool vb = bk < p.K && n < p.N;
        cp_async16(Bs + (buf * G_BK + br) * G_LDN + bc,
                   vb ? W + (long long)bk * p.N + n : W, vb);
      }
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
#pragma unroll
    for (int ks = 0; ks < G_BK / 16; ++ks) {
      unsigned bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        if constexpr (!NN) {
          const bf16* bs = Bs + (buf * G_BN + wn * 32) * G_LD;
          const int nrow = j * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(r, bs + nrow * G_LD + ks * 16 + ((lane >> 3) & 1) * 8);
        } else {
          const bf16* bs = Bs + buf * G_BK * G_LDN;
          ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * G_LDN
                                   + wn * 32 + j * 16 + (lane >> 4) * 8);
        }
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
        if (n < p.N)
          gemm_bwd_store2<bf16>(p, m, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------- fp32 GEMM (bwd)

template <bool NN>
__global__ void __launch_bounds__(G_THREADS) gemm_f32_bwd_kernel(GemmBwdArgs p) {
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
      v8_store(As + r * G_LD + kk,
               (m < p.M && k < p.K) ? v8_load(A + m * p.lda + k) : v8_zero<float>());
      if constexpr (!NN) {
        const int n = n0 + r;
        v8_store(Bs + r * G_LD + kk,
                 (n < p.N && k < p.K) ? v8_load(W + (long long)n * p.K + k)
                                      : v8_zero<float>());
      } else {
        // the K x N tile, stored transposed as Bs[n][k]
        const int br = v / (G_BN / 8), bc = v % (G_BN / 8) * 8;
        const int bk = k0 + br, n = n0 + bc;
        float f[8];
        v8_to_floats((bk < p.K && n < p.N) ? v8_load(W + (long long)bk * p.N + n)
                                           : v8_zero<float>(), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) Bs[(bc + e) * G_LD + br] = f[e];
      }
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
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= p.M) continue;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int n = n0 + 32 * jp + 2 * tx;
      if (n < p.N) gemm_bwd_store2<float>(p, m, n, acc[i][2 * jp], acc[i][2 * jp + 1]);
    }
  }
}

// ------------------------------------------------------ launches (bwd)

template <typename K>
static cudaError_t launch_gemm_bwd_k(K kernel, size_t smem, dim3 grid,
                                     const GemmBwdArgs& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, G_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

static cudaError_t launch_gemm_bwd_dt(int is_bf16, const GemmParams& p,
                                      const GemmBwd& b, cudaStream_t stream) {
  if (p.res_pool || p.split) return cudaErrorInvalidValue;
  if (!gemm_vec16(p, is_bf16 ? sizeof(bf16) : sizeof(float), &b))
    return (cudaError_t)gany_gemm(is_bf16, &p, &b, stream);
  const long long mt = (p.M + G_BM - 1) / G_BM;
  if (mt > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((p.N + G_BN - 1) / G_BN, (unsigned)mt);
  GemmBwdArgs a;
  static_cast<GemmParams&>(a) = p;
  a.b = b;
  if (is_bf16)
    return b.nn ? launch_gemm_bwd_k(gemm_bf16_bwd_kernel<true>, G_SMEM_BF16, grid, a, stream)
                : launch_gemm_bwd_k(gemm_bf16_bwd_kernel<false>, G_SMEM_BF16, grid, a, stream);
  return b.nn ? launch_gemm_bwd_k(gemm_f32_bwd_kernel<true>, G_SMEM_F32, grid, a, stream)
              : launch_gemm_bwd_k(gemm_f32_bwd_kernel<false>, G_SMEM_F32, grid, a, stream);
}

// ------------------------------------------------------------ LN backward

// dx = r (dxh - mean(dxh) - xh mean(dxh xh)) [+ gy], dxh = dy * w, with the
// row statistics recomputed from x as ln_rows computes them; LANES lanes a
// row as there (gemm.cuh: a warp, or four at K up to LN_NARROW_MAX_K),
// everything in fp32, dx rounded once.
template <typename T, int LANES, int MAXV>
__global__ void __launch_bounds__(256) ln_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
    const T* __restrict__ gy, T* __restrict__ dx, long long M, int K) {
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / LANES;
  const int lane = threadIdx.x % LANES;
  const bool live = row < M;   // every lane takes part in the shuffles
  const int nv = K / 8;
  const T* xr = x + row * K;
  const T* dr = dy + row * K;
  float f[MAXV][8], dh[MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = lane + LANES * i;
    if (live && v < nv) {
      v8_to_floats(v8_load(xr + v * 8), f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[i][e];
    }
  }
  const float mu = lane_group_sum<LANES>(s) / K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    if (live && lane + LANES * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[i][e] - mu;
        var += d * d;
      }
    }
  }
  const float rs = rsqrtf(lane_group_sum<LANES>(var) / K + 1e-6f);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = lane + LANES * i;
    if (live && v < nv) {
      float g[8];
      v8_to_floats(v8_load(dr + v * 8), dh[i]);
      v8_to_floats(v8_load(w + v * 8), g);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        f[i][e] = (f[i][e] - mu) * rs;   // xh
        dh[i][e] *= g[e];                // dxh
        s1 += dh[i][e];
        s2 += dh[i][e] * f[i][e];
      }
    }
  }
  const float m1 = lane_group_sum<LANES>(s1) / K, m2 = lane_group_sum<LANES>(s2) / K;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int v = lane + LANES * i;
    if (live && v < nv) {
      float o[8], r[8];
      if (gy) v8_to_floats(v8_load(gy + row * K + v * 8), r);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = rs * (dh[i][e] - m1 - f[i][e] * m2);
        if (gy) o[e] += r[e];
      }
      v8_store(dx + row * K + v * 8, v8_from_floats<T>(o));
    }
  }
}

template <typename T>
static cudaError_t launch_ln_bwd(const void* x, const void* w, const void* dy,
                                 const void* gy, void* dx, long long M, int K,
                                 cudaStream_t stream) {
  const long long blocks = ln_blocks(M, K);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T *xt = reinterpret_cast<const T*>(x), *wt = reinterpret_cast<const T*>(w),
          *dyt = reinterpret_cast<const T*>(dy), *gyt = reinterpret_cast<const T*>(gy);
  T* dxt = reinterpret_cast<T*>(dx);
  if (K <= LN_NARROW_MAX_K)
    ln_bwd_rows_kernel<T, LN_NARROW_LANES, LN_NARROW_MAXV><<<(unsigned)blocks, 256, 0, stream>>>(
        xt, wt, dyt, gyt, dxt, M, K);
  else
    ln_bwd_rows_kernel<T, 32, LN_MAXV><<<(unsigned)blocks, 256, 0, stream>>>(
        xt, wt, dyt, gyt, dxt, M, K);
  return cudaGetLastError();
}

static cudaError_t launch_ln_bwd_dt(int is_bf16, const void* x, const void* w,
                                    const void* dy, const void* gy, void* dx,
                                    long long M, int K, cudaStream_t stream) {
  if (!ln_vec16(K, {x, w, dy, gy, dx}))
    return (cudaError_t)gany_ln_bwd(is_bf16, x, w, dy, gy, dx, M, K, stream);
  return is_bf16 ? launch_ln_bwd<bf16>(x, w, dy, gy, dx, M, K, stream)
                 : launch_ln_bwd<float>(x, w, dy, gy, dx, M, K, stream);
}

// ----------------------------------------------------- weight gradients

constexpr int WG_ROWS = 256;   // rows of M per partial (the chunk)
constexpr int WG_T = 32;       // output tile WG_T x WG_T per block

// partial[chunk][n1][n2] = sum over the chunk's rows of A[m][n1] B[m][n2];
// the blocks of n2-tile 0 also write colsum[chunk][n1] = sum A[m][n1].
// CUDA-core fp32 products (the operands are T); each thread owns 2 x 2.
template <typename T>
__global__ void __launch_bounds__(256) wgrad_partial_kernel(
    const T* __restrict__ A, const T* __restrict__ B, float* __restrict__ part,
    float* __restrict__ colsum, long long M, int N1, int N2) {
  __shared__ float As[WG_T][WG_T + 1], Bs[WG_T][WG_T + 1];
  const int chunk = blockIdx.z;
  const int t1 = blockIdx.x * WG_T, t2 = blockIdx.y * WG_T;
  const int tid = threadIdx.x, i1 = (tid >> 4) * 2, i2 = (tid & 15) * 2;
  const long long r0 = (long long)chunk * WG_ROWS;
  const long long r1 = min(r0 + WG_ROWS, M);
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, cs[2] = {0.f, 0.f};
  for (long long m0 = r0; m0 < r1; m0 += WG_T) {
    // 32 rows x 32 columns of each operand, one element per thread and pass
    for (int idx = tid; idx < WG_T * WG_T; idx += 256) {
      const int r = idx / WG_T, cc = idx % WG_T;
      const long long m = m0 + r;
      As[r][cc] = (m < r1 && t1 + cc < N1) ? to_f(A[m * N1 + t1 + cc]) : 0.f;
      Bs[r][cc] = (m < r1 && t2 + cc < N2) ? to_f(B[m * N2 + t2 + cc]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < WG_T; ++r) {
      const float a0 = As[r][i1], a1 = As[r][i1 + 1];
      const float b0 = Bs[r][i2], b1 = Bs[r][i2 + 1];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
      cs[0] += a0;
      cs[1] += a1;
    }
    __syncthreads();
  }
  float* pc = part + (long long)chunk * N1 * N2;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int n1 = t1 + i1 + a;
    if (n1 >= N1) continue;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int n2 = t2 + i2 + b;
      if (n2 < N2) pc[(long long)n1 * N2 + n2] = acc[a][b];
    }
    if (blockIdx.y == 0 && i2 == 0) colsum[(long long)chunk * N1 + n1] = cs[a];
  }
}

// out[i] = sum over chunks of part[chunk][i], in chunk order
__global__ void __launch_bounds__(256) wgrad_reduce_kernel(
    const float* __restrict__ part, float* __restrict__ out, long long n,
    int chunks) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += part[(long long)c * n + i];
  out[i] = s;
}

// dW (N1 x N2) = A^T B and db (N1) = colsum A over M rows; `ws` holds
// wgrad_workspace(M, N1, N2) floats.
static long long wgrad_chunks(long long M) { return (M + WG_ROWS - 1) / WG_ROWS; }

static cudaError_t launch_wgrad_dt(int is_bf16, const void* A, const void* B,
                                   float* dW, float* db, float* ws, long long M,
                                   int N1, int N2, cudaStream_t stream) {
  const long long chunks = wgrad_chunks(M);
  if (chunks > 65535 || chunks < 1) return cudaErrorInvalidConfiguration;
  float* part = ws;
  float* colsum = ws + chunks * N1 * N2;
  const dim3 grid((N1 + WG_T - 1) / WG_T, (N2 + WG_T - 1) / WG_T, (unsigned)chunks);
  if (is_bf16)
    wgrad_partial_kernel<bf16><<<grid, 256, 0, stream>>>(
        reinterpret_cast<const bf16*>(A), reinterpret_cast<const bf16*>(B),
        part, colsum, M, N1, N2);
  else
    wgrad_partial_kernel<float><<<grid, 256, 0, stream>>>(
        reinterpret_cast<const float*>(A), reinterpret_cast<const float*>(B),
        part, colsum, M, N1, N2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)N1 * N2;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      part, dW, n, (int)chunks);
  wgrad_reduce_kernel<<<(unsigned)((N1 + 255) / 256), 256, 0, stream>>>(
      colsum, db, N1, (int)chunks);
  return cudaGetLastError();
}
