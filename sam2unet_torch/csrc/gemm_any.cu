// The LN and GEMM passes of every fused block (gemm.cuh, gemm_bwd.cuh) at
// any width: rows that are not a multiple of 8 elements wide, strides that
// are not, bases that are not 16-byte aligned, and LN rows past 2048.
//
// Replaces, at those widths, the LN and the products inside
// sam2unet_tpu/ops/pallas/fused_mlp.py::_kernel (K1, launched by
// _fused_mlp_vjp, :135), ::_ln_matmul_kernel (K15, :208), ::_ln_qkv_kernel
// (K16, :279), ::_mlp_bwd_dx_kernel (K2, :432), ::_adapter_bwd_kernel (K3,
// :551), fused_attention_block.py's window, strip and remainder kernels and
// their backwards (K4-K7, K12, K13) and fused_transition.py's
// _transition_kernel and _transition_bwd_kernel (K8, K9): the JAX kernels
// take any width (the package's own tests run K15 / K16 at C 12 -> 36).
//
// Bound on an H100: as the instances they stand in for (the products
// compute-bound from c ~ 300 up, the LN passes by their bytes).
//
// Design: the same tiling as gemm.cuh (128x128 tiles, 8 warps, a 3-stage
// ring in shared memory, ldmatrix and mma.sync.m16n8k16 in bf16, CUDA-core
// FMAs in fp32), with the tiles' copies at the widest size the rows allow:
// VW elements at a time by cp.async (VW = 8, 4 or 2 in bf16: 16, 8 or 4
// bytes) where K, lda (N for the row-major B operand) and the bases allow
// it, else one element at a time through the registers; K and N edges are
// zero-filled in the tile. The epilogue goes element by element (bias,
// exact GELU, the fp32 pre-activation, GELU's derivative, the residual or
// its 2x2 max, K16's column blocks), so any N, ldc, ldr, ldh or split. The
// LN passes run a warp per row up to 1024 columns and a block of 256 past
// it, reading the row element by element (coalesced across the lanes) once
// for the mean, once for the centred variance and once for the output: the
// two-pass fp32 statistics of ln_rows_kernel, eps 1e-6, rounded to T where
// it rounds. A library of its own, loaded before the others with its
// symbols global: the launchers of gemm.cuh, gemm_bwd.cuh and K7's
// weight-gradient mode call these entry points, so the existing instances
// build exactly as before and these build once.

#include "common.cuh"
#include "gemm_any.cuh"

constexpr int GA_BM = 128, GA_BN = 128, GA_BK = 32, GA_LD = GA_BK + 8;
constexpr int GA_LDN = GA_BN + 8;     // row-major B tile rows (nn)
constexpr int GA_STAGES = 3, GA_THREADS = 256;
constexpr int GA_CHUNKS = GA_BM * GA_BK / 8 / GA_THREADS;   // 8-element chunks
constexpr size_t GA_SMEM_BF16 = sizeof(bf16) * GA_STAGES * (GA_BM + GA_BN) * GA_LD;
constexpr size_t GA_SMEM_F32 = sizeof(float) * (GA_BM + GA_BN) * GA_LD;
constexpr int GA_LN_WARP_K = 1024;   // LN rows up to this width: a warp each
static_assert(GA_BK * GA_LDN <= GA_BN * GA_LD, "nn B tile fits the B ring");

// ------------------------------------------------------------------ LN

// The sum of v over the TEAM threads of a row: a warp, or the 256 threads of
// a block (through `red`, which every thread of the block reaches).
template <int TEAM>
__device__ __forceinline__ float team_sum(float v, float* red) {
  v = warp_sum(v);
  if constexpr (TEAM == 32) {
    return v;
  } else {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();   // the previous sum's reads of red are done
    if (lane == 0) red[w] = v;
    __syncthreads();
    return warp_sum(lane < TEAM / 32 ? red[lane] : 0.f);
  }
}

// The row's mean and 1 / sqrt(var + eps), two passes in fp32.
template <typename T, int TEAM>
__device__ __forceinline__ void row_stats(const T* __restrict__ xr, int K,
                                          int t, float* red, float& mu,
                                          float& rs) {
  float s = 0.f;
  for (int k = t; k < K; k += TEAM) s += to_f(xr[k]);
  mu = team_sum<TEAM>(s, red) / K;
  float var = 0.f;
  for (int k = t; k < K; k += TEAM) {
    const float d = to_f(xr[k]) - mu;
    var += d * d;
  }
  rs = rsqrtf(team_sum<TEAM>(var, red) / K + 1e-6f);
}

template <typename T, int TEAM>
__global__ void __launch_bounds__(256) gany_ln_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ y, long long M, int K) {
  __shared__ float red[8];
  const long long row = (long long)blockIdx.x * (256 / TEAM) + threadIdx.x / TEAM;
  const int t = threadIdx.x % TEAM;
  if (row >= M) return;   // whole warps (TEAM 32) or never (TEAM 256)
  const T* xr = x + row * K;
  float mu, rs;
  row_stats<T, TEAM>(xr, K, t, red, mu, rs);
  T* yr = y + row * K;
  for (int k = t; k < K; k += TEAM)
    yr[k] = from_f<T>((to_f(xr[k]) - mu) * rs * to_f(w[k]) + to_f(b[k]));
}

// dx = rs (dxh - mean(dxh) - xh mean(dxh xh)) [+ gy], dxh = dy w: the
// arithmetic of gemm_bwd.cuh's ln_bwd_rows_kernel.
template <typename T, int TEAM>
__global__ void __launch_bounds__(256) gany_ln_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dy,
    const T* __restrict__ gy, T* __restrict__ dx, long long M, int K) {
  __shared__ float red[8];
  const long long row = (long long)blockIdx.x * (256 / TEAM) + threadIdx.x / TEAM;
  const int t = threadIdx.x % TEAM;
  if (row >= M) return;
  const T* xr = x + row * K;
  const T* dr = dy + row * K;
  float mu, rs;
  row_stats<T, TEAM>(xr, K, t, red, mu, rs);
  float s1 = 0.f, s2 = 0.f;
  for (int k = t; k < K; k += TEAM) {
    const float xh = (to_f(xr[k]) - mu) * rs;
    const float dh = to_f(dr[k]) * to_f(w[k]);
    s1 += dh;
    s2 += dh * xh;
  }
  const float m1 = team_sum<TEAM>(s1, red) / K;
  const float m2 = team_sum<TEAM>(s2, red) / K;
  for (int k = t; k < K; k += TEAM) {
    const float xh = (to_f(xr[k]) - mu) * rs;
    const float dh = to_f(dr[k]) * to_f(w[k]);
    float o = rs * (dh - m1 - xh * m2);
    if (gy) o += to_f(gy[row * K + k]);
    dx[row * K + k] = from_f<T>(o);
  }
}

template <typename T, int TEAM>
__global__ void __launch_bounds__(256) gany_ln_stats_kernel(
    const T* __restrict__ x, float* __restrict__ mu, float* __restrict__ rs,
    long long M, int K) {
  __shared__ float red[8];
  const long long row = (long long)blockIdx.x * (256 / TEAM) + threadIdx.x / TEAM;
  const int t = threadIdx.x % TEAM;
  if (row >= M) return;
  float m, r;
  row_stats<T, TEAM>(x + row * K, K, t, red, m, r);
  if (t == 0) {
    mu[row] = m;
    rs[row] = r;
  }
}

// A row pass: 8 rows a block (a warp each) up to GA_LN_WARP_K columns, a
// block a row past it.
template <typename K32, typename K256, typename... Args>
static int ln_launch(K32 k32, K256 k256, long long M, int K,
                     cudaStream_t stream, Args... args) {
  const long long nb = K > GA_LN_WARP_K ? M : (M + 7) / 8;
  if (nb > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (K > GA_LN_WARP_K)
    k256<<<(unsigned)nb, 256, 0, stream>>>(args...);
  else
    k32<<<(unsigned)nb, 256, 0, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T>
static int ln_t(const void* x, const void* w, const void* b, void* y,
                long long M, int K, cudaStream_t stream) {
  return ln_launch(gany_ln_kernel<T, 32>, gany_ln_kernel<T, 256>, M, K, stream,
                   reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(w),
                   reinterpret_cast<const T*>(b), reinterpret_cast<T*>(y), M, K);
}

template <typename T>
static int ln_bwd_t(const void* x, const void* w, const void* dy,
                    const void* gy, void* dx, long long M, int K,
                    cudaStream_t stream) {
  return ln_launch(gany_ln_bwd_kernel<T, 32>, gany_ln_bwd_kernel<T, 256>, M, K,
                   stream, reinterpret_cast<const T*>(x),
                   reinterpret_cast<const T*>(w), reinterpret_cast<const T*>(dy),
                   reinterpret_cast<const T*>(gy), reinterpret_cast<T*>(dx), M, K);
}

template <typename T>
static int ln_stats_t(const void* x, float* mu, float* rs, long long M, int K,
                      cudaStream_t stream) {
  return ln_launch(gany_ln_stats_kernel<T, 32>, gany_ln_stats_kernel<T, 256>,
                   M, K, stream, reinterpret_cast<const T*>(x), mu, rs, M, K);
}

extern "C" int gany_ln(int is_bf16, const void* x, const void* w,
                       const void* b, void* y, long long M, int K,
                       cudaStream_t stream) {
  if (K < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return is_bf16 ? ln_t<bf16>(x, w, b, y, M, K, stream)
                 : ln_t<float>(x, w, b, y, M, K, stream);
}

extern "C" int gany_ln_bwd(int is_bf16, const void* x, const void* w,
                           const void* dy, const void* gy, void* dx,
                           long long M, int K, cudaStream_t stream) {
  if (K < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return is_bf16 ? ln_bwd_t<bf16>(x, w, dy, gy, dx, M, K, stream)
                 : ln_bwd_t<float>(x, w, dy, gy, dx, M, K, stream);
}

extern "C" int gany_ln_stats(int is_bf16, const void* x, float* mu, float* rs,
                             long long M, int K, cudaStream_t stream) {
  if (K < 1 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return is_bf16 ? ln_stats_t<bf16>(x, mu, rs, M, K, stream)
                 : ln_stats_t<float>(x, mu, rs, M, K, stream);
}

// ------------------------------------------------------------ epilogue

// Column n of row m: gemm.cuh's gemm_epi2 and gemm_bwd.cuh's
// gemm_bwd_store2 one element at a time (the options not set are skipped).
template <typename T>
__device__ __forceinline__ void gany_epi(const GemmBwdArgs& p, long long m,
                                         int n, float v) {
  if (p.bias) v += to_f(reinterpret_cast<const T*>(p.bias)[n]);
  const GemmBwd& q = p.b;
  if (q.pre) q.pre[m * q.ldpre + n] = v;
  if (p.act) v = gelu_erf(v);
  if (q.dgelu) {
    const float h = q.h_f32 ? reinterpret_cast<const float*>(q.H)[m * q.ldh + n]
                            : to_f(reinterpret_cast<const T*>(q.H)[m * q.ldh + n]);
    v = q.dgelu == 1 ? v * dgelu_erf(h) : h * dgelu_erf(v);
  }
  if (p.R) {
    const T* R = reinterpret_cast<const T*>(p.R);
    float r;
    if (!p.res_pool) {
      r = to_f(R[m * p.ldr + n]);
    } else {
      const long long per = (long long)p.ph * p.pw;
      const long long b = m / per;
      const int rem = (int)(m - b * per);
      const int i = rem / p.pw, j = rem - i * p.pw;
      const long long wfull = 2LL * p.pw;
      const long long r00 = (b * 2 * p.ph + 2 * i) * wfull + 2 * j;
      r = fmaxf(fmaxf(to_f(R[r00 * p.ldr + n]), to_f(R[(r00 + 1) * p.ldr + n])),
                fmaxf(to_f(R[(r00 + wfull) * p.ldr + n]),
                      to_f(R[(r00 + wfull + 1) * p.ldr + n])));
    }
    v = round_to<T>(v) + r;
  }
  if (p.C) {
    const int j = p.split ? (n >= p.split) + (n >= 2 * p.split) : 0;
    void* c = j == 0 ? p.C : (j == 1 ? p.C1 : p.C2);
    reinterpret_cast<T*>(c)[m * p.ldc + (n - j * p.split)] = from_f<T>(v);
  }
}

// ------------------------------------------------------------ bf16 GEMM

// BYTES (4, 8 or 16) from global to shared memory without the registers;
// `valid` false writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(gmem), "n"(BYTES), "r"(bytes));
}

// Eight consecutive elements of a tile row: the first `nvalid` (a multiple
// of VW, or <= 0) from g, the rest zero; VW at a time.
template <int VW>
__device__ __forceinline__ void copy8(bf16* s, const bf16* g, int nvalid) {
#pragma unroll
  for (int j = 0; j < 8; j += VW) {
    if constexpr (VW == 1)
      s[j] = j < nvalid ? g[j] : __float2bfloat16(0.f);
    else
      cp_async_n<2 * VW>(s + j, g + j, j < nvalid);
  }
}

template <int VW, bool NN>
__global__ void __launch_bounds__(GA_THREADS, 2) gany_gemm_bf16_kernel(GemmBwdArgs p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* As = reinterpret_cast<bf16*>(g_smem);      // [STAGES][BM][LD]
  bf16* Bs = As + GA_STAGES * GA_BM * GA_LD;       // [STAGES][BN][LD] or [BK][LDN]
  const bf16* A = reinterpret_cast<const bf16*>(p.A);
  const bf16* W = reinterpret_cast<const bf16*>(p.W);
  const long long m0 = (long long)blockIdx.y * GA_BM;
  const int n0 = blockIdx.x * GA_BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int KT = (p.K + GA_BK - 1) / GA_BK;

  // each thread fills GA_CHUNKS 8-element chunks of A and as many of W; an
  // invalid chunk's copies read nothing (their source is the operand's base)
  auto load_stage = [&](int buf, int kt) {
#pragma unroll
    for (int i = 0; i < GA_CHUNKS; ++i) {
      const int v = tid + i * GA_THREADS;
      const int r = v / (GA_BK / 8), kk = v % (GA_BK / 8) * 8, k = kt * GA_BK + kk;
      const long long m = m0 + r;
      const int na = m < p.M ? min(8, p.K - k) : 0;
      copy8<VW>(As + (buf * GA_BM + r) * GA_LD + kk, na > 0 ? A + m * p.lda + k : A, na);
      if constexpr (!NN) {
        const int n = n0 + r;
        const int nb = n < p.N ? min(8, p.K - k) : 0;
        copy8<VW>(Bs + (buf * GA_BN + r) * GA_LD + kk,
                  nb > 0 ? W + (long long)n * p.K + k : W, nb);
      } else {
        const int br = v / (GA_BN / 8), bc = v % (GA_BN / 8) * 8;
        const int bk = kt * GA_BK + br, n = n0 + bc;
        const int nb = bk < p.K ? min(8, p.N - n) : 0;
        copy8<VW>(Bs + (buf * GA_BK + br) * GA_LDN + bc,
                  nb > 0 ? W + (long long)bk * p.N + n : W, nb);
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
  for (int s = 0; s < GA_STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<GA_STAGES - 2>();
    __syncthreads();   // stage kt landed for all; stage kt-1 fully consumed
    const int nk = kt + GA_STAGES - 1;
    if (nk < KT) load_stage(nk % GA_STAGES, nk);
    cp_async_commit();
    const int buf = kt % GA_STAGES;
    const bf16* as = As + (buf * GA_BM + wm * 64) * GA_LD;
#pragma unroll
    for (int ks = 0; ks < GA_BK / 16; ++ks) {
      unsigned bfr[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        if constexpr (!NN) {
          const bf16* bs = Bs + (buf * GA_BN + wn * 32) * GA_LD;
          const int nrow = j * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(r, bs + nrow * GA_LD + ks * 16 + ((lane >> 3) & 1) * 8);
        } else {
          const bf16* bs = Bs + buf * GA_BK * GA_LDN;
          ldmatrix_x4_trans(r, bs + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * GA_LDN
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
        ldmatrix_x4(afr, as + (i * 16 + (lane & 15)) * GA_LD + ks * 16 + (lane >> 4) * 8);
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
        if (n < p.N) gany_epi<bf16>(p, m, n, acc[i][j][2 * h]);
        if (n + 1 < p.N) gany_epi<bf16>(p, m, n + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

// ------------------------------------------------------------ fp32 GEMM

template <bool NN>
__global__ void __launch_bounds__(GA_THREADS) gany_gemm_f32_kernel(GemmBwdArgs p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  float* As = reinterpret_cast<float*>(g_smem);    // [BM][LD]
  float* Bs = As + GA_BM * GA_LD;                  // [BN][LD]
  const float* A = reinterpret_cast<const float*>(p.A);
  const float* W = reinterpret_cast<const float*>(p.W);
  const long long m0 = (long long)blockIdx.y * GA_BM;
  const int n0 = blockIdx.x * GA_BN;
  // rows ty + 16i; column pairs 32jp + 2tx + {0, 1}, acc[i][2jp + {0, 1}]
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += GA_BK) {
#pragma unroll
    for (int i = 0; i < GA_CHUNKS; ++i) {
      const int v = tid + i * GA_THREADS;
      const int r = v / (GA_BK / 8), kk = v % (GA_BK / 8) * 8, k = k0 + kk;
      const long long m = m0 + r;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        As[r * GA_LD + kk + e] = m < p.M && k + e < p.K ? A[m * p.lda + k + e] : 0.f;
      if constexpr (!NN) {
        const int n = n0 + r;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          Bs[r * GA_LD + kk + e] =
              n < p.N && k + e < p.K ? W[(long long)n * p.K + k + e] : 0.f;
      } else {
        // the K x N tile, stored transposed as Bs[n][k]
        const int br = v / (GA_BN / 8), bc = v % (GA_BN / 8) * 8;
        const int bk = k0 + br, n = n0 + bc;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          Bs[(bc + e) * GA_LD + br] =
              bk < p.K && n + e < p.N ? W[(long long)bk * p.N + n + e] : 0.f;
      }
    }
    __syncthreads();
    for (int k = 0; k < GA_BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * GA_LD + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(32 * (j >> 1) + 2 * tx + (j & 1)) * GA_LD + k];
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
      if (n < p.N) gany_epi<float>(p, m, n, acc[i][2 * jp]);
      if (n + 1 < p.N) gany_epi<float>(p, m, n + 1, acc[i][2 * jp + 1]);
    }
  }
}

// ------------------------------------------------------------- launches

template <typename K>
static int gany_launch(K kernel, size_t smem, dim3 grid, const GemmBwdArgs& a,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, GA_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The widest bf16 copy (8, 4, 2 or 1 elements) every tile row allows: K and
// lda (and N, the row-major B operand's row) multiples of it, A and W
// aligned to its bytes.
static int gany_vw(const GemmParams& p, bool nn) {
  for (int vw = 8; vw > 1; vw /= 2) {
    const uintptr_t bytes = 2 * vw;
    if (p.K % vw == 0 && p.lda % vw == 0 && (!nn || p.N % vw == 0)
        && reinterpret_cast<uintptr_t>(p.A) % bytes == 0
        && reinterpret_cast<uintptr_t>(p.W) % bytes == 0)
      return vw;
  }
  return 1;
}

template <bool NN>
static int gemm_bf16_vw(int vw, dim3 grid, const GemmBwdArgs& a,
                        cudaStream_t stream) {
  switch (vw) {
    case 8: return gany_launch(gany_gemm_bf16_kernel<8, NN>, GA_SMEM_BF16, grid, a, stream);
    case 4: return gany_launch(gany_gemm_bf16_kernel<4, NN>, GA_SMEM_BF16, grid, a, stream);
    case 2: return gany_launch(gany_gemm_bf16_kernel<2, NN>, GA_SMEM_BF16, grid, a, stream);
    default: return gany_launch(gany_gemm_bf16_kernel<1, NN>, GA_SMEM_BF16, grid, a, stream);
  }
}

extern "C" int gany_gemm(int is_bf16, const GemmParams* p, const GemmBwd* b,
                         cudaStream_t stream) {
  GemmBwdArgs a;
  static_cast<GemmParams&>(a) = *p;
  a.b = b ? *b : GemmBwd{};
  if (a.M < 0 || a.N < 1 || a.K < 1 || (a.split && a.N != 3 * a.split)
      || (b && (a.res_pool || a.split)))
    return (int)cudaErrorInvalidValue;
  if (a.M == 0) return 0;
  const long long mt = (a.M + GA_BM - 1) / GA_BM;
  if (mt > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((a.N + GA_BN - 1) / GA_BN, (unsigned)mt);
  const bool nn = a.b.nn;
  if (!is_bf16)
    return nn ? gany_launch(gany_gemm_f32_kernel<true>, GA_SMEM_F32, grid, a, stream)
              : gany_launch(gany_gemm_f32_kernel<false>, GA_SMEM_F32, grid, a, stream);
  const int vw = gany_vw(a, nn);
  return nn ? gemm_bf16_vw<true>(vw, grid, a, stream)
            : gemm_bf16_vw<false>(vw, grid, a, stream);
}
