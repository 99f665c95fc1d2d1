// The parameters of the LN and GEMM passes (gemm.cuh, gemm_bwd.cuh) and the
// C entry points of gemm_any.cu: the same passes at any width.
//
// The 16-byte-vector instances of gemm.cuh and gemm_bwd.cuh take rows whose
// widths and strides are multiples of 8 elements from 16-byte aligned bases,
// and an LN width of at most 2048. Their launchers (`launch_ln_dt`,
// `launch_gemm_dt`, `launch_gemm_bwd_dt`, `launch_ln_bwd_dt`, K7's
// weight-gradient LN statistics) call these entry points for every other
// width, stride or base; gemm_any.cu is a library of its own, loaded before
// the others with its symbols global, so the existing instances build
// exactly as before and these build once.
#pragma once

#include <cuda_runtime.h>

struct GemmParams {
  const void* A; long long lda;         // M x K activations
  const void* W;                        // N x K weight (torch Linear layout)
  const void* bias;                     // N, or null
  const void* R; long long ldr;         // residual, or null
  int res_pool;                         // 1: R is (B, 2*ph, 2*pw, ldr), 2x2 max
  int ph, pw;                           // pooled grid of C's rows (res_pool)
  void* C; long long ldc;
  void* C1; void* C2;                   // with split: column blocks 1 and 2
  int split;                            // 0, or the columns of each block
  long long M; int N; int K;
  int act;                              // 1: exact GELU after the bias
};

struct GemmBwd {
  int nn;                               // 1: W is the K x N row-major B operand
  float* pre; long long ldpre;          // fp32 value after the bias, or null
  int dgelu;                            // 1: v *= gelu'(H); 2: v = H * gelu'(v)
  const void* H; long long ldh;         // dgelu operand (fp32 if h_f32, else T)
  int h_f32;
};

// GemmParams and the backward's options (res_pool unused by gemm_bwd.cuh).
struct GemmBwdArgs : GemmParams { GemmBwd b; };

// y = LN(x) over rows of K (ln_rows_kernel's arithmetic).
extern "C" int gany_ln(int is_bf16, const void* x, const void* w,
                       const void* b, void* y, long long M, int K,
                       cudaStream_t stream);
// dx = LN's backward [+ gy] (ln_bwd_rows_kernel's arithmetic).
extern "C" int gany_ln_bwd(int is_bf16, const void* x, const void* w,
                           const void* dy, const void* gy, void* dx,
                           long long M, int K, cudaStream_t stream);
// mu[row], rs[row]: LN's row statistics (K7's weight-gradient mode).
extern "C" int gany_ln_stats(int is_bf16, const void* x, float* mu, float* rs,
                             long long M, int K, cudaStream_t stream);
// gemm.cuh's forward GEMM (with `split` and `res_pool`), or with `b`
// gemm_bwd.cuh's backward GEMM (b->nn, pre, dgelu); b null is the forward.
extern "C" int gany_gemm(int is_bf16, const GemmParams* p, const GemmBwd* b,
                         cudaStream_t stream);
