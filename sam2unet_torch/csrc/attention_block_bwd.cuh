// The attention block's dx-only backward, recomputed from x: the LN pass
// and the QKV GEMM as in the forward; the forward attention again with its
// lse; dO = gy @ W_proj from the row-major-B GEMM, rounded to T as the
// plain version rounds it; attention_bwd.cuh's D, dQ and dK/dV passes write
// dqkv in T; the row-major-B GEMM dx_n = dqkv @ W_qkv; the LN backward pass
// adds gy for the residual. Shared by K5 and K7
// (fused_attention_block_bwd.cu) and K7's masked mode
// (fused_attention_block_masked.cu, `MASKED`).
#pragma once

#include "attention_bwd.cuh"
#include "gemm_bwd.cuh"

template <bool MASKED = false>
static int attn_block_bwd(int is_bf16, const void* x, const void* gy,
                          const void* w_qkv, const void* b_qkv, const void* ln_w,
                          const void* ln_b, const void* w_proj, void* xn,
                          void* qkv, void* o, float* lse, void* dout, float* D,
                          void* dqkv, void* dxn, void* dx, long long M, int c,
                          int residual, AttnParams ap, int n_windows, int nh,
                          cudaStream_t s) {
  cudaError_t e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, c, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g1 = {};
  g1.A = xn; g1.lda = c; g1.W = w_qkv; g1.bias = b_qkv;
  g1.C = qkv; g1.ldc = 3LL * c; g1.M = M; g1.N = 3 * c; g1.K = c;
  e = launch_gemm_dt(is_bf16, g1, s);
  if (e != cudaSuccess) return (int)e;
  ap.out = o; ap.lse = lse;
  e = launch_attn_dt<MASKED>(is_bf16, ap, n_windows, nh, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g2 = {};
  g2.A = gy; g2.lda = c; g2.W = w_proj;
  g2.C = dout; g2.ldc = c; g2.M = M; g2.N = c; g2.K = c;
  const GemmBwd nn = {1};
  e = launch_gemm_bwd_dt(is_bf16, g2, nn, s);
  if (e != cudaSuccess) return (int)e;
  AttnBwdParams bp = {};
  bp.a = ap; bp.o = o; bp.dout = dout; bp.lse = lse; bp.D = D;
  bp.dqkv = dqkv; bp.ld = 3LL * c;
  e = launch_attn_bwd_dt<MASKED>(is_bf16, bp, n_windows, nh, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g3 = {};
  g3.A = dqkv; g3.lda = 3LL * c; g3.W = w_qkv;
  g3.C = dxn; g3.ldc = c; g3.M = M; g3.N = c; g3.K = 3 * c;
  e = launch_gemm_bwd_dt(is_bf16, g3, nn, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(is_bf16, x, ln_w, dxn, residual ? gy : nullptr,
                               dx, M, c, s);
}
