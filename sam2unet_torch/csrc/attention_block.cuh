// The attention block's forward, LN1 -> QKV -> window attention -> proj
// [+ x], as four launches: the LN pass and the tiled GEMM write LN(x) and
// qkv (each rounded to T, as the reference rounds them), the attention
// kernel (attention.cuh) reads each window straight out of the qkv buffer
// by the geometry in `ap`, the GEMM for the proj adds the bias and the
// residual in its epilogue. Shared by K4, K6 and K12
// (fused_attention_block.cu) and K6's masked mode
// (fused_attention_block_masked.cu, `MASKED`).
#pragma once

#include "attention.cuh"
#include "gemm.cuh"

template <bool MASKED = false>
static int attn_block(int is_bf16, const void* x, const void* w_qkv,
                      const void* b_qkv, const void* ln_w, const void* ln_b,
                      const void* w_proj, const void* b_proj, void* xn,
                      void* qkv, void* o, void* out, long long M, int c,
                      int residual, const AttnParams& ap, int n_windows,
                      int nh, cudaStream_t s) {
  cudaError_t e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, c, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g1 = {};
  g1.A = xn; g1.lda = c; g1.W = w_qkv; g1.bias = b_qkv;
  g1.C = qkv; g1.ldc = 3LL * c; g1.M = M; g1.N = 3 * c; g1.K = c;
  e = launch_gemm_dt(is_bf16, g1, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_attn_dt<MASKED>(is_bf16, ap, n_windows, nh, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g2 = {};
  g2.A = o; g2.lda = c; g2.W = w_proj; g2.bias = b_proj;
  g2.R = residual ? x : nullptr; g2.ldr = c;
  g2.C = out; g2.ldc = c; g2.M = M; g2.N = c; g2.K = c;
  return (int)launch_gemm_dt(is_bf16, g2, s);
}
