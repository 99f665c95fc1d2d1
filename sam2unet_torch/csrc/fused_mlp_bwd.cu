// K2 and K3: the backward kernels of K1's two forms (fused_mlp.cu).
//
// K2 replaces sam2unet_tpu/ops/pallas/fused_mlp.py::_mlp_bwd_dx_kernel
// (launched by _mlp_bwd_dx, fused_mlp.py:432): dx of the frozen block tail,
// recomputed from x.
// K3 replaces fused_mlp.py::_adapter_bwd_kernel (launched by _adapter_bwd,
// :551): dx and the fp32 weight gradients of the trainable adapter.

#include "gemm_bwd.cuh"

// K2: dx of x + MLP(LN(x)) for the frozen tail (weights get no gradient).
// Bound on an H100: the three products (forward W1 recomputed, gy @ W2,
// dh @ W1; 6 * c * 4c FLOPs per token) are compute-bound from c = 288 up.
// Design: five launches. The LN pass writes LN(x); the forward GEMM writes
// the fp32 pre-activation of the hidden (the TPU kernel kept it in VMEM);
// the row-major-B GEMM gy @ W2 multiplies by the exact-erf GELU derivative
// of it in its epilogue and rounds dh to T (where the Pallas kernel rounds
// it, fused_mlp.py:382); dh @ W1 gives dLN(x) in T (the plain version
// rounds it there); the LN backward pass recomputes the row statistics and
// adds gy for the residual.
extern "C" int k2_mlp_bwd_dx(int is_bf16, const void* x, const void* gy,
                             const void* w1, const void* b1, const void* w2,
                             const void* ln_w, const void* ln_b, void* xn,
                             float* hpre, void* dh, void* dz, void* dx,
                             long long M, int C, int Hd, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, C, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g1 = {};
  g1.A = xn; g1.lda = C; g1.W = w1; g1.bias = b1;
  g1.M = M; g1.N = Hd; g1.K = C;
  GemmBwd o1 = {};
  o1.pre = hpre; o1.ldpre = Hd;
  e = launch_gemm_bwd_dt(is_bf16, g1, o1, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g2 = {};
  g2.A = gy; g2.lda = C; g2.W = w2;
  g2.C = dh; g2.ldc = Hd; g2.M = M; g2.N = Hd; g2.K = C;
  GemmBwd o2 = {};
  o2.nn = 1; o2.dgelu = 1; o2.H = hpre; o2.ldh = Hd; o2.h_f32 = 1;
  e = launch_gemm_bwd_dt(is_bf16, g2, o2, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g3 = {};
  g3.A = dh; g3.lda = Hd; g3.W = w1;
  g3.C = dz; g3.ldc = C; g3.M = M; g3.N = C; g3.K = Hd;
  const GemmBwd nn = {1};
  e = launch_gemm_bwd_dt(is_bf16, g3, nn, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(is_bf16, x, ln_w, dz, gy, dx, M, C, s);
}

// K3: dx, dW1, db1, dW2, db2 of the adapter x -> GELU(x@W1+b1) ->
// GELU(@W2+b2) [-> +x] (hidden 32). Bound on an H100: by the bytes of x,
// gy and dx (the products are 8 * c * 32 FLOPs per token, far below the
// ridge). Design: the forward GEMM writes the hidden h in T and the fp32
// pre-activation y1; the second forward GEMM recomputes y2 and writes
// dy2 = gy * gelu'(y2) in T from its epilogue; the row-major-B GEMMs give
// dy1 = (dy2 @ W2) * gelu'(y1) in T and dx = dy1 @ W1 (+ gy); the weight
// gradients are fp32 reductions over all tokens, dW2 = dy2^T h,
// dW1 = dy1^T x, db = column sums, in fixed 256-token chunks followed by one
// pass over the chunks (the TPU kernel carried fp32 accumulators across its
// sequential grid; here blocks run in parallel and the two-stage sum keeps
// the gradients deterministic). `ws` holds the partials of the larger of the
// two reductions.
extern "C" int k3_adapter_bwd(int is_bf16, const void* x, const void* gy,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, float* y1pre, void* h, void* dy2,
                              void* dy1, void* dx, float* ws, float* dw1,
                              float* db1, float* dw2, float* db2, long long M,
                              int C, int Hd, int residual, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  GemmParams g1 = {};
  g1.A = x; g1.lda = C; g1.W = w1; g1.bias = b1; g1.act = 1;
  g1.C = h; g1.ldc = Hd; g1.M = M; g1.N = Hd; g1.K = C;
  GemmBwd o1 = {};
  o1.pre = y1pre; o1.ldpre = Hd;
  cudaError_t e = launch_gemm_bwd_dt(is_bf16, g1, o1, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g2 = {};
  g2.A = h; g2.lda = Hd; g2.W = w2; g2.bias = b2;
  g2.C = dy2; g2.ldc = C; g2.M = M; g2.N = C; g2.K = Hd;
  GemmBwd o2 = {};
  o2.dgelu = 2; o2.H = gy; o2.ldh = C;
  e = launch_gemm_bwd_dt(is_bf16, g2, o2, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g3 = {};
  g3.A = dy2; g3.lda = C; g3.W = w2;
  g3.C = dy1; g3.ldc = Hd; g3.M = M; g3.N = Hd; g3.K = C;
  GemmBwd o3 = {};
  o3.nn = 1; o3.dgelu = 1; o3.H = y1pre; o3.ldh = Hd; o3.h_f32 = 1;
  e = launch_gemm_bwd_dt(is_bf16, g3, o3, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g4 = {};
  g4.A = dy1; g4.lda = Hd; g4.W = w1;
  g4.R = residual ? gy : nullptr; g4.ldr = C;
  g4.C = dx; g4.ldc = C; g4.M = M; g4.N = C; g4.K = Hd;
  const GemmBwd nn = {1};
  e = launch_gemm_bwd_dt(is_bf16, g4, nn, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_wgrad_dt(is_bf16, dy2, h, dw2, db2, ws, M, C, Hd, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_wgrad_dt(is_bf16, dy1, x, dw1, db1, ws, M, Hd, C, s);
}
