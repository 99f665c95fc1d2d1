// K1: fused transformer MLP  [LN ->] x@W1+b1 -> GELU -> @W2+b2 [-> GELU] [-> +x]
//
// Replaces sam2unet_tpu/ops/pallas/fused_mlp.py::_kernel (launched by
// _fused_mlp_vjp, fused_mlp.py:135). Used twice by every Hiera block: the
// LN2 -> MLP -> residual tail (hidden 4c) and the PEFT adapter (no LN,
// hidden 32, GELU on the output too).
//
// Bound on an H100: at c=144..1152 and 4c hidden the two products do
// 16*c FLOPs per token per byte-pair of x, so the tail is compute-bound
// from c=288 up (~295 FLOP/byte ridge); the adapter (hidden 32) is bound
// by moving x in and out.
//
// Design: the LayerNorm pass (tail only) and two launches of the shared
// tiled GEMM (gemm.cuh): the first adds the bias and the exact-erf GELU in
// its epilogue, the second the bias, optional GELU and residual. The TPU
// kernel kept the 4c hidden in VMEM; 227 KB of shared memory cannot hold a
// 128-token x 4608 tile, so here the hidden makes one bf16 round trip
// through device memory (rounded to T where the reference rounds it).
// Keeping it on chip by chunking the hidden dimension is later work.

#include "gemm.cuh"

extern "C" int k1_fused_mlp(int is_bf16, const void* x, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* ln_w, const void* ln_b, void* xn,
                            void* hidden, void* out, long long M, int C, int Hd,
                            int Cout, int residual, int gelu_out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (ln_w) {
    e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, C, s);
    if (e != cudaSuccess) return (int)e;
  }
  GemmParams g1 = {};
  g1.A = ln_w ? xn : x; g1.lda = C; g1.W = w1; g1.bias = b1;
  g1.C = hidden; g1.ldc = Hd; g1.M = M; g1.N = Hd; g1.K = C; g1.act = 1;
  e = launch_gemm_dt(is_bf16, g1, s);
  if (e != cudaSuccess) return (int)e;

  GemmParams g2 = {};
  g2.A = hidden; g2.lda = Hd; g2.W = w2; g2.bias = b2;
  g2.R = residual ? x : nullptr; g2.ldr = C;
  g2.C = out; g2.ldc = Cout; g2.M = M; g2.N = Cout; g2.K = Hd; g2.act = gelu_out;
  return (int)launch_gemm_dt(is_bf16, g2, s);
}

// K15 and K16: LayerNorm -> x@W [+ b], and the same with the QKV product's
// output split into q, k and v.
//
// K15 replaces sam2unet_tpu/ops/pallas/fused_mlp.py::_ln_matmul_kernel
// (launched by fused_ln_matmul, fused_mlp.py:208); K16 replaces
// ::_ln_qkv_kernel (launched by fused_ln_qkv, :279). Their entry points are
// the pre-norm QKV projection (`MultiScaleAttention.project_qkv` with the
// LN's parameters) and `fused_ln_qkv` itself.
//
// Bound on an H100: x@W does 2 * c * N FLOPs per token against 2 * (c + N)
// bytes in bf16, at N = 3c 0.75 * c FLOPs a byte against the ~295 of the
// ridge: bound by the bytes up to c ~ 390 (the widths 96-384), by the
// operations at 576 and 1152.
//
// Design: the LN pass writes LN(x) rounded to T (where the reference rounds
// it) and the shared tiled GEMM (gemm.cuh) reads it, as K1's tail does; the
// TPU kernel normed a 512-row tile in VMEM before its matmul. K16's GEMM
// (gemm.cuh's split form) sends each column block of N / 3 to its own
// output from the epilogue,
// so q, k and v land in three separate tensors with no copy and the same
// arithmetic as K15's one output (the TPU kernel split the tile in VMEM).
static int ln_matmul(int is_bf16, const void* x, const void* w, const void* b,
                     const void* ln_w, const void* ln_b, void* xn, void* out,
                     void* out1, void* out2, long long M, int C, int N,
                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, C, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g = {};
  g.A = xn; g.lda = C; g.W = w; g.bias = b;
  g.C = out; g.ldc = N; g.M = M; g.N = N; g.K = C;
  if (!out1) return (int)launch_gemm_dt(is_bf16, g, s);
  g.C1 = out1; g.C2 = out2; g.split = N / 3; g.ldc = N / 3;
  return (int)launch_gemm_dt<true>(is_bf16, g, s);
}

// K15: out (M, N) = LN(x) @ W^T [+ b] (b null: no bias).
extern "C" int k15_ln_matmul(int is_bf16, const void* x, const void* w,
                             const void* b, const void* ln_w, const void* ln_b,
                             void* xn, void* out, long long M, int C, int N,
                             void* stream) {
  return ln_matmul(is_bf16, x, w, b, ln_w, ln_b, xn, out, nullptr, nullptr, M,
                   C, N, stream);
}

// K16: q, k, v (M, N / 3 each) = the three column blocks of K15's output.
extern "C" int k16_ln_qkv(int is_bf16, const void* x, const void* w,
                          const void* b, const void* ln_w, const void* ln_b,
                          void* xn, void* q, void* k, void* v, long long M,
                          int C, int N, void* stream) {
  if (N % 3) return (int)cudaErrorInvalidValue;
  return ln_matmul(is_bf16, x, w, b, ln_w, ln_b, xn, q, k, v, M, C, N, stream);
}
