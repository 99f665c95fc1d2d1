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
