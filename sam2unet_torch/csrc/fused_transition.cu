// K8: the Hiera q-pool transition block, (B, H, W, cin) -> (B, H/2, W/2, cout):
// LN -> shortcut Dense + 2x2 max-pool; windowed QKV -> in-window 2x2 q-pool
// -> attention -> proj -> + shortcut.
//
// Replaces sam2unet_tpu/ops/pallas/fused_transition.py::_transition_kernel
// (launched by _fused_transition_fwd_impl, :256). Runs at the divisible
// transitions into stages 2 and 3 (hiera.py:311-360).
//
// Bound on an H100: the full-resolution QKV + shortcut products
// (2*cin*4*cout FLOPs per input token) are compute-bound; the pooled
// output is 8x smaller in bytes than the input's projections.
//
// Design: five launches. The LN pass writes the normed activations; two
// tiled GEMMs write qkv and the (unpooled) shortcut projection from them,
// in T; the attention kernel
// (attention.cuh, grid mode, qpool) forms each pooled query as the 2x2 max
// of the window's projected q while loading it, attends over the window's
// full-resolution keys and writes straight onto the pooled grid; the proj
// GEMM adds the bias, rounds, and adds the 2x2 max of the shortcut in its
// epilogue, so no pooled shortcut tensor is materialized.

#include "attention.cuh"
#include "gemm.cuh"

extern "C" int k8_transition(
    int is_bf16, const void* x, const void* w_qkv, const void* b_qkv,
    const void* ln_w, const void* ln_b, const void* w_proj, const void* b_proj,
    const void* w_short, const void* b_short, void* xn, void* qkv,
    void* shortcut, void* o, void* out, int B, int H, int W, int cin,
    int cout, int nh, int window, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  const long long M2 = (long long)B * (H / 2) * (W / 2);

  cudaError_t e = launch_ln_dt(is_bf16, x, ln_w, ln_b, xn, M, cin, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g1 = {};
  g1.A = xn; g1.lda = cin; g1.W = w_qkv; g1.bias = b_qkv;
  g1.C = qkv; g1.ldc = 3LL * cout; g1.M = M; g1.N = 3 * cout; g1.K = cin;
  e = launch_gemm_dt(is_bf16, g1, s);
  if (e != cudaSuccess) return (int)e;

  GemmParams g2 = {};
  g2.A = xn; g2.lda = cin; g2.W = w_short; g2.bias = b_short;
  g2.C = shortcut; g2.ldc = cout; g2.M = M; g2.N = cout; g2.K = cin;
  e = launch_gemm_dt(is_bf16, g2, s);
  if (e != cudaSuccess) return (int)e;

  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, cout, nh, 0);
  ap.out = o; ap.mode = 1; ap.S = window * window;
  ap.Sq = (window / 2) * (window / 2); ap.H = H; ap.W = W; ap.win = window;
  ap.qpool = 1;
  e = launch_attn_dt(is_bf16, ap, B * (H / window) * (W / window), nh, s);
  if (e != cudaSuccess) return (int)e;

  GemmParams g3 = {};
  g3.A = o; g3.lda = cout; g3.W = w_proj; g3.bias = b_proj;
  g3.R = shortcut; g3.ldr = cout; g3.res_pool = 1; g3.ph = H / 2; g3.pw = W / 2;
  g3.C = out; g3.ldc = cout; g3.M = M2; g3.N = cout; g3.K = cout;
  return (int)launch_gemm_dt(is_bf16, g3, s);
}
