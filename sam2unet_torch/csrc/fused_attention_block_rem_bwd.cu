// K13: the dx-only backward of K12 (fused_attention_block.cu), the Hiera
// attention block on a grid the window does not divide or whose window is
// not 16-aligned, the weights frozen.
//
// Replaces both of the JAX package's kernels for it:
//   K13a sam2unet_tpu/ops/pallas/fused_attention_block.py::
//        _strip_rem_bwd_kernel (launched by _fused_strips_rem_bwd_impl,
//        :1651): a whole strip of windows per grid step;
//   K13b ::_strip_rem_bwd_kernel_jw (launched by
//        _fused_strips_rem_bwd_jw_impl, :1843): the window index on the
//        grid, for strips whose working set passes the TPU's 13 MiB of VMEM
//        (hiera_s@960 stage 3).
// The two compute the same dx and differ only in how they fill VMEM, so one
// kernel serves both; the wrapper counts each launch under the one the JAX
// package would launch (`strips_rem_bwd_regime`). Reached from `_strips_bwd`
// (:1896-1929) for frozen weights: an eval-mode gradient through the frozen
// trunk (hiera_s@960's 60x60 w14 and 30x30 w7 blocks).
//
// Bound on an H100: as K5 (the products, 2 * 8 c^2 FLOPs a token,
// compute-bound at c >= 288, and the attention's two passes).
//
// Design: K5's grid mode with K12's addressing of the ragged edge windows.
// The TPU kernel zero-padded each edge window in VMEM to the reference's
// win x win tokens (whose keys project to the qkv bias) and to its aligned
// (14, 16)-style shape (masked off the keys); here, as in K12, an edge
// window's vh x vw tokens inside the grid are read in place and its
// win^2 - vh*vw pads are one pad key at log-multiplicity ln(n_pad). The
// recompute runs LN -> QKV -> attention (its lse) from x as in K5; the
// attention backward's REM instance (attention_bwd.cuh) adds the pad key's
// dq-only term (its key and value are frozen bias slices) and finds the
// edge windows itself; dLN(x) = dqkv W_qkv and the LN backward adds gy for
// the residual. The pad tokens' own gradients, which the TPU kernel
// computed and cropped, do not exist here.

#include "attention_block_bwd.cuh"

// x, gy (B, H, W, c), any grid; the buffers of the dx-only backward, lse
// (B * ceil(H/window) * ceil(W/window) * nh, window^2).
extern "C" int k13_window_block_strips_rem_bwd(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    void* xn, void* qkv, void* o, float* lse, void* dout, float* D, void* dqkv,
    void* dxn, void* dx, int B, int H, int W, int c, int nh, int window,
    int residual, void* stream) {
  if (window < 1) return (int)cudaErrorInvalidValue;
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, 0);
  ap.pad_bias = b_qkv;
  ap.mode = 1; ap.S = ap.Sq = window * window; ap.H = H; ap.W = W;
  ap.win = window;
  const int n_windows =
      B * ((H + window - 1) / window) * ((W + window - 1) / window);
  return attn_block_bwd<false, true>(
      is_bf16, x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, xn, qkv, o, lse, dout,
      D, dqkv, dxn, dx, (long long)B * H * W, c, residual, ap, n_windows, nh,
      reinterpret_cast<cudaStream_t>(stream));
}
