// K4, K6 and K12: the Hiera attention block LN1 -> QKV -> window attention
// -> proj -> +x.
//
// K4 replaces sam2unet_tpu/ops/pallas/fused_attention_block.py::_strip_kernel
//    (launched by _fused_strips_fwd_impl, :1021): unpartitioned (B, H, W, c)
//    activations on window-divisible grids (Hiera stages 1-2).
// K6 replaces fused_attention_block.py::_kernel (launched by
//    _fused_window_block_fwd_impl, :354): pre-partitioned (nW, S, c) window
//    rows with an optional synthetic pad key (remainder windows of stages
//    3-4 at 352) and global attention over whole images (S = 484).
// K12 replaces fused_attention_block.py::_strip_rem_kernel (launched by
//    _fused_strips_rem_fwd_impl, :1566): K4 on grids the window does not
//    divide or whose window is not 16-aligned (hiera_s@960 stages 3-4, eval).
//    The reference zero-pads the normed activations (hieradet.py:140-143),
//    so each pad token projects to the qkv bias: the TPU kernel builds those
//    pads in VMEM (plus alignment pads it masks off the keys); here each
//    edge window's n_pad(w) = win^2 - vh*vw pads are its own synthetic pad
//    key, and the TPU's (14, 16)-style alignment pads have no counterpart.
//
// Bound on an H100: the QKV and proj products (8*c^2 FLOPs per token)
// dominate and are compute-bound at c >= 288; attention adds 4*S*c FLOPs
// per token (S = 256 in stage 3 windows at 352, 196 at 960, 484 in the
// global blocks at 352).
//
// Design: four launches. (1) the LN pass writes the normed activations and
// (2) the tiled GEMM writes qkv from them (each rounded to T, as the
// reference rounds them); (3) the attention kernel
// (attention.cuh) reads each window straight out of that buffer, in grid
// mode for K4 and K12, so no partitioned copy is made, and writes the head
// outputs back in the activations' own layout; (4) the tiled GEMM for the
// proj with bias and residual in the epilogue. The S x S scores of the TPU
// kernel become an online softmax over 64-key tiles held in registers. The
// stage-4 weights (1152 x 3456) are streamed through shared memory tile by
// tile instead of being held resident as on the TPU.

#include "attention_block.cuh"

// Grid mode over x (B, H, W, c): ceil(H/window) x ceil(W/window) windows;
// `b_pad` (the qkv bias) enables the per-window pad key of edge windows.
static int grid_block(int is_bf16, const void* x, const void* w_qkv,
                      const void* b_qkv, const void* ln_w, const void* ln_b,
                      const void* w_proj, const void* b_proj, void* xn,
                      void* qkv, void* o, void* out, int B, int H, int W,
                      int c, int nh, int window, int residual,
                      const void* b_pad, void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, 0);
  ap.out = o; ap.pad_bias = b_pad; ap.mode = 1;
  ap.S = ap.Sq = window * window; ap.H = H; ap.W = W; ap.win = window;
  const int n_windows =
      B * ((H + window - 1) / window) * ((W + window - 1) / window);
  return attn_block(is_bf16, x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, xn,
                    qkv, o, out, (long long)B * H * W, c, residual, ap,
                    n_windows, nh, reinterpret_cast<cudaStream_t>(stream));
}

// K4: x (B, H, W, c) with H % window == 0 == W % window.
extern "C" int k4_window_block_strips(
    int is_bf16, const void* x, const void* w_qkv, const void* b_qkv,
    const void* ln_w, const void* ln_b, const void* w_proj, const void* b_proj,
    void* xn, void* qkv, void* o, void* out, int B, int H, int W, int c,
    int nh, int window, int residual, void* stream) {
  return grid_block(is_bf16, x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, xn,
                    qkv, o, out, B, H, W, c, nh, window, residual, nullptr,
                    stream);
}

// K12: x (B, H, W, c) on any grid; edge windows attend over their valid
// tokens plus the pad key of their own n_pad.
extern "C" int k12_window_block_strips_rem(
    int is_bf16, const void* x, const void* w_qkv, const void* b_qkv,
    const void* ln_w, const void* ln_b, const void* w_proj, const void* b_proj,
    void* xn, void* qkv, void* o, void* out, int B, int H, int W, int c,
    int nh, int window, int residual, void* stream) {
  return grid_block(is_bf16, x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, xn,
                    qkv, o, out, B, H, W, c, nh, window, residual, b_qkv,
                    stream);
}

// K6: x (nW, S, c) window rows; n_pad > 0 adds the synthetic pad key.
extern "C" int k6_window_block(
    int is_bf16, const void* x, const void* w_qkv, const void* b_qkv,
    const void* ln_w, const void* ln_b, const void* w_proj, const void* b_proj,
    void* xn, void* qkv, void* o, void* out, int nW, int S, int c, int nh,
    int n_pad, int residual, void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, S);
  ap.out = o;
  ap.pad_bias = n_pad > 0 ? b_qkv : nullptr;
  ap.pad_logn = n_pad > 0 ? logf((float)n_pad) : 0.f;
  ap.mode = 0; ap.S = S; ap.Sq = S;
  return attn_block(is_bf16, x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, xn,
                    qkv, o, out, (long long)nW * S, c, residual, ap, nW, nh,
                    reinterpret_cast<cudaStream_t>(stream));
}
