// K5 and K7: the dx-only backward of the Hiera attention block
// (fused_attention_block.cu).
//
// K5 replaces sam2unet_tpu/ops/pallas/fused_attention_block.py::
//    _strip_bwd_kernel (launched by _fused_strips_bwd_impl, :1082): dx of K4
//    on window-divisible grids.
// K7 replaces fused_attention_block.py::_bwd_kernel (launched by
//    _fused_window_block_bwd_impl, :669) in its dx-only unmasked mode for
//    n_pad = 0 (the full window groups of stages 3-4 at 352 and the global
//    blocks, S = 484); the weight-gradient and masked modes are not ported.
// The trunk is frozen, so only dx is computed. Bound on an H100: the
// products (QKV recomputed, dO = gy Wp, dx_n = dqkv W_qkv: 2 * 8 * c^2
// FLOPs per token) and the attention's two passes (~5 * 4 * S * c per
// token: scores twice, dP twice, dV, dQ, dK) are compute-bound at
// c >= 288. Design, recomputed from x like the TPU kernel (nothing of the
// forward is saved but x): the LN pass and the QKV GEMM as in the forward;
// the forward attention again with its lse; dO = gy @ W_proj from the
// row-major-B GEMM, rounded to T as the plain version rounds it;
// attention_bwd.cuh's D, dQ and dK/dV passes write dqkv in T; the
// row-major-B GEMM dx_n = dqkv @ W_qkv; the LN backward pass adds gy. The
// TPU kernel held one window group's scores in VMEM and walked the heads on
// its grid; here the scores stream through registers in 64-token tiles.

#include "attention_block_bwd.cuh"

// K5: x (B, H, W, c) with H % window == 0 == W % window.
extern "C" int k5_window_block_strips_bwd(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    void* xn, void* qkv, void* o, float* lse, void* dout, float* D, void* dqkv,
    void* dxn, void* dx, int B, int H, int W, int c, int nh, int window,
    int residual, void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, 0);
  ap.mode = 1; ap.S = ap.Sq = window * window; ap.H = H; ap.W = W;
  ap.win = window;
  return attn_block_bwd(is_bf16, x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, xn,
                        qkv, o, lse, dout, D, dqkv, dxn, dx,
                        (long long)B * H * W, c, residual, ap,
                        B * (H / window) * (W / window), nh,
                        reinterpret_cast<cudaStream_t>(stream));
}

// K7: x (nW, S, c) window rows, no pad key.
extern "C" int k7_window_block_bwd(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    void* xn, void* qkv, void* o, float* lse, void* dout, float* D, void* dqkv,
    void* dxn, void* dx, int nW, int S, int c, int nh, int residual,
    void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, S);
  ap.mode = 0; ap.S = S; ap.Sq = S;
  return attn_block_bwd(is_bf16, x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, xn,
                        qkv, o, lse, dout, D, dqkv, dxn, dx, (long long)nW * S,
                        c, residual, ap, nW, nh,
                        reinterpret_cast<cudaStream_t>(stream));
}
