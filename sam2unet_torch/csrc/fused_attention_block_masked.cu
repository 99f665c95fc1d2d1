// K6 and K7 in their masked whole-grid mode: the Hiera attention block LN1
// -> QKV -> window attention -> proj -> +x and its dx-only backward on a
// whole small grid of S = H*W tokens a row.
//
// K6 masked replaces sam2unet_tpu/ops/pallas/fused_attention_block.py::
//    _kernel (launched by _fused_window_block_fwd_impl, :354) with
//    `attn_mask` and `pad_logmult`; K7 masked replaces ::_bwd_kernel
//    (launched by _fused_window_block_bwd_impl, :669) there with
//    weight_grads=False. Entry: `fused_window_block(..., attn_mask=,
//    pad_logmult=)` with `grid_window_mask`'s mask: one call over a whole
//    grid in place of the valid groups' four.
//
// Bound on an H100: as K6 / K7 (the QKV and proj products, 8 c^2 FLOPs a
// token, compute-bound at c >= 288), but the attention spans the whole S x
// S of scores the mask covers, 4 * S * c FLOPs a token forward (S 484 at
// hiera_l@352's stage 3: about as much as the products at c = 576).
//
// Design: the TPU kernel added the (S, S) mask to a window group's score
// matrix in VMEM and the per-query log-multiplicity to the pad key's
// logit. Here the attention kernels of attention.cuh / attention_bwd.cuh
// in their MASKED template instance add mask[t][k] to each score of the
// 64-key tiles they stream (the mask, at most 1 MB in fp32, is shared by
// every row and stays in L2) and logmult[t] to the pad key's logit, so the
// other kernels keep their code; masked-out scores are -1e30 and weigh
// exactly 0 once a row's running max reaches one of its window's keys. The
// library of its own keeps these instances out of the other sources'
// builds, which run in parallel with it.

#include "attention_block.cuh"
#include "attention_block_bwd.cuh"

// K6 masked: x (nW, S, c), each row a whole grid; `mask` (S, S) and
// `logmult` (S) fp32.
extern "C" int k6_window_block_masked(
    int is_bf16, const void* x, const void* w_qkv, const void* b_qkv,
    const void* ln_w, const void* ln_b, const void* w_proj, const void* b_proj,
    const float* mask, const float* logmult, void* xn, void* qkv, void* o,
    void* out, int nW, int S, int c, int nh, int residual, void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, S);
  ap.out = o; ap.pad_bias = b_qkv; ap.mask = mask; ap.logmult = logmult;
  ap.mode = 0; ap.S = S; ap.Sq = S;
  return attn_block<true>(is_bf16, x, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                          b_proj, xn, qkv, o, out, (long long)nW * S, c,
                          residual, ap, nW, nh,
                          reinterpret_cast<cudaStream_t>(stream));
}

// K7 masked: dx of K6 masked for a cotangent gy, the weights frozen.
extern "C" int k7_window_block_bwd_masked(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    const float* mask, const float* logmult, void* xn, void* qkv, void* o,
    float* lse, void* dout, float* D, void* dqkv, void* dxn, void* dx, int nW,
    int S, int c, int nh, int residual, void* stream) {
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, S);
  ap.pad_bias = b_qkv; ap.mask = mask; ap.logmult = logmult;
  ap.mode = 0; ap.S = S; ap.Sq = S;
  return attn_block_bwd<true>(is_bf16, x, gy, w_qkv, b_qkv, ln_w, ln_b,
                              w_proj, xn, qkv, o, lse, dout, D, dqkv, dxn, dx,
                              (long long)nW * S, c, residual, ap, nW, nh,
                              reinterpret_cast<cudaStream_t>(stream));
}
