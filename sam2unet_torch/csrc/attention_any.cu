// The forward of attention.cuh's kernel at any head dim (attention_any_fwd.cuh):
// K4, K6, K8, K10 and K12's attention where the head dim is not a multiple
// of 8, is above 96, or a view's strides or base do not allow 16-byte
// vectors, K6's masked mode there (form 1) and K14's two passes (form 2).
//
// Replaces, at those head dims, the attention inside
// sam2unet_tpu/ops/pallas/fused_attention_block.py::_strip_kernel (launched
// by _fused_strips_fwd_impl, :1021), ::_kernel (_fused_window_block_fwd_impl,
// :354), ::_strip_rem_kernel (_fused_strips_rem_fwd_impl, :1566),
// fused_transition.py::_transition_kernel (_fused_transition_fwd_impl, :256)
// and flash_attention.py::_stream_fwd_kernel (_stream_fwd_impl, :190) and
// ::_kernel (_fused_full, :93, K14): the JAX kernels take any head dim (the
// package's own tests run the window family at d = 12).
//
// A library of its own, loaded before the others with its symbols global:
// attention.cuh's launcher and full_attention.cu call `attn_any_fwd` from
// each of their libraries, so their own instances build exactly as before
// and these build once, in parallel with them.

#include "attention_any_fwd.cuh"

extern "C" int attn_any_fwd(int is_bf16, int form, const AttnParams* p,
                            int n_windows, int n_heads, cudaStream_t stream) {
  switch (form) {
    case 0:
      return (int)(is_bf16 ? launch_attn_any<bf16, 0>(*p, n_windows, n_heads, stream)
                           : launch_attn_any<float, 0>(*p, n_windows, n_heads, stream));
    case 1:
      return (int)(is_bf16 ? launch_attn_any<bf16, 1>(*p, n_windows, n_heads, stream)
                           : launch_attn_any<float, 1>(*p, n_windows, n_heads, stream));
    case 2:
      return (int)(is_bf16 ? launch_attn_any<bf16, 2>(*p, n_windows, n_heads, stream)
                           : launch_attn_any<float, 2>(*p, n_windows, n_heads, stream));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
