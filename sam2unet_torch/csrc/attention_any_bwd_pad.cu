// The attention backward at any head dim (attention_any_bwd.cuh) with a pad
// key: K7's masked mode (rows of a whole small grid, the additive window
// mask and per-query log-multiplicity) and K13's remainder grid (edge
// windows with a pad key of their own n_pad), where the head dim is not a
// multiple of 8 or is above 96.
//
// Replaces, at those head dims, the attention backward inside
// sam2unet_tpu/ops/pallas/fused_attention_block.py::_bwd_kernel
// (_fused_window_block_bwd_impl, :669) with `attn_mask`, and
// ::_strip_rem_bwd_kernel / _strip_rem_bwd_kernel_jw
// (_fused_strips_rem_bwd_impl, :1651; _fused_strips_rem_bwd_jw_impl,
// :1843). A library of its own, as attention_any_bwd.cu.

#include "attention_any_bwd.cuh"

extern "C" int attn_any_bwd_pad(int is_bf16, int masked, int dkv,
                                const AnyBwdParams* p, int n_windows, int nh,
                                cudaStream_t stream) {
  return (int)(masked ? launch_any_bwd<1>(is_bf16, dkv != 0, *p, n_windows, nh, stream)
                      : launch_any_bwd<2>(is_bf16, dkv != 0, *p, n_windows, nh, stream));
}
