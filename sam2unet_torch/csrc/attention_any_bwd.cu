// The attention backward at any head dim (attention_any_bwd.cuh), unmasked
// and without a pad key: the delta, dq and dk/dv passes of K5, K7 (dx-only
// and its weight-gradient mode), K9 and K11 where the head dim is not a
// multiple of 8, is above 96 (K11 at the video memory attention's 256 among
// them), or a view's strides or base do not allow 16-byte vectors.
//
// Replaces, at those head dims, the attention backward inside
// sam2unet_tpu/ops/pallas/fused_attention_block.py::_strip_bwd_kernel
// (launched by _fused_strips_bwd_impl, :1082), ::_bwd_kernel
// (_fused_window_block_bwd_impl, :669), fused_transition.py::
// _transition_bwd_kernel (_transition_bwd_impl, :483), and
// flash_attention.py::_stream_bwd_dq_kernel / _stream_bwd_dkv_kernel
// (_stream_bwd_impl, :314, :336) with its delta (:306). The JAX kernels take
// any head dim; the Pallas VJPs gate only on live bytes.
//
// Bound on an H100: as the kernels it stands in for (seven S x S x d
// products per (window, head)); the scores and dP are formed once per
// 64-wide output chunk, ceil(d / 64) times over.
//
// A library of its own, loaded before the others with its symbols global,
// so the callers' own instances build as before (attention_any.cuh).

#include "attention_any_bwd.cuh"

extern "C" int attn_any_bwd_delta(int is_bf16, const AnyBwdParams* p, int B,
                                  long long T, int nh, cudaStream_t stream) {
  if (B < 1 || T < 1 || nh < 1 || p->a.d < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * T * nh;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (is_bf16)
    any_delta_kernel<bf16><<<blocks, 256, 0, stream>>>(*p, T, nh, n);
  else
    any_delta_kernel<float><<<blocks, 256, 0, stream>>>(*p, T, nh, n);
  return (int)cudaGetLastError();
}

extern "C" int attn_any_bwd(int is_bf16, int dkv, const AnyBwdParams* p,
                            int n_windows, int nh, cudaStream_t stream) {
  return (int)launch_any_bwd<0>(is_bf16, dkv != 0, *p, n_windows, nh, stream);
}
