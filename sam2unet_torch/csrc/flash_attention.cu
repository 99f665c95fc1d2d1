// K10: streaming flash attention over (B, S, heads, d), with the
// log-sum-exp of each query's scaled scores.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (launched by _stream_fwd_impl, :190). Runs in the long global-attention
// blocks (S = 3600 at hiera_s@960), where the whole-block kernel's S x S
// scores do not fit on chip (fused_attention_block.py:298-309, :245-251).
//
// Bound on an H100: 4*S_q*S_k*d FLOPs per (batch, head) against 4*S*d
// elements moved, so at S = 3600 it is bound by operations.
//
// Design: the device loop of attention.cuh in rows mode, one block per
// (batch, head, 64 queries), keys and values streamed in 64-token tiles
// with the online softmax in registers. q, k and v are strided views (in
// the model, channel slices of the QKV output, rows of 3c), so no copy is
// made; the output is written contiguous (B, S_q, heads, d) and the lse
// (B*heads, S_q) in fp32. The TPU kernel needs block sizes that divide S
// (_pick_stream_blocks); here the ragged last key tile is zero-filled and
// masked, so any S works.

#include "attention.cuh"

extern "C" int k10_flash_attention(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int Sq, int Sk, int nh, int d, long long q_sb,
    long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, float scale, void* stream) {
  AttnParams ap = {};
  ap.q = q; ap.k = k; ap.v = v;
  ap.q_sb = q_sb; ap.q_ss = q_ss; ap.q_sh = q_sh;
  ap.kv_sb = kv_sb; ap.kv_ss = kv_ss; ap.kv_sh = kv_sh;
  ap.out = o; ap.lse = lse; ap.pad_bias = nullptr;
  ap.c = nh * d; ap.d = d; ap.mode = 0; ap.S = Sk; ap.Sq = Sq;
  ap.scale = scale;
  return (int)launch_attn_dt(is_bf16, ap, B, nh,
                             reinterpret_cast<cudaStream_t>(stream));
}
