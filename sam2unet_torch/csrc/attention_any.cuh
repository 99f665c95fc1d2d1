// The attention backward at any head dim: its parameters and the C entry
// points of attention_any_bwd.cu (the unmasked form: K5, K7, K7's
// weight-gradient mode, K9 and K11) and attention_any_bwd_pad.cu (K7's
// masked mode and K13's remainder grid), libraries of their own loaded
// before the others with their symbols global. attention_bwd.cuh and
// flash_attention_bwd.cu call them where the head dim is not a multiple of
// 8, is above 96, or a view's strides or base do not allow 16-byte vectors.
#pragma once

#include "attention.cuh"

// Every operand is addressed as attention.cuh addresses q / k / v: in rows
// mode (mode 0) element (window or batch wi, token t, head h) of X lies at
// X + wi * X_sb + t * X_ss + h * X_sh; in grid mode (mode 1) at X + row *
// X_ss + h * X_sh, its row found by the window geometry (q / k / v and dq /
// dk / dv: the token grid's rows; dO, o and D: the output grid's rows). The
// lse is (windows * heads, a.Sq) as the forward wrote it.
struct AnyBwdParams {
  AttnParams a;                         // q / k / v, geometry, pad key or mask
  const void* o;                        // the forward's output (delta pass)
  long long o_sb, o_ss, o_sh;
  const void* dout;                     // dO
  long long do_sb, do_ss, do_sh;
  const float* lse;
  float* D;                             // rowsum(dO o), fp32
  long long D_sb, D_ss, D_sh;
  void *dq, *dk, *dv;
  long long dq_sb, dq_ss, dq_sh;
  long long dkv_sb, dkv_ss, dkv_sh;     // dk and dv
};

// D = rowsum(dO o) for B x T rows of nh heads (row t of entry b at
// b * X_sb + t * X_ss of o, dO and D).
extern "C" int attn_any_bwd_delta(int is_bf16, const AnyBwdParams* p, int B,
                                  long long T, int nh, cudaStream_t stream);
// The dq pass (dkv = 0) or the dk/dv pass (dkv = 1), unmasked, no pad key.
extern "C" int attn_any_bwd(int is_bf16, int dkv, const AnyBwdParams* p,
                            int n_windows, int nh, cudaStream_t stream);
// The same with a pad key: masked rows (masked = 1, rows mode) or K12's
// remainder grid (masked = 0, grid mode on any grid).
extern "C" int attn_any_bwd_pad(int is_bf16, int masked, int dkv,
                                const AnyBwdParams* p, int n_windows, int nh,
                                cudaStream_t stream);
