// K9: the dx-only backward of the Hiera q-pool transition block
// (fused_transition.cu).

#include "attention_bwd.cuh"
#include "gemm_bwd.cuh"

// The 2x2 max-pool's backward of the shortcut: each pooled gradient gy
// (B, H/2, W/2, cout) goes to the first maximum (row-major) of its cell of
// the full-resolution shortcut projection sh (B, H, W, cout), channel by
// channel; the other three positions get zero. Written into columns
// [col0, col0 + cout) of rows of `ld` elements.
template <typename T>
__global__ void __launch_bounds__(256) unpool2x2_kernel(
    const T* __restrict__ sh, const T* __restrict__ gy, T* __restrict__ out,
    long long ld, int col0, int B, int H, int W, int cout) {
  const int half = cout / 2;
  const long long n = (long long)B * (H / 2) * (W / 2) * half;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const long long pr = i / half;                    // pooled row
  const int ch = (int)(i - pr * half) * 2;
  const int pw = W / 2, ph = H / 2;
  const long long b = pr / ((long long)ph * pw);
  const int rem = (int)(pr - b * ph * pw), pi = rem / pw, pj = rem - pi * pw;
  const float2 g = load2(gy + pr * cout + ch);
  long long rows[4];
  float2 cand[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rows[k] = (b * H + 2 * pi + (k >> 1)) * W + 2 * pj + (k & 1);
    cand[k] = load2(sh + rows[k] * cout + ch);
  }
  int a0 = 0, a1 = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (cand[k].x > cand[a0].x) a0 = k;
    if (cand[k].y > cand[a1].y) a1 = k;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    store2(out + rows[k] * ld + col0 + ch, k == a0 ? g.x : 0.f, k == a1 ? g.y : 0.f);
}

// The same one channel a thread, at an odd cout (the pairs above would
// straddle it) or bases a pair does not align with.
template <typename T>
__global__ void __launch_bounds__(256) unpool2x2_any_kernel(
    const T* __restrict__ sh, const T* __restrict__ gy, T* __restrict__ out,
    long long ld, int col0, int B, int H, int W, int cout) {
  const long long n = (long long)B * (H / 2) * (W / 2) * cout;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const long long pr = i / cout;                    // pooled row
  const int ch = (int)(i - pr * cout);
  const int pw = W / 2, ph = H / 2;
  const long long b = pr / ((long long)ph * pw);
  const int rem = (int)(pr - b * ph * pw), pi = rem / pw, pj = rem - pi * pw;
  const float g = to_f(gy[pr * cout + ch]);
  long long rows[4];
  float cand[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    rows[k] = (b * H + 2 * pi + (k >> 1)) * W + 2 * pj + (k & 1);
    cand[k] = to_f(sh[rows[k] * cout + ch]);
  }
  int a = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (cand[k] > cand[a]) a = k;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    out[rows[k] * ld + col0 + ch] = from_f<T>(k == a ? g : 0.f);
}

template <typename T>
static cudaError_t launch_unpool2x2(const void* sh, const void* gy, void* out,
                                   int B, int H, int W, int cout,
                                   cudaStream_t s) {
  const T* shp = reinterpret_cast<const T*>(sh);
  const T* gyp = reinterpret_cast<const T*>(gy);
  T* o = reinterpret_cast<T*>(out);
  const long long m2 = (long long)B * (H / 2) * (W / 2);
  const unsigned pair = 2 * sizeof(T);
  if (cout % 2 == 0 && aligned_to(sh, pair) && aligned_to(gy, pair)
      && aligned_to(out, pair)) {
    const long long n = m2 * (cout / 2);
    unpool2x2_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        shp, gyp, o, 4LL * cout, 3 * cout, B, H, W, cout);
  } else {
    const long long n = m2 * cout;
    unpool2x2_any_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        shp, gyp, o, 4LL * cout, 3 * cout, B, H, W, cout);
  }
  return cudaGetLastError();
}

// K9 replaces sam2unet_tpu/ops/pallas/fused_transition.py::
// _transition_bwd_kernel (launched by _transition_bwd_impl, :483): dx of K8
// for the frozen trunk, recomputed from x. Bound on an H100: the
// full-resolution products (QKV and shortcut recomputed, then
// [dqkv | dshort] @ [W_qkv; W_short]: 2 * 2 * cin * 4 * cout FLOPs per
// input token) are compute-bound. Design: the LN pass; QKV and the
// unpooled shortcut from the forward GEMM; the q-pooled attention again
// with its lse; dO = gy @ W_proj (row-major-B GEMM); attention_bwd.cuh's
// passes write dq (routed to each pooled query's first maximum, as
// max_pool2d's backward does; ties are common in bf16), dk, dv into the
// first 3 cout columns of a 4 cout-wide gradient buffer; the shortcut's
// pooled gradient goes the same way into the last cout columns; two
// row-major-B GEMMs give dLN(x): dqkv @ W_qkv, then dshort @ W_short plus
// it, each rounded to T as the plain version's two branch gradients are
// before they sum; the LN backward pass. The TPU kernel did the same per
// strip of windows in VMEM with the heads on its grid.
extern "C" int k9_transition_bwd(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    const void* w_short, const void* b_short, void* xn, void* qkv,
    void* shortcut, void* o, float* lse, void* dout, float* D, void* dcat,
    void* dxn, void* dx, int B, int H, int W, int cin, int cout, int nh,
    int window, void* stream) {
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
  ap.out = o; ap.lse = lse; ap.mode = 1; ap.S = window * window;
  ap.Sq = (window / 2) * (window / 2); ap.H = H; ap.W = W; ap.win = window;
  ap.qpool = 1;
  const int n_windows = B * (H / window) * (W / window);
  e = launch_attn_dt(is_bf16, ap, n_windows, nh, s);
  if (e != cudaSuccess) return (int)e;

  GemmParams g3 = {};
  g3.A = gy; g3.lda = cout; g3.W = w_proj;
  g3.C = dout; g3.ldc = cout; g3.M = M2; g3.N = cout; g3.K = cout;
  const GemmBwd nn = {1};
  e = launch_gemm_bwd_dt(is_bf16, g3, nn, s);
  if (e != cudaSuccess) return (int)e;
  AttnBwdParams bp = {};
  bp.a = ap; bp.o = o; bp.dout = dout; bp.lse = lse; bp.D = D;
  bp.dqkv = dcat; bp.ld = 4LL * cout;
  e = launch_attn_bwd_dt(is_bf16, bp, n_windows, nh, s);
  if (e != cudaSuccess) return (int)e;

  e = is_bf16 ? launch_unpool2x2<bf16>(shortcut, gy, dcat, B, H, W, cout, s)
              : launch_unpool2x2<float>(shortcut, gy, dcat, B, H, W, cout, s);
  if (e != cudaSuccess) return (int)e;

  GemmParams g4 = {};
  g4.A = dcat; g4.lda = 4LL * cout; g4.W = w_qkv;
  g4.C = dxn; g4.ldc = cin; g4.M = M; g4.N = cin; g4.K = 3 * cout;
  e = launch_gemm_bwd_dt(is_bf16, g4, nn, s);
  if (e != cudaSuccess) return (int)e;
  GemmParams g5 = g4;
  g5.A = static_cast<const char*>(dcat) + 3LL * cout * (is_bf16 ? sizeof(bf16) : sizeof(float));
  g5.W = w_short; g5.K = cout; g5.R = dxn; g5.ldr = cin;
  e = launch_gemm_bwd_dt(is_bf16, g5, nn, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(is_bf16, x, ln_w, dxn, nullptr, dx, M, cin, s);
}
