// K7 in its weight-gradient mode: dx and every weight gradient of the Hiera
// attention block LN1 -> QKV -> window attention -> proj -> +x on (nW, S, c)
// window rows without a pad key, for a cotangent gy.
//
// Replaces sam2unet_tpu/ops/pallas/fused_attention_block.py::_bwd_kernel
// (launched by _fused_window_block_bwd_impl, :669) with weight_grads=True:
// the trainable trunk's windowed blocks where the JAX gate `_bwd`
// (:1945-1991) takes the kernel (16 c^2 <= 8 MiB and one window's live set
// <= 4 MiB: hiera_l@352 stage 3's pad-free 16x16 groups, hiera_s@960 stage
// 3's 56x56 group, hiera_s's 256-token global blocks at 256 px).
//
// Bound on an H100: the dx-only products and attention of K7
// (fused_attention_block_bwd.cu) plus the two weight-gradient products,
// dW_proj = gy^T o (2 c^2 FLOPs a token) and dW_qkv = dqkv^T LN(x) (6 c^2);
// compute-bound at every trunk width.
//
// Design: the dx-only K7 (attention_block_bwd.cuh) runs first and leaves
// its buffers: LN(x), qkv, o, dO, dqkv and dLN(x), each in T as the plain
// version rounds them. The TPU kernel accumulated per-head fp32 weight
// gradients in VMEM across its sequential grid; here the weight gradients
// are fp32 reductions over all nW * S rows of those buffers, in fixed
// 256-row chunks summed in chunk order afterwards (gemm_bwd.cuh's
// `launch_wgrad_dt`, K3's reduction; no atomics, so the gradients are the
// same from run to run): dW_proj = gy^T o with db_proj = sum gy, dW_qkv =
// dqkv^T LN(x) with db_qkv = sum dqkv, and a pass of its own for LN's
// parameters, dln_w = sum dLN(x) * xhat and dln_b = sum dLN(x), xhat from
// row statistics recomputed from x (at widths that are not a multiple of 8
// or past 2048, gemm_any.cu's statistics pass; the column sums read element
// by element at any width). A translation unit of its own, so that the
// other kernels' builds (and their register counts) stay as they were.

#include "attention_block_bwd.cuh"

// mu[row], rs[row]: the row statistics of LN(x) as ln_rows_kernel computes
// them (fp32, two passes); one warp per row.
template <typename T>
__global__ void __launch_bounds__(256) ln_stats_kernel(
    const T* __restrict__ x, float* __restrict__ mu, float* __restrict__ rs,
    long long M, int K) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nv = K / 8;
  const T* xr = x + row * K;
  float f[LN_MAXV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    const int v = lane + 32 * i;
    if (v < nv) {
      v8_to_floats(v8_load(xr + v * 8), f[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[i][e];
    }
  }
  const float m = warp_sum(s) / K;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < LN_MAXV; ++i) {
    if (lane + 32 * i < nv) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float d = f[i][e] - m;
        var += d * d;
      }
    }
  }
  const float r = rsqrtf(warp_sum(var) / K + 1e-6f);
  if (lane == 0) {
    mu[row] = m;
    rs[row] = r;
  }
}

// part_w[chunk][col] = sum over the chunk's rows of dy * xhat, part_b the
// same of dy; a thread per column, so each row is read coalesced.
template <typename T>
__global__ void __launch_bounds__(256) ln_wgrad_partial_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mu, const float* __restrict__ rs,
    float* __restrict__ part_w, float* __restrict__ part_b, long long M,
    int K) {
  const int col = blockIdx.x * 256 + threadIdx.x;
  const int chunk = blockIdx.y;
  if (col >= K) return;
  const long long r0 = (long long)chunk * WG_ROWS;
  const long long r1 = min(r0 + WG_ROWS, M);
  float sw = 0.f, sb = 0.f;
  for (long long m = r0; m < r1; ++m) {
    const float g = to_f(dy[m * K + col]);
    sw = fmaf(g, (to_f(x[m * K + col]) - mu[m]) * rs[m], sw);
    sb += g;
  }
  part_w[(long long)chunk * K + col] = sw;
  part_b[(long long)chunk * K + col] = sb;
}

template <typename T>
static cudaError_t launch_ln_wgrad(const void* x, const void* dy, float* dw,
                                   float* db, float* ws, long long M, int K,
                                   cudaStream_t s) {
  const long long chunks = wgrad_chunks(M);
  float* mu = ws;
  float* rs = mu + M;
  float* part_w = rs + M;
  float* part_b = part_w + chunks * K;
  if (ln_vec16(K, {x})) {
    ln_stats_kernel<T><<<(unsigned)((M + 7) / 8), 256, 0, s>>>(
        reinterpret_cast<const T*>(x), mu, rs, M, K);
  } else {   // any other width or base: gemm_any.cu
    const cudaError_t e = (cudaError_t)gany_ln_stats(
        std::is_same<T, bf16>::value, x, mu, rs, M, K, s);
    if (e != cudaSuccess) return e;
  }
  ln_wgrad_partial_kernel<T>
      <<<dim3((K + 255) / 256, (unsigned)chunks), 256, 0, s>>>(
          reinterpret_cast<const T*>(x), reinterpret_cast<const T*>(dy), mu,
          rs, part_w, part_b, M, K);
  wgrad_reduce_kernel<<<(K + 255) / 256, 256, 0, s>>>(part_w, dw, K,
                                                       (int)chunks);
  wgrad_reduce_kernel<<<(K + 255) / 256, 256, 0, s>>>(part_b, db, K,
                                                       (int)chunks);
  return cudaGetLastError();
}

// x, gy (nW, S, c); the dx-only K7's buffers; `ws` holds
// max(chunks * (3c^2 + 3c), 2 M + 2 chunks c) floats (M = nW * S rows,
// chunks of 256 rows); the gradients fp32 in the torch layouts: dw_qkv
// (3c, c), db_qkv (3c), dln_w / dln_b (c), dw_proj (c, c), db_proj (c).
extern "C" int k7_window_block_bwd_wgrad(
    int is_bf16, const void* x, const void* gy, const void* w_qkv,
    const void* b_qkv, const void* ln_w, const void* ln_b, const void* w_proj,
    void* xn, void* qkv, void* o, float* lse, void* dout, float* D, void* dqkv,
    void* dxn, void* dx, float* ws, float* dw_qkv, float* db_qkv,
    float* dln_w, float* dln_b, float* dw_proj, float* db_proj, int nW, int S,
    int c, int nh, int residual, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)nW * S;
  AttnParams ap = {};
  attn_on_qkv(ap, is_bf16, qkv, c, nh, S);
  ap.mode = 0; ap.S = S; ap.Sq = S;
  int err = attn_block_bwd(is_bf16, x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                           xn, qkv, o, lse, dout, D, dqkv, dxn, dx, M, c,
                           residual, ap, nW, nh, s);
  if (err) return err;
  cudaError_t e = launch_wgrad_dt(is_bf16, gy, o, dw_proj, db_proj, ws, M, c,
                                  c, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_wgrad_dt(is_bf16, dqkv, xn, dw_qkv, db_qkv, ws, M, 3 * c, c, s);
  if (e != cudaSuccess) return (int)e;
  return (int)(is_bf16 ? launch_ln_wgrad<bf16>(x, dxn, dln_w, dln_b, ws, M, c, s)
                       : launch_ln_wgrad<float>(x, dxn, dln_w, dln_b, ws, M, c, s));
}
