// K11's dq and dk/dv passes in bf16 on Hopper's asynchronous path: warpgroup
// products (wgmma) fed by TMA through shared-memory rings.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_bwd_dq_kernel
// (:219, launched by _stream_bwd_impl at :314) and ::_stream_bwd_dkv_kernel
// (:254, launched at :336) where the call is bf16, d % 8 == 0 up to 256, and
// every view allows a tensor map (16-byte bases, strides in multiples of 8
// elements: `_bwd_library` in ops/flash_attention.py). The delta pass and
// every other call stay in csrc/flash_attention_bwd.cu (fp32) and
// csrc/attention_any_bwd.cu (other head dims and views).
//
// Bound on an H100: the dq pass forms S, dP and dQ, 6 S_q S_k d operations
// per (batch, head), the dk/dv pass S^T, dP^T, dV and dK, 8 S_q S_k d,
// against ~5 S d and ~6 S d elements moved: at S 3600 or 4096 the tensor
// cores bound both. So the products run on wgmma, whose operands come
// from shared memory (both for the scores) or from registers (the rounded
// P^T and dS, straight from the accumulator of the product before), and
// TMA keeps the streamed tiles arriving while the products run.
//
// Design (the building blocks and fragment layouts in hopper.cuh; the
// kernels in flash_attention_bwd_sm90.cuh). Each block has three
// warpgroups: two consumers of 64 rows each and a producer,
// whose first thread issues the TMA loads (resident rows once, then the
// streamed 64-row tiles through a two-stage ring, each stage with a full
// and an empty mbarrier) and whose registers setmaxnreg hands to the
// consumers. Instances at d padded to 64, 96, 128 and 256; a head dim
// between them reads its last 64-column atom zero-filled past d, which adds
// nothing to any product, and the epilogue writes only the d columns (the
// dqkv views are neighbouring channel blocks of one buffer).
//   dq: one block per (batch, head, 128 queries): Q and dO resident, K and
//     V streamed; S = Q K^T and dP = dO V^T with both operands K-major in
//     shared memory, P = exp2(S scale log2(e) - lse log2(e)) (keys past S_k
//     get P = 0), dS = P (dP - D) rounded to bf16 in registers as the A of
//     dQ += dS K (K MN-major); dQ scaled once at the end.
//   dk/dv: one block per (batch, head, 128 keys): K and V resident, Q, dO
//     and the rows' lse log2(e) and D streamed (the producer's first warp
//     writes those two rows into the stage beside the TMA loads; a query
//     past S_q gets lse +inf, so P = 0); S^T = K Q^T, P^T rounded to bf16
//     drives dV += P^T dO on the tensor cores while dP^T = V dO^T's result
//     forms dS^T = P^T (dP^T - D), which drives dK += dS^T Q.
//   At d 256 one warpgroup cannot hold two 64 x 256 fp32 accumulators, and
//   128 rows of two resident tensors would not fit shared memory beside the
//   ring: a block takes 64 rows, both warpgroups form the same scores (the
//   products over d are a third of the pass's work, done twice) and each
//   keeps half the output columns, so no partial sum crosses warpgroups and
//   each pass stays one launch.
// P and dS are rounded to bf16 as the operands of the next product, as the
// Pallas kernels round them; every product accumulates in fp32. No atomics:
// each output row belongs to one block, and a repeated call gives the same
// bits. Each entry point returns the CUDA error of its launch.

#include "flash_attention_bwd_sm90.cuh"

using namespace hopper;
using namespace k11;

namespace {

// ------------------------------------------------------------ launchers

template <int D> int smem_bytes() { return Shape<D>::SMEM; }

int smem_of(int d) {
  switch (padded_head_dim(d)) {
    case 64: return smem_bytes<64>();
    case 96: return smem_bytes<96>();
    case 128: return smem_bytes<128>();
    default: return smem_bytes<256>();
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 384, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_pass(bool dkv, Params& p, const void* q, const void* k, const void* v,
                        const void* dout, int B, const long long* qs, const long long* kvs,
                        const long long* dos, cudaStream_t stream) {
  using S = Shape<D>;
  long long sq[3] = {qs[0], qs[1], qs[2]}, skv[3] = {kvs[0], kvs[1], kvs[2]},
            sdo[3] = {dos[0], dos[1], dos[2]};
  map_strides(sq, B, p.nh, p.d, p.Sq);
  map_strides(sdo, B, p.nh, p.d, p.Sq);
  map_strides(skv, B, p.nh, p.d, p.Sk);
  const int q_rows = dkv ? 64 : S::ROWS, kv_rows = dkv ? S::ROWS : 64;
  if (!tensor_map_bshd(&p.q, q, B, p.Sq, p.nh, p.d, sq[0], sq[1], sq[2], q_rows)
      || !tensor_map_bshd(&p.dout, dout, B, p.Sq, p.nh, p.d, sdo[0], sdo[1], sdo[2], q_rows)
      || !tensor_map_bshd(&p.k, k, B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], kv_rows)
      || !tensor_map_bshd(&p.v, v, B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], kv_rows))
    return cudaErrorInvalidValue;
  const dim3 grid(((dkv ? p.Sk : p.Sq) + S::ROWS - 1) / S::ROWS, p.nh, B);
  return dkv ? launch(k11_dkv_sm90_kernel<D>, grid, S::SMEM, stream, p)
             : launch(k11_dq_sm90_kernel<D>, grid, S::SMEM, stream, p);
}

int run_pass(bool dkv, int is_bf16, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* D, void* o0, void* o1, int B,
             int Sq, int Sk, int nh, int d, const long long* qs, const long long* kvs,
             const long long* dos, const long long* outs, float scale, void* stream) {
  if (!is_bf16 || d < 8 || d > 256 || B < 1 || B > 65535 || nh < 1 || nh > 65535 || Sq < 1
      || Sk < 1
      || !views_vec16(d, {qs[0], qs[1], qs[2], kvs[0], kvs[1], kvs[2], dos[0], dos[1], dos[2],
                          outs[0], outs[1], outs[2]},
                      {q, k, v, dout, o0, dkv ? o1 : o0}))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.lse = lse;
  p.D = D;
  p.dq = static_cast<bf16*>(o0);
  p.dk = static_cast<bf16*>(o0);
  p.dv = static_cast<bf16*>(o1);
  p.o_sb = outs[0]; p.o_ss = outs[1]; p.o_sh = outs[2];
  p.Sq = Sq; p.Sk = Sk; p.nh = nh; p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 64: return (int)launch_pass<64>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    case 96: return (int)launch_pass<96>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    case 128: return (int)launch_pass<128>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    default: return (int)launch_pass<256>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
  }
}

}  // namespace

// dq (B, Sq, heads, d), written through its strides; the arguments of
// k11_flash_attention_bwd_dq (csrc/flash_attention_bwd.cu), bf16 only.
extern "C" int k11_flash_attention_bwd_dq_sm90(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dq, int B, int Sq, int Sk, int nh, int d,
    long long q_sb, long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh},
                  dos[3] = {do_sb, do_ss, do_sh}, outs[3] = {dq_sb, dq_ss, dq_sh};
  return run_pass(false, is_bf16, q, k, v, dout, lse, D, dq, nullptr, B, Sq, Sk, nh, d, qs,
                  kvs, dos, outs, scale, stream);
}

// dk and dv (B, Sk, heads, d), both written through the same strides.
extern "C" int k11_flash_attention_bwd_dkv_sm90(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dk, void* dv, int B, int Sq, int Sk, int nh,
    int d, long long q_sb, long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long do_sb, long long do_ss, long long do_sh, long long dkv_sb,
    long long dkv_ss, long long dkv_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh},
                  dos[3] = {do_sb, do_ss, do_sh}, outs[3] = {dkv_sb, dkv_ss, dkv_sh};
  return run_pass(true, is_bf16, q, k, v, dout, lse, D, dk, dv, B, Sq, Sk, nh, d, qs, kvs,
                  dos, outs, scale, stream);
}

// The dynamic shared memory, in bytes, of the instance head dim d runs on
// (both passes size the block alike).
extern "C" int k11_flash_attention_bwd_sm90_smem(int d) { return smem_of(d); }
