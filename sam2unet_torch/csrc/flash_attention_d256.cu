// K10 at head dim 256: streaming flash attention over (B, S, heads, 256),
// with the log-sum-exp of each query's scaled scores.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (launched by _stream_fwd_impl, :190) at the head dim of SAM2's memory
// attention: its self-attention runs one head of 256 over the 64 x 64 =
// 4096 tokens of a 1024-px frame (sam2unet_tpu/models/memory.py:167-170),
// four times per tracked frame, in fp32. The head dims of the trunks (up to
// 96) stay in flash_attention.cu, which this file leaves as it was built.
//
// Bound on an H100: 4*S_q*S_k*256 operations per (batch, head) against
// 4*S*256 elements moved, so at S = 4096 it is bound by operations.
//
// Design: one block per (batch, head, 64 queries), four warps of 16 query
// rows, CUDA-core dot products in fp32 (the comparison path; bf16 runs
// csrc/flash_attention_fwd_sm90.cu); keys and values stream through a
// two-slot cp.async ring of 32-key tiles; the online softmax runs in
// registers, as in attention.cuh, and P is staged through shared memory.
// Shared memory: q 64 x 264, the ring 2 x (K, V) x 32 x 264 and the P tile,
// 206 KB. q, k and v are strided views (unit stride over d); the output is
// contiguous (B, S_q, heads, 256), the lse (B*heads, S_q) fp32. Any S_k:
// the ragged last key tile is zero-filled and masked.

#include "common.cuh"

namespace {

constexpr int D = 256, LDS = D + 8, NDT = D / 8, BQ = 64, BKV = 32;

struct D256Params {
  const void *q, *k, *v;
  void* out;
  float* lse;
  long long q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh;
  int Sq, Sk;
  float scale;
};

constexpr size_t smem_bytes() {
  return sizeof(float) * (LDS * (BQ + 4 * BKV) + BQ * BKV);   // Q, 2 x (K, V), P
}

__global__ void __launch_bounds__(128) k10_d256_kernel(D256Params p) {
  constexpr int CH = 16 / sizeof(float), NCH = D / CH, NJ = BKV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // BQ x LDS
  float* Ks = Qs + BQ * LDS;                    // [2][BKV][LDS]
  float* Vs = Ks + 2 * BKV * LDS;               // [2][BKV][LDS]
  float* Ps = Vs + 2 * BKV * LDS;               // BQ x BKV

  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int S = p.Sk, Sq = p.Sq;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.kv_sb + h * p.kv_sh;

  for (int idx = tid; idx < BQ * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), ch = (idx - r * (D / 8)) * 8, t = q0 + r;
    v8_store(Qs + r * LDS + ch,
             t < Sq ? v8_load(qb + (long long)t * p.q_ss + ch) : v8_zero<float>());
  }
  auto load_kv = [&](int buf, int kt) {
    for (int idx = tid; idx < BKV * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * BKV + r;
      const bool valid = t < S;
      const long long off = valid ? (long long)t * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * BKV + r) * LDS + ch, kb + off, valid);
      cp_async16(Vs + (buf * BKV + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (S + BKV - 1) / BKV;
  load_kv(0, 0);
  cp_async_commit();

  // running max / sum of rows g and g + 8; output columns f*8 + q2 + {0, 1}
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_kv(buf ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and at kt = 0 the Q tile) in place
    const float* ks = Ks + buf * BKV * LDS;
    const float* vs = Vs + buf * BKV * LDS;

    // scores of 16 rows x BKV keys: s[j][e] is row g + 8*(e/2), key
    // j*8 + q2 + e%2
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* qr = Qs + (warp * 16 + g + 8 * (e >> 1)) * LDS;
        const float* kr = ks + (j * 8 + q2 + (e & 1)) * LDS;
        float acc = 0.f;
        for (int ch = 0; ch < D; ++ch) acc = fmaf(qr[ch], kr[ch], acc);
        s[j][e] = acc;
      }

    // online softmax: keys past S masked; the four lanes of a row agree
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const int key = kt * BKV + j * 8 + q2 + (e & 1);
          const float v = key < S ? s[j][e] * p.scale : -INFINITY;
          s[j][e] = v;
          mx = fmaxf(mx, v);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx);   // finite: tile 0 holds key 0
      const float alpha = expf(m[hh] - mn);
      m[hh] = mn;
      l[hh] *= alpha;
#pragma unroll
      for (int f = 0; f < NDT; ++f) {
        o[f][2 * hh] *= alpha;
        o[f][2 * hh + 1] *= alpha;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float pv = expf(s[j][e] - mn);
          s[j][e] = pv;
          l[hh] += pv;
        }
    }

    // O += P V
    float* pw = Ps + warp * 16 * BKV;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[(g + 8 * (e >> 1)) * BKV + j * 8 + q2 + (e & 1)] = s[j][e];
    __syncwarp();
#pragma unroll
    for (int f = 0; f < NDT; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = pw + (g + 8 * (e >> 1)) * BKV;
        const int col = f * 8 + q2 + (e & 1);
        float acc = 0.f;
        for (int k = 0; k < BKV; ++k) acc = fmaf(pr[k], vs[k * LDS + col], acc);
        o[f][e] += acc;
      }
    __syncwarp();
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }

  // normalise, store; the lse
  float* out = reinterpret_cast<float*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    float* orow = out + (((long long)b * Sq + t) * gridDim.y + h) * D;
    const float inv = 1.f / den;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
      store2(orow + f * 8 + q2, o[f][2 * hh] * inv, o[f][2 * hh + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[((long long)b * gridDim.y + h) * Sq + t] = m[hh] + logf(den);
  }
}

cudaError_t launch(const D256Params& p, int B, int nh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      k10_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, nh, (p.Sq + BQ - 1) / BQ);
  k10_d256_kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k10_flash_attention_d256(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int Sq, int Sk, int nh, int d, long long q_sb,
    long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, float scale, void* stream) {
  if (is_bf16 || d != D || B < 1 || Sq < 1 || Sk < 1 || nh > 65535
      || (Sq + BQ - 1) / BQ > 65535
      || !views_vec16(d, {q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh}, {q, k, v, o}))
    return (int)cudaErrorInvalidValue;   // fp32, 16-byte loads: aligned views only
  const D256Params p = {q, k, v, o, lse, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                        kv_sh, Sq, Sk, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch(p, B, nh, s);
}
