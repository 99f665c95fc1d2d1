// K14 at head dim 256: attention over the whole key row,
// softmax(q k^T * scale) v, for (B, S, heads, 256) tensors with at most
// 1024 keys.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_kernel (launched by
// _fused_full, :78-113) at the head dim of SAM2's memory attention: under
// the JAX package's "pallas" attention backend every unmasked attention
// over at most 1024 keys goes to it (`_dispatch_fwd`, :432-443), and the
// memory attention's self-attention runs one head of 256 over the 32 x 32
// = 1024 tokens of a 512-px frame (sam2unet_tpu/models/memory.py:167-170),
// four times per tracked frame, in fp32. The head dims up to 96 stay in
// full_attention.cu, which this file leaves as it was built.
//
// What it computes, as the TPU kernel does: fp32 scores q.k * scale, the
// row maximum m, e = exp(s - m), p = e / sum(e) in fp32, p rounded to the
// working type, o = p v accumulated in fp32 and rounded once.
//
// Bound on an H100: 4*Sq*Sk*256 operations per (batch, head) against
// (2*Sq + 2*Sk)*256 elements moved, so at Sq = Sk = 1024 it is bound by
// operations.
//
// Design: one block per (batch, head, 64 queries), four warps of 16 query
// rows, CUDA-core dot products in fp32 (the comparison path; bf16 runs
// csrc/flash_attention_fwd_sm90.cu). Keys stream through a two-slot
// cp.async ring of 32-key tiles twice, K14's two-pass scheme
// (full_attention.cu):
//   pass 1: scores, the running maximum and sum of exp of each row (K only);
//   pass 2: the same scores again, p = exp(s - m) / sum, and O += P V with P
//           staged through shared memory and V from the ring.
// Shared memory: q 64 x 264, 2 x (K, V) x 32 x 264 and the P tile, 206 KB.
// q, k and v are strided views (unit stride over d); the output is
// contiguous (B, Sq, heads, 256). The ragged last key tile is zero-filled
// and masked; query rows past Sq are zero and not stored.

#include "common.cuh"

namespace {

constexpr int D = 256, LDS = D + 8, NDT = D / 8, BQ = 64, BKV = 32;

struct FullD256Params {
  const void *q, *k, *v;
  void* out;
  long long q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh;
  int Sq, Sk;
  float scale;
};

constexpr size_t smem_bytes() {
  return sizeof(float) * (LDS * (BQ + 4 * BKV) + BQ * BKV);   // Q, 2 x (K, V), P
}

__global__ void __launch_bounds__(128) k14_d256_kernel(FullD256Params p) {
  constexpr int CH = 16 / sizeof(float), NCH = D / CH, NJ = BKV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // BQ x LDS
  float* Ks = Qs + BQ * LDS;                    // [2][BKV][LDS]
  float* Vs = Ks + 2 * BKV * LDS;               // [2][BKV][LDS]
  float* Ps = Vs + 2 * BKV * LDS;               // BQ x BKV

  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int Sk = p.Sk, Sq = p.Sq;
  const float* qb = reinterpret_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = reinterpret_cast<const float*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const float* vb = reinterpret_cast<const float*>(p.v) + b * p.kv_sb + h * p.kv_sh;

  for (int idx = tid; idx < BQ * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), ch = (idx - r * (D / 8)) * 8, t = q0 + r;
    v8_store(Qs + r * LDS + ch,
             t < Sq ? v8_load(qb + (long long)t * p.q_ss + ch) : v8_zero<float>());
  }
  auto load_tile = [&](int buf, int kt, bool with_v) {
    for (int idx = tid; idx < BKV * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * BKV + r;
      const bool valid = t < Sk;
      const long long off = valid ? (long long)t * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * BKV + r) * LDS + ch, kb + off, valid);
      if (with_v) cp_async16(Vs + (buf * BKV + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (Sk + BKV - 1) / BKV;

  // scores of the warp's 16 rows x BKV keys of the tile at `ks`: s[j][e] is
  // row g + 8*(e/2), key j*8 + q2 + e%2, scaled; keys past Sk are -inf
  auto scores = [&](float (&s)[NJ][4], const float* ks, int kt) {
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
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * BKV + j * 8 + q2 + (e & 1);
        s[j][e] = key < Sk ? s[j][e] * p.scale : -INFINITY;
      }
  };

  // ---- pass 1: row maximum m and sum of exp(s - m) (rows g and g + 8; the
  // four lanes of a row share m and hold partial sums)
  load_tile(0, 0, false);
  cp_async_commit();
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_tile(buf ^ 1, kt + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and at kt = 0 the Q tile) in place
    float s[NJ][4];
    scores(s, Ks + buf * BKV * LDS, kt);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx);   // finite: tile 0 holds key 0
      float sum = l[hh] * expf(m[hh] - mn);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        sum += expf(s[j][2 * hh] - mn) + expf(s[j][2 * hh + 1] - mn);
      m[hh] = mn;
      l[hh] = sum;
    }
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    inv[hh] = 1.f / den;
  }

  // ---- pass 2: p = exp(s - m) / sum, O += P V
  float o[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.f;
  load_tile(0, 0, true);
  cp_async_commit();
  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_tile(buf ^ 1, kt + 1, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* vs = Vs + buf * BKV * LDS;
    float s[NJ][4];
    scores(s, Ks + buf * BKV * LDS, kt);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = expf(s[j][e] - m[e >> 1]) * inv[e >> 1];
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

  // ---- write the contiguous output
  float* out = reinterpret_cast<float*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    float* orow = out + (((long long)b * Sq + t) * gridDim.y + h) * D;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
      store2(orow + f * 8 + q2, o[f][2 * hh], o[f][2 * hh + 1]);
  }
}

cudaError_t launch(const FullD256Params& p, int B, int nh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      k14_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, nh, (p.Sq + BQ - 1) / BQ);
  k14_d256_kernel<<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k14_full_attention_d256(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int nh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    float scale, void* stream) {
  if (is_bf16 || d != D || B < 1 || Sq < 1 || Sk < 1 || Sk > 1024 || nh < 1
      || nh > 65535 || (Sq + BQ - 1) / BQ > 65535
      || !views_vec16(d, {q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh}, {q, k, v, o}))
    return (int)cudaErrorInvalidValue;   // fp32, 16-byte loads: aligned views only
  const FullD256Params p = {q, k, v, o, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                            kv_sh, Sq, Sk, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch(p, B, nh, s);
}
