// K10 at head dim 256: streaming flash attention over (B, S, heads, 256),
// with the log-sum-exp of each query's scaled scores.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (launched by _stream_fwd_impl, :190) at the head dim of SAM2's memory
// attention: its self-attention runs one head of 256 over the 64 x 64 =
// 4096 tokens of a 1024-px frame (sam2unet_tpu/models/memory.py:167-170),
// four times per tracked frame. The head dims of the trunks (up to 96) stay
// in flash_attention.cu, which this file leaves as it was built.
//
// Bound on an H100: 4*S_q*S_k*256 operations per (batch, head) against
// 4*S*256 elements moved, so at S = 4096 it is bound by operations.
//
// Design: one block per (batch, head, 64 queries), four warps of 16 query
// rows; keys and values stream through a two-slot cp.async ring of tiles
// of 64 keys (bf16) or 32 (fp32); the online softmax runs in registers, as
// in attention.cuh. At d = 256 each warp's output accumulator is 16 x 256
// fp32, 128 registers per lane, so q does not stay in registers too (64
// more): its tile lives in shared memory and each 16-wide k-step re-reads
// its fragment with ldmatrix. Shared memory: q 64 x 264, the ring 2 x (K, V)
// x 64 x 264 (bf16: 165 KB; fp32 with 32-key tiles and the P tile: 206 KB).
//   bf16: Q.K^T and P.V on mma.sync.m16n8k16 (fp32 accumulate); the score
//         accumulators become the P operand in registers, rounded to bf16.
//   fp32: CUDA-core dot products in the same register layout, P staged
//         through shared memory (the comparison path).
// q, k and v are strided views (unit stride over d); the output is
// contiguous (B, S_q, heads, 256), the lse (B*heads, S_q) fp32. Any S_k:
// the ragged last key tile is zero-filled and masked.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int D = 256, LDS = D + 8, NDF = D / 16, NDT = D / 8, BQ = 64;

struct D256Params {
  const void *q, *k, *v;
  void* out;
  float* lse;
  long long q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh;
  int Sq, Sk;
  float scale;
};

template <typename T, int BKV>
constexpr size_t smem_bytes() {
  return sizeof(T) * LDS * (BQ + 4 * BKV)
         + (std::is_same<T, float>::value ? sizeof(float) * BQ * BKV : 0);
}

template <typename T, int BKV>
__global__ void __launch_bounds__(128) k10_d256_kernel(D256Params p) {
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  constexpr int CH = 16 / sizeof(T), NCH = D / CH, NJ = BKV / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);          // BQ x LDS
  T* Ks = Qs + BQ * LDS;                       // [2][BKV][LDS]
  T* Vs = Ks + 2 * BKV * LDS;                  // [2][BKV][LDS]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BKV * LDS);   // fp32: BQ x BKV

  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int S = p.Sk, Sq = p.Sq;
  const T* qb = reinterpret_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;

  for (int idx = tid; idx < BQ * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), ch = (idx - r * (D / 8)) * 8, t = q0 + r;
    v8_store(Qs + r * LDS + ch,
             t < Sq ? v8_load(qb + (long long)t * p.q_ss + ch) : v8_zero<T>());
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
    const T* ks = Ks + buf * BKV * LDS;
    const T* vs = Vs + buf * BKV * LDS;

    // scores of 16 rows x BKV keys: s[j][e] is row g + 8*(e/2), key
    // j*8 + q2 + e%2
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBF16) {
#pragma unroll
      for (int kd = 0; kd < NDF; ++kd) {
        unsigned qf[4];   // re-read per k-step: registers hold the output
        ldmatrix_x4(qf, Qs + (warp * 16 + (lane & 15)) * LDS + kd * 16
                            + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          unsigned r[4];
          ldmatrix_x4(r, ks + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                             + kd * 16 + ((lane >> 3) & 1) * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_16816(s[2 * jj], qf, b0);
          mma_16816(s[2 * jj + 1], qf, b1);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* qr = Qs + (warp * 16 + g + 8 * (e >> 1)) * LDS;
          const T* kr = ks + (j * 8 + q2 + (e & 1)) * LDS;
          float acc = 0.f;
          for (int ch = 0; ch < D; ++ch) acc = fmaf(to_f(qr[ch]), to_f(kr[ch]), acc);
          s[j][e] = acc;
        }
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
    if constexpr (kBF16) {
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                               pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                               pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int fp = 0; fp < NDF; ++fp) {
          unsigned r[4];
          ldmatrix_x4_trans(r, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                                   + fp * 16 + (lane >> 4) * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_16816(o[2 * fp], a, b0);
          mma_16816(o[2 * fp + 1], a, b1);
        }
      }
    } else {
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
          for (int k = 0; k < BKV; ++k) acc = fmaf(pr[k], to_f(vs[k * LDS + col]), acc);
          o[f][e] += acc;
        }
      __syncwarp();
    }
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }

  // normalise, round once, store; the lse in fp32
  T* out = reinterpret_cast<T*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    T* orow = out + (((long long)b * Sq + t) * gridDim.y + h) * D;
    const float inv = 1.f / den;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
      store2(orow + f * 8 + q2, o[f][2 * hh] * inv, o[f][2 * hh + 1] * inv);
    if ((lane & 3) == 0)
      p.lse[((long long)b * gridDim.y + h) * Sq + t] = m[hh] + logf(den);
  }
}

template <typename T, int BKV>
cudaError_t launch(const D256Params& p, int B, int nh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BKV>();
  cudaError_t e = cudaFuncSetAttribute(
      k10_d256_kernel<T, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, nh, (p.Sq + BQ - 1) / BQ);
  k10_d256_kernel<T, BKV><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k10_flash_attention_d256(
    int is_bf16, const void* q, const void* k, const void* v, void* o,
    float* lse, int B, int Sq, int Sk, int nh, int d, long long q_sb,
    long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, float scale, void* stream) {
  if (d != D || B < 1 || Sq < 1 || Sk < 1 || nh > 65535
      || (Sq + BQ - 1) / BQ > 65535
      || !views_vec16(d, {q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh}, {q, k, v, o}))
    return (int)cudaErrorInvalidValue;   // 16-byte loads: aligned views only
  const D256Params p = {q, k, v, o, lse, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                        kv_sh, Sq, Sk, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16, 64>(p, B, nh, s)
                       : launch<float, 32>(p, B, nh, s));
}
