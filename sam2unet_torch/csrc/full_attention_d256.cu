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
// four times per tracked frame. The head dims up to 96 stay in
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
// rows. At d = 256 a warp's output accumulator is 16 x 256 fp32, 128
// registers a lane, so q's fragments do not stay in registers too: q's
// 64 x 256 tile lives in shared memory and each 16-wide k-step re-reads its
// fragment with ldmatrix, as in flash_attention_d256.cu. Keys stream
// through a two-slot cp.async ring twice, K14's two-pass scheme
// (full_attention.cu):
//   pass 1: scores, the running maximum and sum of exp of each row (K only);
//   pass 2: the same scores again, p = exp(s - m) / sum rounded to T, and
//           O += P V with V from the ring.
//   bf16: Q.K^T and P.V on mma.sync.m16n8k16 (fp32 accumulate), 64-key
//         tiles; shared memory q 64 x 264 plus 2 x (K, V) x 64 x 264, 165 KB.
//   fp32: CUDA-core dot products in the same register layout, 32-key tiles,
//         P staged through shared memory (the comparison path), 206 KB.
// q, k and v are strided views (unit stride over d); the output is
// contiguous (B, Sq, heads, 256). The ragged last key tile is zero-filled
// and masked; query rows past Sq are zero and not stored.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int D = 256, LDS = D + 8, NDF = D / 16, NDT = D / 8, BQ = 64;

struct FullD256Params {
  const void *q, *k, *v;
  void* out;
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
__global__ void __launch_bounds__(128) k14_d256_kernel(FullD256Params p) {
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
  const int Sk = p.Sk, Sq = p.Sq;
  const T* qb = reinterpret_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;

  for (int idx = tid; idx < BQ * (D / 8); idx += blockDim.x) {
    const int r = idx / (D / 8), ch = (idx - r * (D / 8)) * 8, t = q0 + r;
    v8_store(Qs + r * LDS + ch,
             t < Sq ? v8_load(qb + (long long)t * p.q_ss + ch) : v8_zero<T>());
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
  auto scores = [&](float (&s)[NJ][4], const T* ks, int kt) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBF16) {
#pragma unroll
      for (int kd = 0; kd < NDF; ++kd) {
        unsigned qf[4];   // re-read per k-step: pass 2's registers hold O
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

  // ---- pass 2: p = exp(s - m) / sum, rounded to T, O += P V
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
    const T* vs = Vs + buf * BKV * LDS;
    float s[NJ][4];
    scores(s, Ks + buf * BKV * LDS, kt);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = round_to<T>(expf(s[j][e] - m[e >> 1]) * inv[e >> 1]);
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

  // ---- round once, write the contiguous output
  T* out = reinterpret_cast<T*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    T* orow = out + (((long long)b * Sq + t) * gridDim.y + h) * D;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
      store2(orow + f * 8 + q2, o[f][2 * hh], o[f][2 * hh + 1]);
  }
}

template <typename T, int BKV>
cudaError_t launch(const FullD256Params& p, int B, int nh, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, BKV>();
  cudaError_t e = cudaFuncSetAttribute(
      k14_d256_kernel<T, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, nh, (p.Sq + BQ - 1) / BQ);
  k14_d256_kernel<T, BKV><<<grid, 128, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int k14_full_attention_d256(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int nh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    float scale, void* stream) {
  if (d != D || B < 1 || Sq < 1 || Sk < 1 || Sk > 1024 || nh < 1
      || nh > 65535 || (Sq + BQ - 1) / BQ > 65535
      || !views_vec16(d, {q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh}, {q, k, v, o}))
    return (int)cudaErrorInvalidValue;   // 16-byte loads: aligned views only
  const FullD256Params p = {q, k, v, o, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                            kv_sh, Sq, Sk, scale};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch<bf16, 64>(p, B, nh, s)
                       : launch<float, 32>(p, B, nh, s));
}
