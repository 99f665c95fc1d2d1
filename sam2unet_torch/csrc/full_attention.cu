// K14: attention over the whole key row, softmax(q k^T * scale) v, for
// (B, S, heads, d) tensors with at most 1024 keys.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_kernel (launched by
// _fused_full, :78-113). The JAX package runs it under its "pallas"
// attention backend for every attention whose key length is <= 1024
// (`_dispatch_fwd`, :432-443): the q-pool transitions the trunk leaves
// unfused and the SAM mask decoder's token attentions.
//
// What it computes, as the TPU kernel does: fp32 scores q.k * scale, the
// row maximum m, e = exp(s - m), p = e / sum(e) in fp32, p rounded to the
// working type, o = p v accumulated in fp32 and rounded once. No lse and no
// backward kernel: the JAX package's backward in this regime is an einsum
// recompute (flash_attention.py:465-474).
//
// Bound on an H100: 4*Sq*Sk*d operations per (batch, head) against
// (2*Sq + 2*Sk)*d elements moved; at the shapes of the model (Sk <= 256)
// it is bound by bytes.
//
// Design: one block per (batch, head, 64 queries), four warps of 16 query
// rows (fewer for short query rows). q, k and v are strided views, as K10
// takes them (channel slices of a QKV output), so no copy is made; the
// output is contiguous (B, Sq, heads, d). Keys stream through a
// double-buffered cp.async ring twice:
//   pass 1: scores in registers (mma.sync.m16n8k16 in bf16, CUDA-core dot
//           products in fp32), the running maximum and sum of exp of each
//           row (rescaled when the maximum moves);
//   pass 2: the same scores again, p = exp(s - m) / sum, rounded, and
//           O += P V on the tensor cores with V from the ring.
// Each p is normalised before it is rounded, as the TPU kernel rounds it,
// so no division of the output is left at the end. The key tile is 64
// tokens, or 16 when the row has at most 16 keys (the mask decoder's 6-16
// prompt tokens), so a short key row does not pay for a 64-key tile of
// padding; the ragged last tile is zero-filled and masked.

#include <type_traits>

#include "common.cuh"

struct FullParams {
  const void *q, *k, *v;
  void* out;                        // contiguous (B, Sq, heads, d)
  long long q_sb, q_ss, q_sh;       // q strides: batch, token, head
  long long kv_sb, kv_ss, kv_sh;    // the same for k and v
  int Sq, Sk, nh, d;
  float scale;
};

template <int DP, int BKV, typename T>
inline size_t full_smem_bytes(int bq) {
  const size_t lds = DP + 8;                       // conflict-free ldmatrix rows
  size_t b = sizeof(T) * lds * (bq + 4 * BKV);     // Q tile, 2 x (K, V) tiles
  if (sizeof(T) == sizeof(float)) b += sizeof(float) * bq * BKV;   // P tiles
  return b;
}

template <typename T, int NDF, int BKV>
__global__ void __launch_bounds__(128) full_attn_kernel(FullParams p) {
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF, NJ = BKV / 8;
  constexpr int CH = 16 / sizeof(T);               // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char f_smem[];
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(f_smem);                        // BQ x LDS
  T* Ks = Qs + BQ * LDS;                                       // [2][BKV][LDS]
  T* Vs = Ks + 2 * BKV * LDS;                                  // [2][BKV][LDS]
  float* Ps = reinterpret_cast<float*>(Vs + 2 * BKV * LDS);    // fp32: BQ x BKV

  const int b = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;   // fragment row, column pair
  const int Sq = p.Sq, Sk = p.Sk, d = p.d;
  const T* qb = reinterpret_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;

  // ---- Q tile, head dim zero-padded to DP (d % 8 == 0: an 8-vector is all
  // real or all pad lanes), rows past Sq zero
  for (int idx = tid; idx < BQ * (DP / 8); idx += blockDim.x) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = q0 + r;
    V8<T> val = v8_zero<T>();
    if (t < Sq && ch < d) val = v8_load(qb + t * p.q_ss + ch);
    v8_store(Qs + r * LDS + ch, val);
  }

  auto load_tile = [&](int buf, int kt, bool with_v) {
    constexpr int NCH = DP / CH;
    for (int idx = tid; idx < BKV * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * BKV + r;
      const bool valid = t < Sk && ch < d;
      const long long off = valid ? t * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * BKV + r) * LDS + ch, kb + off, valid);
      if (with_v) cp_async16(Vs + (buf * BKV + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (Sk + BKV - 1) / BKV;

  unsigned qf[NDF][4];
  // scores of the warp's 16 rows x BKV keys of tile `ks`: s[j][e] is row
  // g + 8*(e/2), key j*8 + q2 + e%2, scaled; keys past Sk are -inf
  auto scores = [&](float (&s)[NJ][4], const T* ks, int kt) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBF16) {
#pragma unroll
      for (int kd = 0; kd < NDF; ++kd)
#pragma unroll
        for (int jj = 0; jj < NJ / 2; ++jj) {
          unsigned r[4];
          ldmatrix_x4(r, ks + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                             + kd * 16 + ((lane >> 3) & 1) * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_16816(s[2 * jj], qf[kd], b0);
          mma_16816(s[2 * jj + 1], qf[kd], b1);
        }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* qr = Qs + (warp * 16 + g + 8 * (e >> 1)) * LDS;
          const T* kr = ks + (j * 8 + q2 + (e & 1)) * LDS;
          float acc = 0.f;
          for (int ch = 0; ch < d; ++ch) acc = fmaf(to_f(qr[ch]), to_f(kr[ch]), acc);
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
  __syncthreads();   // Q tile stored
  if constexpr (kBF16) {
#pragma unroll
    for (int kd = 0; kd < NDF; ++kd)
      ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8);
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_tile(buf ^ 1, kt + 1, false);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt landed for every thread
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
    __syncthreads();
  }

  // ---- round once, write the contiguous output
  T* out = reinterpret_cast<T*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    T* orow = out + (((long long)b * Sq + t) * p.nh + h) * d;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col < d) store2(orow + col, o[f][2 * hh], o[f][2 * hh + 1]);
    }
  }
}

template <typename T, int NDF, int BKV>
static cudaError_t launch_full_t(const FullParams& p, int B,
                                 cudaStream_t stream) {
  const int nwarps = p.Sq >= 64 ? 4 : (p.Sq + 15) / 16;
  const int bq = nwarps * 16;
  const size_t smem = full_smem_bytes<16 * NDF, BKV, T>(bq);
  cudaError_t e = cudaFuncSetAttribute(
      full_attn_kernel<T, NDF, BKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, p.nh, (p.Sq + bq - 1) / bq);
  full_attn_kernel<T, NDF, BKV><<<grid, nwarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int BKV>
static cudaError_t launch_full_bkv(const FullParams& p, int B,
                                   cudaStream_t stream) {
  switch ((p.d + 15) / 16) {
    case 1: return launch_full_t<T, 1, BKV>(p, B, stream);
    case 2: return launch_full_t<T, 2, BKV>(p, B, stream);
    case 3: return launch_full_t<T, 3, BKV>(p, B, stream);
    case 4: return launch_full_t<T, 4, BKV>(p, B, stream);
    case 5: return launch_full_t<T, 5, BKV>(p, B, stream);
    default: return launch_full_t<T, 6, BKV>(p, B, stream);
  }
}

template <typename T>
static cudaError_t launch_full(const FullParams& p, int B, cudaStream_t stream) {
  if (p.d < 8 || p.d % 8 || p.d > 96 || p.Sq < 1 || p.Sk < 1 || p.Sk > 1024
      || B < 1 || p.nh < 1 || p.nh > 65535 || (p.Sq + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  return p.Sk <= 16 ? launch_full_bkv<T, 16>(p, B, stream)
                    : launch_full_bkv<T, 64>(p, B, stream);
}

extern "C" int k14_full_attention(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B,
    int Sq, int Sk, int nh, int d, long long q_sb, long long q_ss,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    float scale, void* stream) {
  FullParams p = {};
  p.q = q; p.k = k; p.v = v; p.out = o;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.Sq = Sq; p.Sk = Sk; p.nh = nh; p.d = d; p.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_full<bf16>(p, B, s) : launch_full<float>(p, B, s));
}
