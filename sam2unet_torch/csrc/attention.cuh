// Attention over projected q / k / v rows, one block per (window, head,
// query tile of 16 per warp, up to 4 warps).
//
// q, k and v are d-wide head rows at element strides. For the fused blocks
// they are the channel blocks [q | k | v] of one qkv buffer (3c channels
// per token, within each [heads, d], hiera.py:102-104; `attn_on_qkv`); K10
// passes any (B, S, heads, d) views. The kernel finds a window's tokens
// itself, so no partitioned copy exists in device memory:
//   mode 0 (rows): window w is batch entry w, token t of head h at
//                  base + w*sb + t*ss + h*sh (pre-partitioned window groups,
//                  a whole image for global attention, K10's sequences);
//   mode 1 (grid): (B, H, W) token grid cut into ceil(H/win) x ceil(W/win)
//                  windows. A window on the bottom or right edge holds only
//                  its vh x vw tokens inside the grid (enumerated row-major);
//                  the reference's win^2 - vh*vw zero pads become the pad
//                  key below, and no query outside the grid exists.
// qpool=1 (transition blocks, divisible grids): each query is the 2x2 max of
// the window's projected q (in-window q-pool); the output lands on the
// (B, H/2, W/2) grid. Optional synthetic pad key (n_pad identical
// zero-padded tokens of the reference collapse to one key): logit
// q.b_k*scale + ln(n_pad), value b_v, both read from the qkv bias in the
// working type, as the reference's plain form reads them (the Pallas kernel
// reads them in fp32); n_pad is the call's in mode 0 and each window's own
// in mode 1. Optional lse output (K10): m + ln(l) of each query's scaled
// scores, fp32.
//
// Streaming (flash) form: the block's Q tile is loaded once (head dim
// zero-padded to NDF*16 for the 16-deep MMA step; pad lanes are zero and
// add nothing); keys and values stream through a double-buffered cp.async
// ring of 64-token tiles, the ragged last tile zero-filled and its keys
// masked; each warp keeps its 16 rows' scores, running max, running sum and
// output in registers (online softmax, fp32), so no S x S or even BQ x S
// score matrix exists. The pad key seeds the running max, sum and output
// before the first tile.
//   bf16: Q.K^T and P.V on mma.sync.m16n8k16 (fp32 accumulate); the score
//         accumulators become the P operand in registers, rounded to bf16.
//   fp32: the same loop with CUDA-core dot products in the same register
//         layout and P staged through shared memory (comparison path).
#pragma once

#include <type_traits>

#include "common.cuh"

struct AttnParams {
  const void *q, *k, *v;   // head 0 of token 0 (of window 0 in mode 0)
  long long q_sb, q_ss, q_sh;      // q strides: window (mode 0), token, head
  long long kv_sb, kv_ss, kv_sh;   // the same for k and v
  void* out;               // output rows of c channels, head h at h*d
  float* lse;              // (windows * heads, Sq) or null
  const void* pad_bias;    // 3c qkv bias (pad key / value) or null
  float pad_logn;          // mode 0: ln(n_pad)
  int c, d;
  int mode;                // 0 rows, 1 grid
  int S;                   // keys per window (mode 1: win^2, the most)
  int Sq;                  // queries per window (mode 1: the most)
  int H, W, win;           // grid mode geometry
  int qpool;
  float scale;
};

// q / k / v of a qkv buffer (rows of 3c, [q | k | v]); mode-0 windows of S
// consecutive rows.
static void attn_on_qkv(AttnParams& ap, int is_bf16, const void* qkv, int c,
                        int nh, long long S) {
  const char* base = static_cast<const char*>(qkv);
  const size_t es = is_bf16 ? sizeof(bf16) : sizeof(float);
  ap.q = base; ap.k = base + c * es; ap.v = base + 2 * c * es;
  ap.q_ss = ap.kv_ss = 3LL * c;
  ap.q_sb = ap.kv_sb = S * 3LL * c;
  ap.q_sh = ap.kv_sh = c / nh;
  ap.c = c; ap.d = c / nh;
  ap.scale = 1.0f / sqrtf((float)(c / nh));
}

constexpr int A_BKV = 64;   // keys per streamed tile

inline size_t attn_smem_bytes(int bq, int dp, size_t tsize) {
  const size_t lds = dp + 8;                       // conflict-free ldmatrix rows
  size_t b = tsize * lds * (bq + 4 * A_BKV)        // Q tile, 2 x (K, V) tiles
             + sizeof(float) * bq;                 // pad-key logits
  if (tsize == sizeof(float)) b += sizeof(float) * bq * A_BKV;   // P tiles
  return b;
}

// Row offset of a window's token t from its first token: rows of vw tokens
// W apart (grid mode), or consecutive (vw == 0).
__device__ __forceinline__ long long attn_rel(int t, int vw, int W) {
  if (vw == 0) return t;
  const int ty = t / vw;
  return (long long)ty * W + (t - ty * vw);
}

template <typename T, int NDF>
__global__ void __launch_bounds__(128) attn_kernel(AttnParams p) {
  constexpr bool kBF16 = std::is_same<T, bf16>::value;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  constexpr int CH = 16 / sizeof(T);               // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char a_smem[];
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(a_smem);                        // BQ x LDS
  T* Ks = Qs + BQ * LDS;                                       // [2][BKV][LDS]
  T* Vs = Ks + 2 * A_BKV * LDS;                                // [2][BKV][LDS]
  float* spad = reinterpret_cast<float*>(Vs + 2 * A_BKV * LDS);  // BQ
  float* Ps = spad + BQ;                                       // fp32: BQ x BKV

  const int wi = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;   // fragment row, column pair
  const T* pb = reinterpret_cast<const T*>(p.pad_bias);
  const int koff = p.c + h * p.d, voff = 2 * p.c + h * p.d;   // in pad_bias

  // ---- this window: its keys S, queries Sq, where its tokens lie
  int S = p.S, Sq = p.Sq;
  int vw = 0, ovw = 0, oW = 0;        // token rows (grid mode), output rows
  long long qw = (long long)wi * p.q_sb, kw = (long long)wi * p.kv_sb;
  long long orow0 = (long long)wi * p.Sq;
  float pad_logn = p.pad_logn;
  bool pad = pb != nullptr;
  if (p.mode == 1) {
    const int nwx = (p.W + p.win - 1) / p.win;
    const int nwin = ((p.H + p.win - 1) / p.win) * nwx;
    const int b = wi / nwin, r = wi - b * nwin;
    const int wy = r / nwx, wx = r - wy * nwx;
    const int vh = min(p.win, p.H - wy * p.win);
    vw = min(p.win, p.W - wx * p.win);
    const long long row0 = ((long long)b * p.H + wy * p.win) * p.W + wx * p.win;
    qw = row0 * p.q_ss;
    kw = row0 * p.kv_ss;
    if (!p.qpool) {
      S = Sq = vh * vw;
      orow0 = row0; ovw = vw; oW = p.W;
      const int n_pad = p.win * p.win - S;
      pad = pad && n_pad > 0;
      pad_logn = n_pad > 0 ? logf((float)n_pad) : 0.f;
    } else {
      const int hw = p.win / 2;
      orow0 = ((long long)b * (p.H / 2) + wy * hw) * (p.W / 2) + wx * hw;
      ovw = hw; oW = p.W / 2;
    }
  }
  if (q0 >= Sq) return;   // an edge window's spare query tiles
  const T* qb = reinterpret_cast<const T*>(p.q) + qw + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + kw + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + kw + h * p.kv_sh;

  // ---- Q tile (d % 8 == 0: an 8-vector is all real or all pad lanes)
  for (int idx = tid; idx < BQ * (DP / 8); idx += blockDim.x) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = q0 + r;
    V8<T> val = v8_zero<T>();
    if (t < Sq && ch < p.d) {
      if (!p.qpool) {
        val = v8_load(qb + attn_rel(t, vw, p.W) * p.q_ss + ch);
      } else {
        const int hw = p.win / 2, ty = t / hw, tx = t - (t / hw) * hw;
        float mx[8], f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int tok = (2 * ty + dy) * p.win + 2 * tx + dx;
            v8_to_floats(v8_load(qb + attn_rel(tok, vw, p.W) * p.q_ss + ch), f);
#pragma unroll
            for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], f[e]);
          }
        val = v8_from_floats<T>(mx);   // exact: maxima of T values
      }
    }
    v8_store(Qs + r * LDS + ch, val);
  }

  auto load_kv = [&](int buf, int kt) {
    constexpr int NCH = DP / CH;
    for (int idx = tid; idx < A_BKV * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * A_BKV + r;
      const bool valid = t < S && ch < p.d;
      const long long off = valid ? attn_rel(t, vw, p.W) * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * A_BKV + r) * LDS + ch, kb + off, valid);
      cp_async16(Vs + (buf * A_BKV + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (S + A_BKV - 1) / A_BKV;
  load_kv(0, 0);
  cp_async_commit();
  __syncthreads();   // Q tile stored

  // ---- pad-key logits of the warp's 16 rows
  if (pad) {
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      float dot = 0.f;
      for (int ch = lane; ch < p.d; ch += 32)
        dot = fmaf(to_f(Qs[r * LDS + ch]), to_f(pb[koff + ch]), dot);
      dot = warp_sum(dot);
      if (lane == 0) spad[r] = dot * p.scale + pad_logn;
    }
    __syncwarp();
  }

  unsigned qf[NDF][4];
  if constexpr (kBF16) {
#pragma unroll
    for (int kd = 0; kd < NDF; ++kd)
      ldmatrix_x4(qf[kd], Qs + (warp * 16 + (lane & 15)) * LDS + kd * 16 + (lane >> 4) * 8);
  }

  // running max / sum of rows g and g + 8, output columns f*8 + q2 + {0, 1};
  // the pad key is the first key: max s_pad, sum 1 (counted in one lane of
  // the four that share a row), output v_pad
  float m[2], l[2], o[NDT][4];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    m[hh] = pad ? spad[warp * 16 + g + 8 * hh] : -INFINITY;
    l[hh] = (pad && (lane & 3) == 0) ? 1.f : 0.f;
  }
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = f * 8 + q2 + (e & 1);
      o[f][e] = (pad && col < p.d) ? to_f(pb[voff + col]) : 0.f;
    }

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_kv(buf ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt landed for every thread
    const T* ks = Ks + buf * A_BKV * LDS;
    const T* vs = Vs + buf * A_BKV * LDS;

    // scores of 16 rows x 64 keys: s[j][e] is row g + 8*(e/2), key j*8 + q2 + e%2
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (kBF16) {
#pragma unroll
      for (int kd = 0; kd < NDF; ++kd)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          unsigned r[4];
          ldmatrix_x4(r, ks + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                             + kd * 16 + ((lane >> 3) & 1) * 8);
          const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_16816(s[2 * jj], qf[kd], b0);
          mma_16816(s[2 * jj + 1], qf[kd], b1);
        }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const T* qr = Qs + (warp * 16 + g + 8 * (e >> 1)) * LDS;
          const T* kr = ks + (j * 8 + q2 + (e & 1)) * LDS;
          float acc = 0.f;
          for (int ch = 0; ch < p.d; ++ch) acc = fmaf(to_f(qr[ch]), to_f(kr[ch]), acc);
          s[j][e] = acc;
        }
    }

    // online softmax: keys past S are masked; the four lanes of a row agree
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const int key = kt * A_BKV + j * 8 + q2 + (e & 1);
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
      for (int j = 0; j < 8; ++j)
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
      for (int kc = 0; kc < A_BKV / 16; ++kc) {
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
      float* pw = Ps + warp * 16 * A_BKV;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pw[(g + 8 * (e >> 1)) * A_BKV + j * 8 + q2 + (e & 1)] = s[j][e];
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NDT; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* pr = pw + (g + 8 * (e >> 1)) * A_BKV;
          const int col = f * 8 + q2 + (e & 1);
          float acc = 0.f;
          for (int k = 0; k < A_BKV; ++k) acc = fmaf(pr[k], to_f(vs[k * LDS + col]), acc);
          o[f][e] += acc;
        }
      __syncwarp();
    }
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }

  // ---- normalize, round once, scatter to the output's own layout
  T* out = reinterpret_cast<T*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = l[hh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    T* orow = out + (orow0 + attn_rel(t, ovw, oW)) * p.c + h * p.d;
    const float inv = 1.f / den;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col < p.d) store2(orow + col, o[f][2 * hh] * inv, o[f][2 * hh + 1] * inv);
    }
    if (p.lse && (lane & 3) == 0)
      p.lse[((long long)wi * gridDim.y + h) * Sq + t] = m[hh] + logf(den);
  }
}

// One launch for all windows x heads x query tiles.
template <typename T, int NDF>
static cudaError_t launch_attn_t(const AttnParams& p, int n_windows,
                                 int n_heads, cudaStream_t stream) {
  const int nwarps = p.Sq >= 64 ? 4 : (p.Sq + 15) / 16;
  const int bq = nwarps * 16;
  const size_t smem = attn_smem_bytes(bq, 16 * NDF, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, NDF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_windows, n_heads, (p.Sq + bq - 1) / bq);
  attn_kernel<T, NDF><<<grid, nwarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_attn(const AttnParams& p, int n_windows, int n_heads,
                               cudaStream_t stream) {
  // head dims of the SAM2 trunks: 56 (b+), 72 (l), 96 (t, s)
  if (p.d % 8 || p.d > 96 || n_heads > 65535 || p.Sq < 1 || p.S < 1
      || (p.Sq + 63) / 64 > 65535)
    return cudaErrorInvalidValue;
  if (p.d <= 64) return launch_attn_t<T, 4>(p, n_windows, n_heads, stream);
  if (p.d <= 80) return launch_attn_t<T, 5>(p, n_windows, n_heads, stream);
  return launch_attn_t<T, 6>(p, n_windows, n_heads, stream);
}

static cudaError_t launch_attn_dt(int is_bf16, const AttnParams& p,
                                  int n_windows, int n_heads,
                                  cudaStream_t stream) {
  return is_bf16 ? launch_attn<bf16>(p, n_windows, n_heads, stream)
                 : launch_attn<float>(p, n_windows, n_heads, stream);
}
