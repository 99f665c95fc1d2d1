// The attention forward at any head dim, over attention.cuh's AttnParams:
// every geometry and mode of attention.cuh's kernel (rows and grid mode,
// the in-window q-pool, the synthetic pad key, the masked whole-grid mode,
// the lse) and K14's two-pass full attention (full_attention.cu), for head
// dims that are not a multiple of 8, above 96, or views whose strides or
// bases do not allow 16-byte vectors.
//
// Design: the register tiles of attention.cuh (a warp's 16 query rows, the
// online softmax in registers, mma.sync in bf16, CUDA-core dot products in
// fp32) over a head dim cut into chunks of DP = 16 * NDF columns: NDF 1 or
// 2 where d <= 16 or 32 (one chunk, so a d = 12 head does not pay for 64
// lanes), else 4 (64-wide chunks, ceil(d / 64) of them). Each block owns
// one output chunk of one (window, head, query tile): its scores are summed
// over every chunk of q and k, each staged through shared memory in turn,
// and it accumulates P V for its own chunk of v only; the scores are formed
// once per output chunk (ceil(d / 64) times over), which keeps the
// accumulators at 32 registers a lane at any d. Loads are element by
// element with zero fill past d (16-byte vectors where `vec`: d % 8 == 0,
// strides and bases aligned), synchronous, so the pipeline is plain: stage,
// barrier, compute, barrier. The scale is the caller's (1 / sqrt of the
// true d). The pad key's logit q.b_k is a full-d dot product read from
// global memory, its value b_v seeds each chunk's output; the lse is
// written by the first chunk's block.
//   form 0: attention.cuh's unmasked kernel (K4, K6, K8, K10, K12);
//   form 1: its masked whole-grid mode (K6 masked);
//   form 2: K14: pass 1 the row max and sum over every key tile, pass 2 the
//           scores again, p = exp(s - m) / sum rounded to T, O += P V,
//           no division at the end, no lse, no pad key.
#pragma once

#include <type_traits>

#include "attention_bwd.cuh"

// Chunk width of a head dim: NDF 1, 2 or 4 (16, 32, 64 columns).
inline int attn_any_ndf(int d) { return d <= 16 ? 1 : d <= 32 ? 2 : 4; }

// rows x DP tile of columns [c0, c0 + DP) of token rows t0.. of one head
// (rows at base + attn_rel(t, vw, W) * ss), zero past `n` tokens and past d.
// `vec`: 16-byte vectors (d, ss and c0 multiples of 8, base aligned).
template <typename T, int DP>
__device__ __forceinline__ void any_load_rows(T* dst, int rows, int t0, int n,
                                              int c0, int d, const T* base,
                                              long long ss, int vw, int W,
                                              bool vec, int tid, int nthr) {
  constexpr int LDS = DP + 8;
  if (vec) {
    for (int idx = tid; idx < rows * (DP / 8); idx += nthr) {
      const int r = idx / (DP / 8), col = (idx - r * (DP / 8)) * 8, t = t0 + r;
      V8<T> val = v8_zero<T>();
      if (t < n && c0 + col < d) val = v8_load(base + attn_rel(t, vw, W) * ss + c0 + col);
      v8_store(dst + r * LDS + col, val);
    }
    return;
  }
  for (int idx = tid; idx < rows * DP; idx += nthr) {
    const int r = idx / DP, col = idx - r * DP, t = t0 + r, ch = c0 + col;
    T val = from_f<T>(0.f);
    if (t < n && ch < d) val = base[attn_rel(t, vw, W) * ss + ch];
    dst[r * LDS + col] = val;
  }
}

// The same for pooled queries: each the 2x2 max of the window's projected q
// (token (2ty + dy) * win + 2tx + dx of a window of tokens rows vw wide).
template <typename T, int DP>
__device__ __forceinline__ void any_load_pooled(T* dst, int rows, int t0, int n,
                                                int c0, int d, const T* base,
                                                long long ss, int vw, int W,
                                                int win, int tid, int nthr) {
  constexpr int LDS = DP + 8;
  const int hw = win / 2;
  for (int idx = tid; idx < rows * DP; idx += nthr) {
    const int r = idx / DP, col = idx - r * DP, t = t0 + r, ch = c0 + col;
    float mx = 0.f;
    if (t < n && ch < d) {
      const int ty = t / hw, tx = t - ty * hw;
      mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tok = (2 * ty + (i >> 1)) * win + 2 * tx + (i & 1);
        mx = fmaxf(mx, to_f(base[attn_rel(tok, vw, W) * ss + ch]));
      }
    }
    dst[r * LDS + col] = from_f<T>(mx);   // exact: a maximum of T values
  }
}

// s (16 x 64, accumulator layout) += A (the warp's 16 rows) . B (64 rows),
// both DP-wide chunks at stride DP + 8 in shared memory, `ncols` of them real:
// attention_bwd_tiles.cuh's `tile_rows_dot`, summing into s over the chunks
// (that one starts from zero, and the vector instances keep it as built).
// The products that take P use `tile_p_rows` itself.
template <typename T, int NDF>
__device__ __forceinline__ void any_rows_dot(float s[8][4], const T* A,
                                             const T* B, int ncols, int lane) {
  constexpr int LDS = 16 * NDF + 8;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kd = 0; kd < NDF; ++kd) {
      unsigned af[4];
      ldmatrix_x4(af, A + (lane & 15) * LDS + kd * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned r[4];
        ldmatrix_x4(r, B + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                           + kd * 16 + ((lane >> 3) & 1) * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(s[2 * jj], af, b0);
        mma_16816(s[2 * jj + 1], af, b1);
      }
    }
  } else {
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* ar = A + (g + 8 * (e >> 1)) * LDS;
        const T* br = B + (j * 8 + q2 + (e & 1)) * LDS;
        float acc = s[j][e];
        for (int ch = 0; ch < ncols; ++ch) acc = fmaf(to_f(ar[ch]), to_f(br[ch]), acc);
        s[j][e] = acc;
      }
  }
}

inline size_t attn_any_fwd_smem(int bq, int ndf, size_t tsize) {
  size_t b = tsize * (16 * ndf + 8) * (bq + 2 * A_BKV)   // Q, K, V chunks
             + sizeof(float) * bq;                        // pad-key logits
  if (tsize == sizeof(float)) b += sizeof(float) * bq * A_BKV;   // P tiles
  return b;
}

template <typename T, int NDF, int FORM>
__global__ void __launch_bounds__(128) attn_any_kernel(AttnParams p, int nchunk,
                                                       int vec) {
  constexpr bool MASKED = FORM == 1, FULL = FORM == 2;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  extern __shared__ __align__(128) unsigned char a_smem[];
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(a_smem);                        // BQ x LDS
  T* Ks = Qs + BQ * LDS;                                       // BKV x LDS
  T* Vs = Ks + A_BKV * LDS;                                    // BKV x LDS
  float* spad = reinterpret_cast<float*>(Vs + A_BKV * LDS);    // BQ
  float* Ps = spad + BQ;                                       // fp32: BQ x BKV

  const int wi = blockIdx.x, h = blockIdx.y;
  const int qt = blockIdx.z / nchunk, oc = blockIdx.z - qt * nchunk;
  const int q0 = qt * BQ, c_out = oc * DP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const T* pb = reinterpret_cast<const T*>(p.pad_bias);
  const int koff = p.c + h * p.d, voff = 2 * p.c + h * p.d;   // in pad_bias
  const int d = p.d;
  const bool one = nchunk == 1;

  // ---- this window: attention_bwd.cuh's `bwd_window`, its edge-window
  // form in grid mode without the q-pool (K12's remainder grid; on a
  // window-divisible grid it gives every window win^2 tokens and no pads)
  const BwdWin w = p.mode == 1 && !p.qpool ? bwd_window<true>(p, wi)
                                           : bwd_window<false>(p, wi);
  const int S = w.S, Sq = w.Sq, vw = w.kvw, ovw = w.ovw, oW = w.oW;
  const long long orow0 = w.orow0;
  const long long qw = p.mode == 0 ? (long long)wi * p.q_sb : w.krow0 * p.q_ss;
  const long long kw = p.mode == 0 ? (long long)wi * p.kv_sb : w.krow0 * p.kv_ss;
  const bool rem = p.mode == 1 && !p.qpool;
  const bool pad = pb != nullptr && (!rem || w.pad);
  const float pad_logn = rem ? w.pad_logn : p.pad_logn;
  if (q0 >= Sq) return;   // an edge window's spare query tiles
  const T* qb = reinterpret_cast<const T*>(p.q) + qw + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + kw + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + kw + h * p.kv_sh;
  const bool v8 = vec != 0;

  auto load_q = [&](int cc) {
    if (p.qpool)
      any_load_pooled<T, DP>(Qs, BQ, q0, Sq, cc * DP, d, qb, p.q_ss, vw, p.W,
                             p.win, tid, blockDim.x);
    else
      any_load_rows<T, DP>(Qs, BQ, q0, Sq, cc * DP, d, qb, p.q_ss, vw, p.W, v8,
                           tid, blockDim.x);
  };
  auto load_kv = [&](T* dst, const T* base, int kt, int cc) {
    any_load_rows<T, DP>(dst, A_BKV, kt * A_BKV, S, cc * DP, d, base, p.kv_ss,
                         vw, p.W, v8, tid, blockDim.x);
  };

  // ---- pad-key logits of the warp's 16 rows: q.b_k over the whole head
  if (pad) {
    const int hw = p.win / 2;
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i, t = q0 + r;
      float dot = 0.f;
      if (t < Sq) {
        for (int ch = lane; ch < d; ch += 32) {
          float qv;
          if (!p.qpool) {
            qv = to_f(qb[attn_rel(t, vw, p.W) * p.q_ss + ch]);
          } else {
            const int ty = t / hw, tx = t - ty * hw;
            qv = -INFINITY;
            for (int k = 0; k < 4; ++k)
              qv = fmaxf(qv, to_f(qb[attn_rel((2 * ty + (k >> 1)) * p.win + 2 * tx + (k & 1),
                                              vw, p.W) * p.q_ss + ch]));
          }
          dot = fmaf(qv, to_f(pb[koff + ch]), dot);
        }
      }
      dot = warp_sum(dot);
      float lm = pad_logn;
      if constexpr (MASKED) lm = t < Sq ? p.logmult[t] : 0.f;
      if (lane == 0) spad[r] = dot * p.scale + lm;
    }
    __syncwarp();
  }

  // scores of the warp's 16 rows x 64 keys of tile kt over the whole head,
  // scaled and masked (keys past S -inf); with `with_v` the tile's chunk
  // oc of v is in Vs afterwards
  const int nkt = (S + A_BKV - 1) / A_BKV;
  auto scores = [&](float (&s)[8][4], int kt, bool with_v) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    for (int cc = 0; cc < nchunk; ++cc) {
      __syncthreads();   // the previous stage's chunks consumed
      if (!one || kt == 0) load_q(cc);
      load_kv(Ks, kb, kt, cc);
      if (one && with_v) load_kv(Vs, vb, kt, 0);
      __syncthreads();
      any_rows_dot<T, NDF>(s, Qs + warp * 16 * LDS, Ks, min(DP, d - cc * DP), lane);
    }
    if (with_v && !one) {
      __syncthreads();
      load_kv(Vs, vb, kt, oc);
      __syncthreads();
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float* mrow = nullptr;
      if constexpr (MASKED) {
        const int t = q0 + warp * 16 + g + 8 * hh;
        mrow = p.mask + (long long)(t < Sq ? t : 0) * S;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const int key = kt * A_BKV + j * 8 + q2 + (e & 1);
          float v = -INFINITY;
          if (key < S) {
            v = s[j][e] * p.scale;
            if constexpr (MASKED) v += mrow[key];
          }
          s[j][e] = v;
        }
    }
  };

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
      const int col = c_out + f * 8 + q2 + (e & 1);
      o[f][e] = (pad && col < d) ? to_f(pb[voff + col]) : 0.f;
    }

  float inv[2] = {1.f, 1.f};
  if constexpr (FULL) {
    // ---- pass 1: row maximum and sum of exp(s - m)
    for (int kt = 0; kt < nkt; ++kt) {
      float s[8][4];
      scores(s, kt, false);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hh], mx);   // finite: tile 0 holds key 0
        float sum = l[hh] * expf(m[hh] - mn);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          sum += expf(s[j][2 * hh] - mn) + expf(s[j][2 * hh + 1] - mn);
        m[hh] = mn;
        l[hh] = sum;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float den = l[hh];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
      inv[hh] = 1.f / den;
    }
  }

  for (int kt = 0; kt < nkt; ++kt) {
    float s[8][4];
    scores(s, kt, true);
    if constexpr (FULL) {
      // ---- pass 2: p = exp(s - m) / sum, rounded to T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = round_to<T>(expf(s[j][e] - m[e >> 1]) * inv[e >> 1]);
    } else {
      // online softmax; the four lanes of a row agree
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
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
    }
    tile_p_rows<T, NDF>(o, s, Vs, Ps + warp * 16 * A_BKV, lane);
  }

  // ---- normalise (online forms), round once, scatter to the output rows
  T* out = reinterpret_cast<T*>(p.out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float den = 1.f;
    if constexpr (!FULL) {
      den = l[hh];
      den += __shfl_xor_sync(0xffffffffu, den, 1);
      den += __shfl_xor_sync(0xffffffffu, den, 2);
    }
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
    T* orow = out + (orow0 + attn_rel(t, ovw, oW)) * p.c + h * p.d;
    const float r = FULL ? 1.f : 1.f / den;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c_out + f * 8 + q2 + i;
        if (col < d) orow[col] = from_f<T>(o[f][2 * hh + i] * r);
      }
    if (!FULL && oc == 0 && p.lse && (lane & 3) == 0)
      p.lse[((long long)wi * gridDim.y + h) * p.Sq + t] = m[hh] + logf(den);
  }
}

// One launch: windows x heads x (query tiles x output chunks).
template <typename T, int NDF, int FORM>
static cudaError_t launch_attn_any_t(const AttnParams& p, int n_windows,
                                     int n_heads, cudaStream_t stream) {
  const int nwarps = p.Sq >= 64 ? 4 : (p.Sq + 15) / 16;
  const int bq = nwarps * 16;
  const int nchunk = (p.d + 16 * NDF - 1) / (16 * NDF);
  const long long nz = (long long)((p.Sq + bq - 1) / bq) * nchunk;
  if (nz > 65535) return cudaErrorInvalidValue;
  const size_t smem = attn_any_fwd_smem(bq, NDF, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(attn_any_kernel<T, NDF, FORM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const bool vec = views_vec16(
      p.d, {p.q_sb, p.q_ss, p.q_sh, p.kv_sb, p.kv_ss, p.kv_sh}, {p.q, p.k, p.v});
  attn_any_kernel<T, NDF, FORM><<<dim3(n_windows, n_heads, (unsigned)nz),
                                  nwarps * 32, smem, stream>>>(p, nchunk, vec);
  return cudaGetLastError();
}

template <typename T, int FORM>
static cudaError_t launch_attn_any(const AttnParams& p, int n_windows, int n_heads,
                                   cudaStream_t stream) {
  if (p.d < 1 || n_heads < 1 || n_heads > 65535 || n_windows < 1 || p.Sq < 1
      || p.S < 1
      || (FORM == 1 ? !p.mask || !p.logmult || !p.pad_bias || p.mode != 0
                          || p.qpool || p.Sq != p.S
          : FORM == 2 ? p.mask || p.pad_bias || p.lse || p.mode != 0 || p.qpool
                      : p.mask != nullptr))
    return cudaErrorInvalidValue;
  switch (attn_any_ndf(p.d)) {
    case 1: return launch_attn_any_t<T, 1, FORM>(p, n_windows, n_heads, stream);
    case 2: return launch_attn_any_t<T, 2, FORM>(p, n_windows, n_heads, stream);
    default: return launch_attn_any_t<T, 4, FORM>(p, n_windows, n_heads, stream);
  }
}
