// dx-only backward of attention.cuh's attention: dq, dk and dv of
// softmax(q k^T * scale) v for each (window, head), from q, k, v (the
// recomputed qkv buffer), the forward's output o and lse, and dO. Shared by
// K5 (grid mode), K7 (rows mode), K9 (grid mode with the in-window q-pool)
// and K13 (grid mode on a remainder grid).
//
// Two passes per (window, head), no atomics, any S (the ragged last tile of
// keys or queries is zero-filled and masked):
//   D pass:      D = rowsum(dO * o) per (output row, head), fp32;
//   dQ pass:     one block per (window, head, query tile of 16 per warp):
//                for every 64-key tile, P = exp(q k^T * scale - lse),
//                dP = dO v^T, dS = P (dP - D), dQ += dS k;
//   dK/dV pass:  one block per (window, head, key tile of 16 per warp):
//                for every 64-query tile, P^T = exp(k q^T * scale - lse),
//                dV += P^T dO, dP^T = v dO^T, dS^T = P^T (dP^T - D),
//                dK += dS^T q.
// The warp keeps its 16 rows' scores, dP and accumulators in registers;
// the products (attention_bwd_tiles.cuh, shared with K11) are mma.sync
// (bf16 operands, fp32 accumulate; P and dS rounded to bf16 as the operands
// of the next product, as the Pallas backward rounds them) or, for fp32,
// CUDA-core dot products in the same register layout. dq, dk and dv are
// written rounded to T into a gradient buffer laid out like qkv ([dq | dk |
// dv] channel blocks, `ld` elements a row). With qpool each pooled query's
// gradient goes to the first maximum (row-major) of its 2x2 cell of
// projected q, channel by channel, and the other three positions get zero,
// as max_pool2d's backward routes it.
//
// Geometries: rows mode (windows of S consecutive rows of the qkv buffer)
// and grid mode on window-divisible grids; no pad key (the remainder groups'
// backward is the reference recompute) but in two template instances of
// their own, so that the other forms compile as before:
//   K7's masked mode (`launch_attn_bwd_dt<true>`, rows mode): the mask added
//   to every score, the pad key's logit q.b_k * scale + logmult[t];
//   K13's remainder grid (`launch_attn_bwd_dt<false, true>`, grid mode on
//   any grid): K12's windows, an edge window holding only its vh x vw
//   tokens inside the grid, and the pad key of its own n_pad = win^2 -
//   vh*vw at logit q.b_k * scale + ln(n_pad).
// The pad key's key and value are frozen bias slices, so only dq gets a
// term, dS_pad b_k with dS_pad = P_pad (dO.b_v - D), P_pad = exp(logit -
// lse) (D = rowsum(dO o) already holds the pad key's share of o), added in
// fp32 as the Pallas kernel adds it (fused_attention_block.py:521-522).
#pragma once

#include "attention.cuh"
#include "attention_bwd_tiles.cuh"

static_assert(BWD_TILE == A_BKV, "the backward tiles are the forward's key tiles");

struct AttnBwdParams {
  AttnParams a;          // q / k / v in the qkv buffer and the geometry
  const void* o;         // the forward's output rows (c channels)
  const void* dout;      // dO, the same rows
  const float* lse;      // the forward's lse, (windows * heads, Sq)
  float* D;              // rowsum(dO o): (output rows) x heads
  void* dqkv;            // gradient rows, [dq | dk | dv] like qkv
  long long ld;          // elements per dqkv row
};

// Where window wi's tokens lie: key / query token t at qkv row
// krow0 + attn_rel(t, kvw, W); output row of query t orow0 + attn_rel(t, ovw, oW).
// With REM also its keys S and queries Sq (an edge window's own; the
// kernels read p.S and p.Sq otherwise) and its pad key's log-multiplicity
// (pad false where it has no pads).
struct BwdWin {
  long long krow0, orow0;
  int kvw, ovw, oW;
  int S, Sq;
  bool pad;
  float pad_logn;
};

template <bool REM>
__device__ __forceinline__ BwdWin bwd_window(const AttnParams& p, int wi) {
  BwdWin w;
  w.S = p.S;
  w.Sq = p.Sq;
  w.pad = false;
  w.pad_logn = 0.f;
  if (p.mode == 0) {
    w.krow0 = (long long)wi * p.S;
    w.orow0 = (long long)wi * p.Sq;
    w.kvw = w.ovw = w.oW = 0;
    return w;
  }
  const int nwx = REM ? (p.W + p.win - 1) / p.win : p.W / p.win;
  const int nwin = (REM ? (p.H + p.win - 1) / p.win : p.H / p.win) * nwx;
  const int b = wi / nwin, r = wi - b * nwin;
  const int wy = r / nwx, wx = r - wy * nwx;
  w.krow0 = ((long long)b * p.H + wy * p.win) * p.W + wx * p.win;
  w.kvw = p.win;
  if constexpr (REM) {   // K12's edge windows (attention.cuh, mode 1)
    const int vh = min(p.win, p.H - wy * p.win);
    const int vw = min(p.win, p.W - wx * p.win);
    const int n_pad = p.win * p.win - vh * vw;
    w.kvw = w.ovw = vw;
    w.orow0 = w.krow0;
    w.oW = p.W;
    w.S = w.Sq = vh * vw;
    w.pad = n_pad > 0;
    w.pad_logn = n_pad > 0 ? logf((float)n_pad) : 0.f;
    return w;
  }
  if (!p.qpool) {
    w.orow0 = w.krow0;
    w.ovw = p.win;
    w.oW = p.W;
  } else {
    const int hw = p.win / 2;
    w.orow0 = ((long long)b * (p.H / 2) + wy * hw) * (p.W / 2) + wx * hw;
    w.ovw = hw;
    w.oW = p.W / 2;
  }
  return w;
}

// The qkv row of token `tok` of pooled query t's 2x2 cell (i = 2 dy + dx).
__device__ __forceinline__ long long bwd_pool_row(const AttnParams& p,
                                                  const BwdWin& w, int t, int i) {
  const int hw = p.win / 2, ty = t / hw, tx = t - ty * hw;
  const int tok = (2 * ty + (i >> 1)) * p.win + 2 * tx + (i & 1);
  return w.krow0 + attn_rel(tok, w.kvw, p.W);
}

// rows x DP tile of queries t0.. (pooled with qpool; zero past Sq and d).
template <typename T, int DP>
__device__ __forceinline__ void bwd_load_q(T* dst, int rows, int t0, int Sq,
                                           const AttnParams& p, const BwdWin& w,
                                           const T* qb, int tid, int nthr) {
  constexpr int LDS = DP + 8;
  for (int idx = tid; idx < rows * (DP / 8); idx += nthr) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = t0 + r;
    V8<T> val = v8_zero<T>();
    if (t < Sq && ch < p.d) {
      if (!p.qpool) {
        val = v8_load(qb + (w.krow0 + attn_rel(t, w.kvw, p.W)) * p.q_ss + ch);
      } else {
        float mx[8], f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) mx[e] = -INFINITY;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v8_to_floats(v8_load(qb + bwd_pool_row(p, w, t, i) * p.q_ss + ch), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) mx[e] = fmaxf(mx[e], f[e]);
        }
        val = v8_from_floats<T>(mx);   // exact: maxima of T values
      }
    }
    v8_store(dst + r * LDS + ch, val);
  }
}

// rows x DP tile of output-layout rows (o, dO) of queries t0.., and their
// lse and D (zero past Sq; lse in rows of p.Sq).
template <typename T, int DP>
__device__ __forceinline__ void bwd_load_out(T* dst, float* lse_s, float* D_s,
                                             int rows, int t0, int Sq,
                                             const AttnBwdParams& bp,
                                             const BwdWin& w, int wi, int h,
                                             int nh, int tid, int nthr) {
  constexpr int LDS = DP + 8;
  const AttnParams& p = bp.a;
  const T* db = reinterpret_cast<const T*>(bp.dout) + h * p.d;
  for (int idx = tid; idx < rows * (DP / 8); idx += nthr) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = t0 + r;
    V8<T> val = v8_zero<T>();
    if (t < Sq && ch < p.d)
      val = v8_load(db + (w.orow0 + attn_rel(t, w.ovw, w.oW)) * p.c + ch);
    v8_store(dst + r * LDS + ch, val);
  }
  for (int r = tid; r < rows; r += nthr) {
    const int t = t0 + r;
    const bool ok = t < Sq;
    lse_s[r] = ok ? bp.lse[((long long)wi * nh + h) * p.Sq + t] : 0.f;
    D_s[r] = ok ? bp.D[(w.orow0 + attn_rel(t, w.ovw, w.oW)) * nh + h] : 0.f;
  }
}

// D[row * nh + h] = sum over the head's channels of dO * o.
template <typename T>
__global__ void __launch_bounds__(256) attn_bwd_rowdot_kernel(
    const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
    long long rows, int c, int nh, int d) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * nh) return;
  const long long row = i / nh;
  const int h = (int)(i - row * nh);
  const T* a = o + row * c + h * d;
  const T* b = dout + row * c + h * d;
  float s = 0.f;
  for (int ch = 0; ch < d; ch += 8) {
    float fa[8], fb[8];
    v8_to_floats(v8_load(a + ch), fa);
    v8_to_floats(v8_load(b + ch), fb);
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(fa[e], fb[e], s);
  }
  D[i] = s;
}

template <typename T, int NDF, bool MASKED, bool REM>
__global__ void __launch_bounds__(128) attn_bwd_dq_kernel(AttnBwdParams bp) {
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  constexpr int CH = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char a_smem[];
  const AttnParams& p = bp.a;
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(a_smem);                        // BQ x LDS
  T* dOs = Qs + BQ * LDS;                                      // BQ x LDS
  T* Ks = dOs + BQ * LDS;                                      // [2][BKV][LDS]
  T* Vs = Ks + 2 * A_BKV * LDS;                                // [2][BKV][LDS]
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * A_BKV * LDS);  // BQ
  float* D_s = lse_s + BQ;                                     // BQ
  float* Ps = D_s + BQ;                                        // fp32: warps x 16 x BKV

  const int wi = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const BwdWin w = bwd_window<REM>(p, wi);
  const int S = REM ? w.S : p.S, Sq = REM ? w.Sq : p.Sq;
  if (REM && q0 >= Sq) return;   // an edge window's spare query tiles
  const T* qb = reinterpret_cast<const T*>(p.q) + h * p.d;
  const T* kb = reinterpret_cast<const T*>(p.k) + h * p.d;
  const T* vb = reinterpret_cast<const T*>(p.v) + h * p.d;

  bwd_load_q<T, DP>(Qs, BQ, q0, Sq, p, w, qb, tid, blockDim.x);
  bwd_load_out<T, DP>(dOs, lse_s, D_s, BQ, q0, Sq, bp, w, wi, h, nh, tid,
                      blockDim.x);

  auto load_kv = [&](int buf, int kt) {
    constexpr int NCH = DP / CH;
    for (int idx = tid; idx < A_BKV * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * A_BKV + r;
      const bool valid = t < S && ch < p.d;
      const long long off =
          valid ? (w.krow0 + attn_rel(t, w.kvw, p.W)) * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * A_BKV + r) * LDS + ch, kb + off, valid);
      cp_async16(Vs + (buf * A_BKV + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (S + A_BKV - 1) / A_BKV;
  load_kv(0, 0);
  cp_async_commit();

  float dq[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[f][e] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nkt) load_kv(buf ^ 1, kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile kt (and, at kt = 0, the Q / dO tiles) landed
    const T* ks = Ks + buf * A_BKV * LDS;
    const T* vs = Vs + buf * A_BKV * LDS;
    float s[8][4], dp[8][4];
    tile_rows_dot<T, NDF>(s, Qs + warp * 16 * LDS, ks, p.d, lane);
    tile_rows_dot<T, NDF>(dp, dOs + warp * 16 * LDS, vs, p.d, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e >> 1);
        const int key = kt * A_BKV + j * 8 + q2 + (e & 1);
        float pv = 0.f;
        if (key < S) {
          float v = s[j][e] * p.scale;
          if constexpr (MASKED)
            if (q0 + row < Sq) v += p.mask[(long long)(q0 + row) * S + key];
          pv = expf(v - lse_s[row]);
        }
        s[j][e] = pv * (dp[j][e] - D_s[row]);
      }
    tile_p_rows<T, NDF>(dq, s, ks, Ps + warp * 16 * A_BKV, lane);
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }

  // the pad key's term: the four lanes of a row hold its columns between
  // them, so the two dot products are lane partials summed across them
  if (MASKED || (REM && w.pad)) {
    const T* pb = reinterpret_cast<const T*>(p.pad_bias);
    const T* kp = pb + p.c + h * p.d;
    const T* vp = pb + 2 * p.c + h * p.d;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = warp * 16 + g + 8 * hh, t = q0 + row;
      float sq = 0.f, sd = 0.f;
#pragma unroll
      for (int f = 0; f < NDT; ++f)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = f * 8 + q2 + i;
          if (col < p.d) {
            sq = fmaf(to_f(Qs[row * LDS + col]), to_f(kp[col]), sq);
            sd = fmaf(to_f(dOs[row * LDS + col]), to_f(vp[col]), sd);
          }
        }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      sd += __shfl_xor_sync(0xffffffffu, sd, 1);
      sd += __shfl_xor_sync(0xffffffffu, sd, 2);
      if (t >= Sq) continue;
      const float lm = MASKED ? p.logmult[t] : w.pad_logn;
      const float ds = expf(sq * p.scale + lm - lse_s[row]) * (sd - D_s[row]);
#pragma unroll
      for (int f = 0; f < NDT; ++f)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = f * 8 + q2 + i;
          if (col < p.d) dq[f][2 * hh + i] = fmaf(ds, to_f(kp[col]), dq[f][2 * hh + i]);
        }
    }
  }

  T* dqb = reinterpret_cast<T*>(bp.dqkv) + h * p.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col >= p.d) continue;
      const float v0 = dq[f][2 * hh] * p.scale, v1 = dq[f][2 * hh + 1] * p.scale;
      if (!p.qpool) {
        store2(dqb + (w.krow0 + attn_rel(t, w.kvw, p.W)) * bp.ld + col, v0, v1);
      } else {
        long long rows[4];
        float2 cand[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rows[i] = bwd_pool_row(p, w, t, i);
          cand[i] = load2(qb + rows[i] * p.q_ss + col);
        }
        int a0 = 0, a1 = 0;
#pragma unroll
        for (int i = 1; i < 4; ++i) {
          if (cand[i].x > cand[a0].x) a0 = i;
          if (cand[i].y > cand[a1].y) a1 = i;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          store2(dqb + rows[i] * bp.ld + col, i == a0 ? v0 : 0.f, i == a1 ? v1 : 0.f);
      }
    }
  }
}

template <typename T, int NDF, bool MASKED, bool REM>
__global__ void __launch_bounds__(128) attn_bwd_dkv_kernel(AttnBwdParams bp) {
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  extern __shared__ __align__(128) unsigned char a_smem[];
  const AttnParams& p = bp.a;
  const int BK = (blockDim.x >> 5) * 16;
  T* Kb = reinterpret_cast<T*>(a_smem);                        // BK x LDS
  T* Vb = Kb + BK * LDS;                                       // BK x LDS
  T* Qs = Vb + BK * LDS;                                       // BKV x LDS
  T* dOs = Qs + A_BKV * LDS;                                   // BKV x LDS
  float* lse_s = reinterpret_cast<float*>(dOs + A_BKV * LDS);  // BKV
  float* D_s = lse_s + A_BKV;                                  // BKV
  float* Ps = D_s + A_BKV;                                     // fp32: warps x 16 x BKV

  const int wi = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int k0 = blockIdx.z * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const BwdWin w = bwd_window<REM>(p, wi);
  const int S = REM ? w.S : p.S, Sq = REM ? w.Sq : p.Sq;
  if (REM && k0 >= S) return;    // an edge window's spare key tiles
  const T* qb = reinterpret_cast<const T*>(p.q) + h * p.d;
  const T* kb = reinterpret_cast<const T*>(p.k) + h * p.d;
  const T* vb = reinterpret_cast<const T*>(p.v) + h * p.d;

  for (int idx = tid; idx < BK * (DP / 8); idx += blockDim.x) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = k0 + r;
    V8<T> kv = v8_zero<T>(), vv = v8_zero<T>();
    if (t < S && ch < p.d) {
      const long long off = (w.krow0 + attn_rel(t, w.kvw, p.W)) * p.kv_ss + ch;
      kv = v8_load(kb + off);
      vv = v8_load(vb + off);
    }
    v8_store(Kb + r * LDS + ch, kv);
    v8_store(Vb + r * LDS + ch, vv);
  }

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[f][e] = dv[f][e] = 0.f;

  const int nqt = (Sq + A_BKV - 1) / A_BKV;
  for (int qt = 0; qt < nqt; ++qt) {
    __syncthreads();   // the previous query tile consumed
    bwd_load_q<T, DP>(Qs, A_BKV, qt * A_BKV, Sq, p, w, qb, tid, blockDim.x);
    bwd_load_out<T, DP>(dOs, lse_s, D_s, A_BKV, qt * A_BKV, Sq, bp, w, wi, h,
                        nh, tid, blockDim.x);
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_rows_dot<T, NDF>(s, Kb + warp * 16 * LDS, Qs, p.d, lane);   // (q k^T)^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + q2 + (e & 1), t = qt * A_BKV + col;
        float v = s[j][e] * p.scale;
        if constexpr (MASKED) {
          const int key = k0 + warp * 16 + g + 8 * (e >> 1);
          if (t < Sq && key < S) v += p.mask[(long long)t * S + key];
        }
        s[j][e] = t < Sq ? expf(v - lse_s[col]) : 0.f;
      }
    tile_p_rows<T, NDF>(dv, s, dOs, Ps + warp * 16 * A_BKV, lane);  // P^T dO
    tile_rows_dot<T, NDF>(dp, Vb + warp * 16 * LDS, dOs, p.d, lane);  // (dO v^T)^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= dp[j][e] - D_s[j * 8 + q2 + (e & 1)];
    tile_p_rows<T, NDF>(dk, s, Qs, Ps + warp * 16 * A_BKV, lane);   // dS^T q
  }

  T* dkb = reinterpret_cast<T*>(bp.dqkv) + p.c + h * p.d;
  T* dvb = reinterpret_cast<T*>(bp.dqkv) + 2 * p.c + h * p.d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + warp * 16 + g + 8 * hh;
    if (t >= S) continue;
    const long long row = (w.krow0 + attn_rel(t, w.kvw, p.W)) * bp.ld;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col >= p.d) continue;
      store2(dkb + row + col, dk[f][2 * hh] * p.scale, dk[f][2 * hh + 1] * p.scale);
      store2(dvb + row + col, dv[f][2 * hh], dv[f][2 * hh + 1]);
    }
  }
}

template <typename T, int NDF, bool MASKED, bool REM>
static cudaError_t launch_attn_bwd_t(const AttnBwdParams& bp, int n_windows,
                                     int nh, cudaStream_t stream) {
  const AttnParams& p = bp.a;
  // output rows: every window's queries; with REM the grid's tokens
  const long long nwin = (long long)((p.H + p.win - 1) / p.win)
                         * ((p.W + p.win - 1) / p.win);
  const long long out_rows = REM ? n_windows / nwin * p.H * p.W
                                 : (long long)n_windows * p.Sq;
  const long long nd = out_rows * nh;
  attn_bwd_rowdot_kernel<T><<<(unsigned)((nd + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const T*>(bp.o), reinterpret_cast<const T*>(bp.dout),
      bp.D, out_rows, p.c, nh, p.d);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  int warps = p.Sq >= 64 ? 4 : (p.Sq + 15) / 16;
  size_t smem = attn_bwd_smem_bytes(warps * 16, 4 * A_BKV, warps, 16 * NDF, sizeof(T));
  e = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, NDF, MASKED, REM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dq_kernel<T, NDF, MASKED, REM>
      <<<dim3(n_windows, nh, (p.Sq + warps * 16 - 1) / (warps * 16)), warps * 32,
         smem, stream>>>(bp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  warps = p.S >= 64 ? 4 : (p.S + 15) / 16;
  smem = attn_bwd_smem_bytes(warps * 16, 2 * A_BKV, warps, 16 * NDF, sizeof(T));
  e = cudaFuncSetAttribute(attn_bwd_dkv_kernel<T, NDF, MASKED, REM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  attn_bwd_dkv_kernel<T, NDF, MASKED, REM>
      <<<dim3(n_windows, nh, (p.S + warps * 16 - 1) / (warps * 16)), warps * 32,
         smem, stream>>>(bp);
  return cudaGetLastError();
}

template <bool MASKED = false, bool REM = false>
static cudaError_t launch_attn_bwd_dt(int is_bf16, const AttnBwdParams& bp,
                                      int n_windows, int nh, cudaStream_t stream) {
  static_assert(!(MASKED && REM), "one pad-key mode at a time");
  const AttnParams& p = bp.a;
  if (p.d % 8 || p.d > 96 || nh > 65535 || p.Sq < 1 || p.S < 1
      || (MASKED ? !p.mask || !p.logmult || !p.pad_bias || p.mode != 0
                       || p.qpool || p.Sq != p.S
          : REM  ? !p.pad_bias || p.mask || p.mode != 1 || p.qpool
                       || p.win < 1 || p.S != p.win * p.win || p.Sq != p.S
                 : p.pad_bias || p.mask)
      || (p.S + 15) / 16 > 65535 || (p.Sq + 15) / 16 > 65535)
    return cudaErrorInvalidValue;
  if (!REM && p.mode == 1
      && (p.H % p.win || p.W % p.win || (p.qpool && p.win % 2)))
    return cudaErrorInvalidValue;
  if (is_bf16) {
    if (p.d <= 64) return launch_attn_bwd_t<bf16, 4, MASKED, REM>(bp, n_windows, nh, stream);
    if (p.d <= 80) return launch_attn_bwd_t<bf16, 5, MASKED, REM>(bp, n_windows, nh, stream);
    return launch_attn_bwd_t<bf16, 6, MASKED, REM>(bp, n_windows, nh, stream);
  }
  if (p.d <= 64) return launch_attn_bwd_t<float, 4, MASKED, REM>(bp, n_windows, nh, stream);
  if (p.d <= 80) return launch_attn_bwd_t<float, 5, MASKED, REM>(bp, n_windows, nh, stream);
  return launch_attn_bwd_t<float, 6, MASKED, REM>(bp, n_windows, nh, stream);
}
