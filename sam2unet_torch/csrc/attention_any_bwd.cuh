// The attention backward at any head dim (attention_any.cuh's parameters):
// the delta pass D = rowsum(dO o), the dq pass and the dk/dv pass of
// attention_bwd.cuh (K5, K7, K9, K13 on a packed qkv buffer) and of
// flash_attention_bwd.cu (K11 on strided views), with every mode of theirs:
// the in-window q-pool (its gradient to the first maximum of each 2x2 cell,
// as max_pool2d's backward routes it), the masked rows (FORM 1) and the
// remainder grid's edge windows (FORM 2), both with the pad key's dq-only
// term.
//
// Design: the register tiles of attention_bwd.cuh (a warp's 16 rows against
// a 64-row tile, P and dS rounded to T as the operands of the next product,
// fp32 accumulation; mma.sync in bf16, CUDA-core dot products in fp32) over
// a head dim cut into DP = 16 * NDF wide chunks as in attention_any_fwd.cuh.
// A block owns one output chunk: the dq pass one (window, head, 16 * warps
// queries, chunk of dq), the dk/dv pass one (window, head, 16 * warps keys,
// chunk of dk and dv). Its scores q.k and dP = dO.v are summed over every
// chunk, each staged through shared memory in turn, and the products that
// make its outputs read only its own chunk of k (dq), or of dO and q (dv,
// dk), so the accumulators stay at 32 registers a lane each at any d; the
// scores are formed once per output chunk. Loads are element by element
// with zero fill past d (16-byte vectors where the host found d % 8 == 0
// and every stride and base aligned), stores element by element. The pad
// key's logit q.b_k and dO.b_v are full-d dot products read from global
// memory; its dS, P_pad (dO.b_v - D), adds dS b_k to dq as attention_bwd.cuh
// adds it. No atomics: each output element belongs to one block.
#pragma once

#include "attention_any_fwd.cuh"
#include "attention_bwd.cuh"

// Where window wi's tokens lie: attention_bwd.cuh's `bwd_window` in grid
// mode (rows krow0 + attn_rel(t, kvw, W) of the token grid, output rows
// orow0 + attn_rel(t, ovw, oW)); in rows mode every operand is addressed
// from its window's own base (X + wi * X_sb), so the rows start at 0.
template <bool REM>
__device__ __forceinline__ BwdWin any_bwd_window(const AttnParams& p, int wi) {
  BwdWin w = bwd_window<REM>(p, wi);
  if (p.mode == 0) w.krow0 = w.orow0 = 0;
  return w;
}

// The block's operands at window wi, head h: base pointers with the
// window's offset folded in.
template <typename T>
struct AnyBases {
  const T *q, *k, *v, *g;   // g: dO
  const float *D, *lse;
  T *dq, *dk, *dv;
};

template <typename T>
__device__ __forceinline__ AnyBases<T> any_bases(const AnyBwdParams& bp,
                                                 const BwdWin& w, int wi, int h,
                                                 int nh) {
  const AttnParams& p = bp.a;
  const long long wb = p.mode == 0 ? wi : 0;
  AnyBases<T> r;
  r.q = reinterpret_cast<const T*>(p.q) + wb * p.q_sb + h * p.q_sh + w.krow0 * p.q_ss;
  r.k = reinterpret_cast<const T*>(p.k) + wb * p.kv_sb + h * p.kv_sh + w.krow0 * p.kv_ss;
  r.v = reinterpret_cast<const T*>(p.v) + wb * p.kv_sb + h * p.kv_sh + w.krow0 * p.kv_ss;
  r.g = reinterpret_cast<const T*>(bp.dout) + wb * bp.do_sb + h * bp.do_sh
        + w.orow0 * bp.do_ss;
  r.D = bp.D + wb * bp.D_sb + h * bp.D_sh + w.orow0 * bp.D_ss;
  r.lse = bp.lse + ((long long)wi * nh + h) * p.Sq;
  r.dq = reinterpret_cast<T*>(bp.dq) + wb * bp.dq_sb + h * bp.dq_sh + w.krow0 * bp.dq_ss;
  r.dk = reinterpret_cast<T*>(bp.dk) + wb * bp.dkv_sb + h * bp.dkv_sh
         + w.krow0 * bp.dkv_ss;
  r.dv = reinterpret_cast<T*>(bp.dv) + wb * bp.dkv_sb + h * bp.dkv_sh
         + w.krow0 * bp.dkv_ss;
  return r;
}

// rows x DP chunk cc of queries t0.. (pooled with qpool)
template <typename T, int DP>
__device__ __forceinline__ void any_load_q(T* dst, int rows, int t0, int Sq, int cc,
                                           const AttnParams& p, const BwdWin& w,
                                           const T* qb, bool vec, int tid, int nthr) {
  if (p.qpool)
    any_load_pooled<T, DP>(dst, rows, t0, Sq, cc * DP, p.d, qb, p.q_ss, w.kvw,
                           p.W, p.win, tid, nthr);
  else
    any_load_rows<T, DP>(dst, rows, t0, Sq, cc * DP, p.d, qb, p.q_ss, w.kvw, p.W,
                         vec, tid, nthr);
}

// D = rowsum(dO * o), one thread per (entry b, row t, head h).
template <typename T>
__global__ void __launch_bounds__(256) any_delta_kernel(AnyBwdParams p,
                                                        long long rows, int nh,
                                                        long long n) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const int h = (int)(i % nh);
  const long long bt = i / nh;
  const long long t = bt % rows, b = bt / rows;
  const T* a = reinterpret_cast<const T*>(p.o) + b * p.o_sb + t * p.o_ss + h * p.o_sh;
  const T* g = reinterpret_cast<const T*>(p.dout) + b * p.do_sb + t * p.do_ss
               + h * p.do_sh;
  float s = 0.f;
  for (int ch = 0; ch < p.a.d; ++ch) s = fmaf(to_f(a[ch]), to_f(g[ch]), s);
  p.D[b * p.D_sb + t * p.D_ss + h * p.D_sh] = s;
}

template <typename T, int NDF, int FORM>
__global__ void __launch_bounds__(128) any_bwd_dq_kernel(AnyBwdParams bp, int nchunk,
                                                         int vec) {
  constexpr bool MASKED = FORM == 1, REM = FORM == 2;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  extern __shared__ __align__(128) unsigned char a_smem[];
  const AttnParams& p = bp.a;
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(a_smem);                        // BQ x LDS
  T* Gs = Qs + BQ * LDS;                                       // BQ x LDS: dO
  T* Ks = Gs + BQ * LDS;                                       // 64 x LDS
  T* Vs = Ks + 64 * LDS;                                       // 64 x LDS
  float* lse_s = reinterpret_cast<float*>(Vs + 64 * LDS);      // BQ
  float* D_s = lse_s + BQ;                                     // BQ
  float* dsp = D_s + BQ;                                       // BQ: pad key's dS
  float* Ps = dsp + BQ;                                        // fp32: warps x 16 x 64

  const int wi = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int qt = blockIdx.z / nchunk, oc = blockIdx.z - qt * nchunk;
  const int q0 = qt * BQ, c_out = oc * DP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nthr = blockDim.x;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const BwdWin w = any_bwd_window<REM>(p, wi);
  const int S = w.S, Sq = w.Sq, d = p.d;
  if (q0 >= Sq) return;   // an edge window's spare query tiles
  const AnyBases<T> B = any_bases<T>(bp, w, wi, h, nh);
  const bool one = nchunk == 1, v8 = vec != 0;

  for (int r = tid; r < BQ; r += nthr) {
    const int t = q0 + r;
    const bool ok = t < Sq;
    lse_s[r] = ok ? B.lse[t] : 0.f;
    D_s[r] = ok ? B.D[attn_rel(t, w.ovw, w.oW) * bp.D_ss] : 0.f;
  }

  // the pad key's dS of the warp's rows: P_pad (dO.b_v - D), P_pad =
  // exp(q.b_k * scale + log-multiplicity - lse), full-d dot products
  const bool pad = MASKED || (REM && w.pad);
  const T* kp = reinterpret_cast<const T*>(p.pad_bias) + p.c + h * d;
  const T* vp = reinterpret_cast<const T*>(p.pad_bias) + 2 * p.c + h * d;
  if (pad) {
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i, t = q0 + r;
      float sq = 0.f, sd = 0.f;
      if (t < Sq) {
        const T* qr = B.q + attn_rel(t, w.kvw, p.W) * p.q_ss;
        const T* gr = B.g + attn_rel(t, w.ovw, w.oW) * bp.do_ss;
        for (int ch = lane; ch < d; ch += 32) {
          sq = fmaf(to_f(qr[ch]), to_f(kp[ch]), sq);
          sd = fmaf(to_f(gr[ch]), to_f(vp[ch]), sd);
        }
      }
      sq = warp_sum(sq);
      sd = warp_sum(sd);
      if (lane == 0) {
        float ds = 0.f;
        if (t < Sq) {
          const float lm = MASKED ? p.logmult[t] : w.pad_logn;
          ds = expf(sq * p.scale + lm - B.lse[t])
               * (sd - B.D[attn_rel(t, w.ovw, w.oW) * bp.D_ss]);
        }
        dsp[r] = ds;
      }
    }
    __syncwarp();
  }

  float dq[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[f][e] = 0.f;

  const int nkt = (S + 63) / 64;
  for (int kt = 0; kt < nkt; ++kt) {
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int cc = 0; cc < nchunk; ++cc) {
      __syncthreads();   // the previous stage's chunks consumed
      if (!one || kt == 0) {
        any_load_q<T, DP>(Qs, BQ, q0, Sq, cc, p, w, B.q, v8, tid, nthr);
        any_load_rows<T, DP>(Gs, BQ, q0, Sq, cc * DP, d, B.g, bp.do_ss, w.ovw, w.oW,
                             v8, tid, nthr);
      }
      any_load_rows<T, DP>(Ks, 64, kt * 64, S, cc * DP, d, B.k, p.kv_ss, w.kvw, p.W,
                           v8, tid, nthr);
      any_load_rows<T, DP>(Vs, 64, kt * 64, S, cc * DP, d, B.v, p.kv_ss, w.kvw, p.W,
                           v8, tid, nthr);
      __syncthreads();
      const int nc = min(DP, d - cc * DP);
      any_rows_dot<T, NDF>(s, Qs + warp * 16 * LDS, Ks, nc, lane);
      any_rows_dot<T, NDF>(dp, Gs + warp * 16 * LDS, Vs, nc, lane);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e >> 1);
        const int key = kt * 64 + j * 8 + q2 + (e & 1);
        float pv = 0.f;
        if (key < S) {
          float v = s[j][e] * p.scale;
          if constexpr (MASKED)
            if (q0 + row < Sq) v += p.mask[(long long)(q0 + row) * S + key];
          pv = expf(v - lse_s[row]);
        }
        s[j][e] = pv * (dp[j][e] - D_s[row]);
      }
    if (!one && oc != nchunk - 1) {   // this block's chunk of k
      __syncthreads();
      any_load_rows<T, DP>(Ks, 64, kt * 64, S, c_out, d, B.k, p.kv_ss, w.kvw, p.W,
                           v8, tid, nthr);
      __syncthreads();
    }
    tile_p_rows<T, NDF>(dq, s, Ks, Ps + warp * 16 * 64, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh, t = q0 + row;
    if (t >= Sq) continue;
    const float ds_pad = pad ? dsp[row] : 0.f;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c_out + f * 8 + q2 + i;
        if (col >= d) continue;
        float v = dq[f][2 * hh + i];
        if (pad) v = fmaf(ds_pad, to_f(kp[col]), v);
        v *= p.scale;
        if (!p.qpool) {
          B.dq[attn_rel(t, w.kvw, p.W) * bp.dq_ss + col] = from_f<T>(v);
        } else {
          const int hw = p.win / 2, ty = t / hw, tx = t - ty * hw;
          long long rows[4];
          int a = 0;
          float best = -INFINITY;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            rows[k] = attn_rel((2 * ty + (k >> 1)) * p.win + 2 * tx + (k & 1), w.kvw, p.W);
            const float c = to_f(B.q[rows[k] * p.q_ss + col]);
            if (k == 0 || c > best) { best = c; a = k; }
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            B.dq[rows[k] * bp.dq_ss + col] = from_f<T>(k == a ? v : 0.f);
        }
      }
  }
}

template <typename T, int NDF, int FORM>
__global__ void __launch_bounds__(128) any_bwd_dkv_kernel(AnyBwdParams bp, int nchunk,
                                                          int vec) {
  constexpr bool MASKED = FORM == 1, REM = FORM == 2;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  extern __shared__ __align__(128) unsigned char a_smem[];
  const AttnParams& p = bp.a;
  const int BK = (blockDim.x >> 5) * 16;
  T* Kb = reinterpret_cast<T*>(a_smem);                        // BK x LDS
  T* Vb = Kb + BK * LDS;                                       // BK x LDS
  T* Qs = Vb + BK * LDS;                                       // 64 x LDS
  T* Gs = Qs + 64 * LDS;                                       // 64 x LDS: dO
  float* lse_s = reinterpret_cast<float*>(Gs + 64 * LDS);      // 64
  float* D_s = lse_s + 64;                                     // 64
  float* Ps = D_s + 64;                                        // fp32: warps x 16 x 64

  const int wi = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int kt = blockIdx.z / nchunk, oc = blockIdx.z - kt * nchunk;
  const int k0 = kt * BK, c_out = oc * DP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nthr = blockDim.x;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const BwdWin w = any_bwd_window<REM>(p, wi);
  const int S = w.S, Sq = w.Sq, d = p.d;
  if (k0 >= S) return;   // an edge window's spare key tiles
  const AnyBases<T> B = any_bases<T>(bp, w, wi, h, nh);
  const bool one = nchunk == 1, v8 = vec != 0;

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[f][e] = dv[f][e] = 0.f;

  const int nqt = (Sq + 63) / 64;
  for (int qt = 0; qt < nqt; ++qt) {
    const int t0 = qt * 64;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    for (int cc = 0; cc < nchunk; ++cc) {
      __syncthreads();   // the previous stage's chunks consumed
      if (!one || qt == 0) {
        any_load_rows<T, DP>(Kb, BK, k0, S, cc * DP, d, B.k, p.kv_ss, w.kvw, p.W, v8,
                             tid, nthr);
        any_load_rows<T, DP>(Vb, BK, k0, S, cc * DP, d, B.v, p.kv_ss, w.kvw, p.W, v8,
                             tid, nthr);
      }
      any_load_q<T, DP>(Qs, 64, t0, Sq, cc, p, w, B.q, v8, tid, nthr);
      any_load_rows<T, DP>(Gs, 64, t0, Sq, cc * DP, d, B.g, bp.do_ss, w.ovw, w.oW, v8,
                           tid, nthr);
      if (cc == 0)
        for (int r = tid; r < 64; r += nthr) {
          const int t = t0 + r;
          const bool ok = t < Sq;
          lse_s[r] = ok ? B.lse[t] : 0.f;
          D_s[r] = ok ? B.D[attn_rel(t, w.ovw, w.oW) * bp.D_ss] : 0.f;
        }
      __syncthreads();
      const int nc = min(DP, d - cc * DP);
      any_rows_dot<T, NDF>(s, Kb + warp * 16 * LDS, Qs, nc, lane);    // (q k^T)^T
      any_rows_dot<T, NDF>(dp, Vb + warp * 16 * LDS, Gs, nc, lane);   // (dO v^T)^T
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + q2 + (e & 1), t = t0 + col;
        float v = s[j][e] * p.scale;
        if constexpr (MASKED) {
          const int key = k0 + warp * 16 + g + 8 * (e >> 1);
          if (t < Sq && key < S) v += p.mask[(long long)t * S + key];
        }
        s[j][e] = t < Sq ? expf(v - lse_s[col]) : 0.f;
      }
    if (!one && oc != nchunk - 1) {   // this block's chunk of q and dO
      __syncthreads();
      any_load_q<T, DP>(Qs, 64, t0, Sq, oc, p, w, B.q, v8, tid, nthr);
      any_load_rows<T, DP>(Gs, 64, t0, Sq, c_out, d, B.g, bp.do_ss, w.ovw, w.oW, v8,
                           tid, nthr);
      __syncthreads();
    }
    tile_p_rows<T, NDF>(dv, s, Gs, Ps + warp * 16 * 64, lane);   // P^T dO
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - D_s[j * 8 + q2 + (e & 1)];
    tile_p_rows<T, NDF>(dk, s, Qs, Ps + warp * 16 * 64, lane);   // dS^T q
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + warp * 16 + g + 8 * hh;
    if (t >= S) continue;
    const long long row = attn_rel(t, w.kvw, p.W) * bp.dkv_ss;
#pragma unroll
    for (int f = 0; f < NDT; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c_out + f * 8 + q2 + i;
        if (col >= d) continue;
        B.dk[row + col] = from_f<T>(dk[f][2 * hh + i] * p.scale);
        B.dv[row + col] = from_f<T>(dv[f][2 * hh + i]);
      }
  }
}

// Whether the loads may be 16-byte vectors (q, k, v and dO).
inline bool any_bwd_vec(const AnyBwdParams& bp) {
  const AttnParams& p = bp.a;
  return views_vec16(p.d, {p.q_sb, p.q_ss, p.q_sh, p.kv_sb, p.kv_ss, p.kv_sh,
                           bp.do_sb, bp.do_ss, bp.do_sh},
                     {p.q, p.k, p.v, bp.dout});
}

template <typename T, int NDF, int FORM>
static cudaError_t launch_any_bwd_t(bool dkv, const AnyBwdParams& bp, int n_windows,
                                    int nh, cudaStream_t stream) {
  const AttnParams& p = bp.a;
  constexpr int DP = 16 * NDF;
  const int nchunk = (p.d + DP - 1) / DP, vec = any_bwd_vec(bp);
  const size_t ts = sizeof(T), lds = DP + 8;
  const int rows = dkv ? p.S : p.Sq;
  const int warps = rows >= 64 ? 4 : (rows + 15) / 16, br = warps * 16;
  const long long nz = (long long)((rows + br - 1) / br) * nchunk;
  if (nz > 65535) return cudaErrorInvalidValue;
  size_t smem = ts * lds * (2 * br + 128)
                + sizeof(float) * (dkv ? 2 * 64 : 3 * br);
  if (ts == sizeof(float)) smem += sizeof(float) * warps * 16 * 64;
  const dim3 grid(n_windows, nh, (unsigned)nz);
  cudaError_t e;
  if (!dkv) {
    e = cudaFuncSetAttribute(any_bwd_dq_kernel<T, NDF, FORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    any_bwd_dq_kernel<T, NDF, FORM><<<grid, warps * 32, smem, stream>>>(bp, nchunk, vec);
  } else {
    e = cudaFuncSetAttribute(any_bwd_dkv_kernel<T, NDF, FORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    any_bwd_dkv_kernel<T, NDF, FORM><<<grid, warps * 32, smem, stream>>>(bp, nchunk, vec);
  }
  return cudaGetLastError();
}

template <int FORM>
static cudaError_t launch_any_bwd(int is_bf16, bool dkv, const AnyBwdParams& bp,
                                  int n_windows, int nh, cudaStream_t stream) {
  const AttnParams& p = bp.a;
  if (p.d < 1 || nh < 1 || nh > 65535 || n_windows < 1 || p.Sq < 1 || p.S < 1
      || (FORM == 1 ? !p.mask || !p.logmult || !p.pad_bias || p.mode != 0
                          || p.qpool || p.Sq != p.S
          : FORM == 2 ? !p.pad_bias || p.mask || p.mode != 1 || p.qpool
                            || p.win < 1 || p.S != p.win * p.win || p.Sq != p.S
                      : p.pad_bias || p.mask))
    return cudaErrorInvalidValue;
  if (FORM == 0 && p.mode == 1
      && (p.win < 1 || p.H % p.win || p.W % p.win || (p.qpool && p.win % 2)))
    return cudaErrorInvalidValue;
  const int ndf = attn_any_ndf(p.d);
  if (is_bf16) {
    if (ndf == 1) return launch_any_bwd_t<bf16, 1, FORM>(dkv, bp, n_windows, nh, stream);
    if (ndf == 2) return launch_any_bwd_t<bf16, 2, FORM>(dkv, bp, n_windows, nh, stream);
    return launch_any_bwd_t<bf16, 4, FORM>(dkv, bp, n_windows, nh, stream);
  }
  if (ndf == 1) return launch_any_bwd_t<float, 1, FORM>(dkv, bp, n_windows, nh, stream);
  if (ndf == 2) return launch_any_bwd_t<float, 2, FORM>(dkv, bp, n_windows, nh, stream);
  return launch_any_bwd_t<float, 4, FORM>(dkv, bp, n_windows, nh, stream);
}
