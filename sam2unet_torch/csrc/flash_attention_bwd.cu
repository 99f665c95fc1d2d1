// K11: the backward of the streaming flash attention (flash_attention.cu),
// dq, dk and dv of softmax(q k^T * scale) v over (B, S, heads, d) from q, k,
// v, the forward's o and lse, and dO.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_bwd_dq_kernel
// (:219) and ::_stream_bwd_dkv_kernel (:254), both launched by
// _stream_bwd_impl (:314, :336), and the delta it computes beside them
// (:306). Runs in the backward of the long global-attention blocks (S = 3600
// at hiera_s@960), one call per block and train step.
//
// Bound on an H100: seven S_q x S_k x d products per (batch, head) (scores
// and dP in each pass, dQ, dV, dK: 14 * S_q * S_k * d FLOPs) against
// ~8 * S * d elements moved, so at S = 3600 it is bound by operations.
//
// Routes (the wrapper, ops/flash_attention.py, picks the library): bf16 at
// d % 8 == 0 up to 256 on views a tensor map can address runs the dq and
// dk/dv passes in flash_attention_bwd_sm90.cu (wgmma fed by TMA; its bound
// and design note there). This file keeps the delta pass (both types,
// 16-byte loads at any d % 8 == 0 on such views) and the fp32 dq and dk/dv
// passes at d % 8 == 0 up to 96 on them, and sends every other call (any
// head dim or view, bf16 included) to attention_any_bwd.cu.
//
// Design of the fp32 passes: those of attention_bwd.cuh (the same loops
// over the register-tile products of attention_bwd_tiles.cuh) over K10's interface
// instead of a packed qkv buffer: q, k, v, dO and o are (B, S, heads, d)
// views with unit stride over d and element strides for batch, token and
// head, S_q and S_k independent, lse and D (B*heads, S_q) fp32, and dq, dk,
// dv are written through strided views of the caller's choice (the long
// block hands in the three channel blocks of one (rows, 3c) dqkv buffer, so
// no copy is made). Three entry points:
//   delta:  D = rowsum(dO * o) per (batch, head, query), from the forward's
//           rounded o, fp32;
//   dq:     one block per (batch, head, 64 queries); keys and values stream
//           in 64-token tiles through a double-buffered cp.async ring;
//           P = exp(q k^T * scale - lse), dP = dO v^T, dS = P (dP - D),
//           dq += dS k, scaled once at the end;
//   dk/dv:  one block per (batch, head, 64 keys); queries, dO, lse and D
//           stream in 64-token tiles through the same kind of ring; P^T = exp(k q^T * scale - lse),
//           dv += P^T dO, dP^T = v dO^T, dS^T = P^T (dP^T - D), dk += dS^T q.
// Every product accumulates in fp32 (CUDA-core dot products in mma.sync's
// register layout). No atomics: each output row belongs to one block. The
// TPU kernels need block sizes that divide S (_pick_stream_blocks); here the
// ragged last tile of keys and of queries is zero-filled and masked, so any
// S_q and S_k work. These kernels take d % 8 == 0 up to 96 at strides in
// multiples of 8 elements and 16-byte aligned bases (`flash_bwd_vec`); every
// other head dim or view runs the same passes in attention_any_bwd.cu
// (attention_any.cuh), one launch each.

#include "attention_any.cuh"
#include "attention_bwd_tiles.cuh"

struct FlashBwdParams {
  const void *q, *k, *v, *dout, *o;   // head 0 of token 0 of batch 0
  long long q_sb, q_ss, q_sh;         // element strides: batch, token, head
  long long kv_sb, kv_ss, kv_sh;      // k and v
  long long do_sb, do_ss, do_sh;      // dO
  long long o_sb, o_ss, o_sh;         // o (delta pass)
  const float* lse;                   // (B * heads, Sq)
  float* D;                                                    // (B * heads, Sq)
  void *dq, *dk, *dv;
  long long dq_sb, dq_ss, dq_sh;
  long long dkv_sb, dkv_ss, dkv_sh;   // dk and dv
  int Sq, Sk, d;
  float scale;
};

// D[(b * nh + h) * Sq + t] = sum over d of dO * o; G lanes (a power of two
// up to 32, at least d / 8 where it can) per (b, t, h) row, so that a row's
// 16-byte loads are neighbouring, each lane's 8-element chunks summed, then
// the G lanes' sums by shuffles.
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(FlashBwdParams p,
                                                              long long n, int nh,
                                                              int G) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) / G;
  const int sub = threadIdx.x & (G - 1);
  float s = 0.f;
  const bool live = i < n;   // every lane of the warp takes part in the sums
  const int h = (int)(i % nh);
  const long long bt = i / nh;
  const int t = (int)(bt % p.Sq);
  const long long b = bt / p.Sq;
  if (live) {
    const T* a = reinterpret_cast<const T*>(p.o) + b * p.o_sb + t * p.o_ss + h * p.o_sh;
    const T* g = reinterpret_cast<const T*>(p.dout) + b * p.do_sb + t * p.do_ss
                 + h * p.do_sh;
    for (int ch = 8 * sub; ch < p.d; ch += 8 * G) {
      float fa[8], fb[8];
      v8_to_floats(v8_load(a + ch), fa);
      v8_to_floats(v8_load(g + ch), fb);
#pragma unroll
      for (int e = 0; e < 8; ++e) s = fmaf(fa[e], fb[e], s);
    }
  }
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (live && sub == 0) p.D[(b * nh + h) * p.Sq + t] = s;
}

// rows x DP tile of token rows t0.. of a strided (S, d) head view (zero past
// S and d).
template <typename T, int DP>
__device__ __forceinline__ void flash_load_rows(T* dst, int rows, int t0, int S,
                                                int d, const T* base,
                                                long long ss, int tid, int nthr) {
  constexpr int LDS = DP + 8;
  for (int idx = tid; idx < rows * (DP / 8); idx += nthr) {
    const int r = idx / (DP / 8), ch = (idx - r * (DP / 8)) * 8, t = t0 + r;
    V8<T> val = v8_zero<T>();
    if (t < S && ch < d) val = v8_load(base + t * ss + ch);
    v8_store(dst + r * LDS + ch, val);
  }
}

template <int NDF>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(FlashBwdParams p) {
  using T = float;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  constexpr int CH = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char a_smem[];
  const int BQ = (blockDim.x >> 5) * 16;
  T* Qs = reinterpret_cast<T*>(a_smem);                        // BQ x LDS
  T* dOs = Qs + BQ * LDS;                                      // BQ x LDS
  T* Ks = dOs + BQ * LDS;                                      // [2][TILE][LDS]
  T* Vs = Ks + 2 * BWD_TILE * LDS;                             // [2][TILE][LDS]
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BWD_TILE * LDS); // BQ
  float* D_s = lse_s + BQ;                                     // BQ
  float* Ps = D_s + BQ;                                        // fp32: warps x 16 x TILE

  const int b = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int q0 = blockIdx.z * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int S = p.Sk, Sq = p.Sq;
  const T* qb = reinterpret_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const T* gb = reinterpret_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long row0 = ((long long)b * nh + h) * Sq;   // into lse and D

  flash_load_rows<T, DP>(Qs, BQ, q0, Sq, p.d, qb, p.q_ss, tid, blockDim.x);
  flash_load_rows<T, DP>(dOs, BQ, q0, Sq, p.d, gb, p.do_ss, tid, blockDim.x);
  for (int r = tid; r < BQ; r += blockDim.x) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? p.lse[row0 + q0 + r] : 0.f;
    D_s[r] = ok ? p.D[row0 + q0 + r] : 0.f;
  }

  auto load_kv = [&](int buf, int kt) {
    constexpr int NCH = DP / CH;
    for (int idx = tid; idx < BWD_TILE * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = kt * BWD_TILE + r;
      const bool valid = t < S && ch < p.d;
      const long long off = valid ? t * p.kv_ss + ch : 0;
      cp_async16(Ks + (buf * BWD_TILE + r) * LDS + ch, kb + off, valid);
      cp_async16(Vs + (buf * BWD_TILE + r) * LDS + ch, vb + off, valid);
    }
  };
  const int nkt = (S + BWD_TILE - 1) / BWD_TILE;
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
    const T* ks = Ks + buf * BWD_TILE * LDS;
    const T* vs = Vs + buf * BWD_TILE * LDS;
    float s[8][4], dp[8][4];
    tile_rows_dot<T, NDF>(s, Qs + warp * 16 * LDS, ks, p.d, lane);
    tile_rows_dot<T, NDF>(dp, dOs + warp * 16 * LDS, vs, p.d, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e >> 1);
        const int key = kt * BWD_TILE + j * 8 + q2 + (e & 1);
        const float pv = key < S ? expf(s[j][e] * p.scale - lse_s[row]) : 0.f;
        s[j][e] = pv * (dp[j][e] - D_s[row]);
      }
    tile_p_rows<T, NDF>(dq, s, ks, Ps + warp * 16 * BWD_TILE, lane);
    __syncthreads();   // buffer kt consumed before iteration kt+1 refills it
  }

  T* dqb = reinterpret_cast<T*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = q0 + warp * 16 + g + 8 * hh;
    if (t >= Sq) continue;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col < p.d)
        store2(dqb + t * p.dq_ss + col, dq[f][2 * hh] * p.scale,
               dq[f][2 * hh + 1] * p.scale);
    }
  }
}

template <int NDF>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(FlashBwdParams p) {
  using T = float;
  constexpr int DP = 16 * NDF, LDS = DP + 8, NDT = 2 * NDF;
  constexpr int CH = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char a_smem[];
  const int BK = (blockDim.x >> 5) * 16;
  T* Kb = reinterpret_cast<T*>(a_smem);                        // BK x LDS
  T* Vb = Kb + BK * LDS;                                       // BK x LDS
  T* Qs = Vb + BK * LDS;                                       // [2][TILE][LDS]
  T* dOs = Qs + 2 * BWD_TILE * LDS;                            // [2][TILE][LDS]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BWD_TILE * LDS);  // [2][TILE]
  float* D_s = lse_s + 2 * BWD_TILE;                           // [2][TILE]
  float* Ps = D_s + 2 * BWD_TILE;                              // fp32: warps x 16 x TILE

  const int b = blockIdx.x, h = blockIdx.y, nh = gridDim.y;
  const int k0 = blockIdx.z * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q2 = (lane & 3) * 2;
  const int S = p.Sk, Sq = p.Sq;
  const T* qb = reinterpret_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = reinterpret_cast<const T*>(p.k) + b * p.kv_sb + h * p.kv_sh;
  const T* vb = reinterpret_cast<const T*>(p.v) + b * p.kv_sb + h * p.kv_sh;
  const T* gb = reinterpret_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const long long row0 = ((long long)b * nh + h) * Sq;   // into lse and D

  flash_load_rows<T, DP>(Kb, BK, k0, S, p.d, kb, p.kv_ss, tid, blockDim.x);
  flash_load_rows<T, DP>(Vb, BK, k0, S, p.d, vb, p.kv_ss, tid, blockDim.x);

  // queries, dO, lse and D of tile qt into ring slot buf
  auto load_q = [&](int buf, int qt) {
    constexpr int NCH = DP / CH;
    const int t0 = qt * BWD_TILE;
    for (int idx = tid; idx < BWD_TILE * NCH; idx += blockDim.x) {
      const int r = idx / NCH, ch = (idx - r * NCH) * CH, t = t0 + r;
      const bool valid = t < Sq && ch < p.d;
      cp_async16(Qs + (buf * BWD_TILE + r) * LDS + ch,
                 qb + (valid ? t * p.q_ss + ch : 0), valid);
      cp_async16(dOs + (buf * BWD_TILE + r) * LDS + ch,
                 gb + (valid ? t * p.do_ss + ch : 0), valid);
    }
    for (int r = tid; r < BWD_TILE; r += blockDim.x) {
      const bool ok = t0 + r < Sq;
      lse_s[buf * BWD_TILE + r] = ok ? p.lse[row0 + t0 + r] : 0.f;
      D_s[buf * BWD_TILE + r] = ok ? p.D[row0 + t0 + r] : 0.f;
    }
  };
  const int nqt = (Sq + BWD_TILE - 1) / BWD_TILE;
  load_q(0, 0);
  cp_async_commit();

  float dk[NDT][4], dv[NDT][4];
#pragma unroll
  for (int f = 0; f < NDT; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[f][e] = dv[f][e] = 0.f;

  for (int qt = 0; qt < nqt; ++qt) {
    const int buf = qt & 1, t0 = qt * BWD_TILE;
    if (qt + 1 < nqt) load_q(buf ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // tile qt (and, at qt = 0, the K / V tiles) landed
    const T* qs = Qs + buf * BWD_TILE * LDS;
    const T* gs = dOs + buf * BWD_TILE * LDS;
    const float* lse_t = lse_s + buf * BWD_TILE;
    const float* D_t = D_s + buf * BWD_TILE;
    float s[8][4], dp[8][4];
    tile_rows_dot<T, NDF>(s, Kb + warp * 16 * LDS, qs, p.d, lane);   // (q k^T)^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + q2 + (e & 1);
        s[j][e] = t0 + col < Sq ? expf(s[j][e] * p.scale - lse_t[col]) : 0.f;
      }
    tile_p_rows<T, NDF>(dv, s, gs, Ps + warp * 16 * BWD_TILE, lane);  // P^T dO
    tile_rows_dot<T, NDF>(dp, Vb + warp * 16 * LDS, gs, p.d, lane);  // (dO v^T)^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] *= dp[j][e] - D_t[j * 8 + q2 + (e & 1)];
    tile_p_rows<T, NDF>(dk, s, qs, Ps + warp * 16 * BWD_TILE, lane);   // dS^T q
    __syncthreads();   // slot buf consumed before iteration qt+1 refills it
  }

  T* dkb = reinterpret_cast<T*>(p.dk) + b * p.dkv_sb + h * p.dkv_sh;
  T* dvb = reinterpret_cast<T*>(p.dv) + b * p.dkv_sb + h * p.dkv_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int t = k0 + warp * 16 + g + 8 * hh;
    if (t >= S) continue;
#pragma unroll
    for (int f = 0; f < NDT; ++f) {
      const int col = f * 8 + q2;
      if (col >= p.d) continue;
      store2(dkb + t * p.dkv_ss + col, dk[f][2 * hh] * p.scale,
             dk[f][2 * hh + 1] * p.scale);
      store2(dvb + t * p.dkv_ss + col, dv[f][2 * hh], dv[f][2 * hh + 1]);
    }
  }
}

static bool flash_bwd_valid(const FlashBwdParams& p, int B, int nh) {
  return p.d >= 1 && B >= 1 && nh >= 1 && nh <= 65535 && p.Sq >= 1
         && p.Sk >= 1 && (p.Sq + 15) / 16 <= 65535 && (p.Sk + 15) / 16 <= 65535;
}

// Whether the dq and dk/dv kernels' 16-byte loads (and 8-byte stores)
// reach every view.
static bool flash_bwd_vec(const FlashBwdParams& p) {
  return attn_vec_head_dim(p.d)
         && views_vec16(p.d, {p.q_sb, p.q_ss, p.q_sh, p.kv_sb, p.kv_ss, p.kv_sh,
                              p.do_sb, p.do_ss, p.do_sh, p.o_sb, p.o_ss, p.o_sh,
                              p.dq_sb, p.dq_ss, p.dq_sh, p.dkv_sb, p.dkv_ss,
                              p.dkv_sh},
                        {p.q, p.k, p.v, p.dout, p.o, p.dq, p.dk, p.dv});
}

// The views as attention_any_bwd.cu takes them: rows mode, one window per
// batch entry; D and the lse (B * heads, Sq).
static AnyBwdParams flash_bwd_any(const FlashBwdParams& p, int nh) {
  AnyBwdParams a = {};
  AttnParams& ap = a.a;
  ap.q = p.q; ap.k = p.k; ap.v = p.v;
  ap.q_sb = p.q_sb; ap.q_ss = p.q_ss; ap.q_sh = p.q_sh;
  ap.kv_sb = p.kv_sb; ap.kv_ss = p.kv_ss; ap.kv_sh = p.kv_sh;
  ap.c = nh * p.d; ap.d = p.d; ap.mode = 0; ap.S = p.Sk; ap.Sq = p.Sq;
  ap.scale = p.scale;
  a.o = p.o; a.o_sb = p.o_sb; a.o_ss = p.o_ss; a.o_sh = p.o_sh;
  a.dout = p.dout; a.do_sb = p.do_sb; a.do_ss = p.do_ss; a.do_sh = p.do_sh;
  a.lse = p.lse;
  a.D = p.D; a.D_sb = (long long)nh * p.Sq; a.D_ss = 1; a.D_sh = p.Sq;
  a.dq = p.dq; a.dq_sb = p.dq_sb; a.dq_ss = p.dq_ss; a.dq_sh = p.dq_sh;
  a.dk = p.dk; a.dv = p.dv;
  a.dkv_sb = p.dkv_sb; a.dkv_ss = p.dkv_ss; a.dkv_sh = p.dkv_sh;
  return a;
}

template <int NDF>
static cudaError_t launch_flash_bwd_dq_t(const FlashBwdParams& p, int B, int nh,
                                         cudaStream_t stream) {
  const int warps = p.Sq >= 64 ? 4 : (p.Sq + 15) / 16;
  const size_t smem = attn_bwd_smem_bytes(warps * 16, 4 * BWD_TILE, warps, 16 * NDF,
                                          sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<NDF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<NDF><<<dim3(B, nh, (p.Sq + warps * 16 - 1) / (warps * 16)),
                                warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NDF>
static cudaError_t launch_flash_bwd_dkv_t(const FlashBwdParams& p, int B, int nh,
                                          cudaStream_t stream) {
  const int warps = p.Sk >= 64 ? 4 : (p.Sk + 15) / 16;
  // K, V tiles and the ring of two (Q, dO, lse, D) tiles
  const size_t smem = attn_bwd_smem_bytes(warps * 16, 4 * BWD_TILE, warps, 16 * NDF,
                                          sizeof(float))
                      + sizeof(float) * 2 * BWD_TILE;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<NDF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<NDF><<<dim3(B, nh, (p.Sk + warps * 16 - 1) / (warps * 16)),
                                 warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// fp32 at the head dims of the SAM2 trunks (56 (b+), 72 (l), 96 (t, s)) on
// the instances above; bf16, and every other head dim or view, on
// attention_any_bwd.cu (the wrapper sends bf16 that a tensor map can address
// to flash_attention_bwd_sm90.cu instead)
static cudaError_t launch_flash_bwd(int is_bf16, bool dkv, const FlashBwdParams& p,
                                    int B, int nh, cudaStream_t stream) {
  if (!flash_bwd_valid(p, B, nh)) return cudaErrorInvalidValue;
  if (is_bf16 || !flash_bwd_vec(p)) {
    const AnyBwdParams a = flash_bwd_any(p, nh);
    return (cudaError_t)attn_any_bwd(is_bf16, dkv, &a, B, nh, stream);
  }
  if (p.d <= 64)
    return dkv ? launch_flash_bwd_dkv_t<4>(p, B, nh, stream)
               : launch_flash_bwd_dq_t<4>(p, B, nh, stream);
  if (p.d <= 80)
    return dkv ? launch_flash_bwd_dkv_t<5>(p, B, nh, stream)
               : launch_flash_bwd_dq_t<5>(p, B, nh, stream);
  return dkv ? launch_flash_bwd_dkv_t<6>(p, B, nh, stream)
             : launch_flash_bwd_dq_t<6>(p, B, nh, stream);
}

// D = rowsum(dO * o): o and dO (B, Sq, heads, d) strided views, D
// (B * heads, Sq) fp32.
extern "C" int k11_flash_attention_bwd_delta(
    int is_bf16, const void* o, const void* dout, float* D, int B, int Sq,
    int nh, int d, long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh, void* stream) {
  FlashBwdParams p = {};
  p.o = o; p.dout = dout; p.D = D;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.Sq = Sq; p.Sk = 1; p.d = d;
  if (!flash_bwd_valid(p, B, nh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte loads of o and dO at any d % 8 == 0
  if (!views_vec16(d, {o_sb, o_ss, o_sh, do_sb, do_ss, do_sh}, {o, dout})) {
    const AnyBwdParams a = flash_bwd_any(p, nh);
    return attn_any_bwd_delta(is_bf16, &a, B, Sq, nh, s);
  }
  const long long n = (long long)B * Sq * nh;
  int G = 1;
  while (G < 32 && 8 * G < d) G *= 2;
  const unsigned blocks = (unsigned)((n * G + 255) / 256);
  if (is_bf16)
    flash_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(p, n, nh, G);
  else
    flash_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(p, n, nh, G);
  return (int)cudaGetLastError();
}

// dq (B, Sq, heads, d), written through its strides.
extern "C" int k11_flash_attention_bwd_dq(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dq, int B, int Sq, int Sk, int nh,
    int d, long long q_sb, long long q_ss, long long q_sh, long long kv_sb,
    long long kv_ss, long long kv_sh, long long do_sb, long long do_ss,
    long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh,
    float scale, void* stream) {
  FlashBwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse;
  p.D = const_cast<float*>(D); p.dq = dq;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.Sq = Sq; p.Sk = Sk; p.d = d; p.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch_flash_bwd(is_bf16, false, p, B, nh, s);
}

// dk and dv (B, Sk, heads, d), both written through the same strides.
extern "C" int k11_flash_attention_bwd_dkv(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dk, void* dv, int B, int Sq, int Sk,
    int nh, int d, long long q_sb, long long q_ss, long long q_sh,
    long long kv_sb, long long kv_ss, long long kv_sh, long long do_sb,
    long long do_ss, long long do_sh, long long dkv_sb, long long dkv_ss,
    long long dkv_sh, float scale, void* stream) {
  FlashBwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse;
  p.D = const_cast<float*>(D); p.dk = dk; p.dv = dv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.kv_sb = kv_sb; p.kv_ss = kv_ss; p.kv_sh = kv_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dkv_sb = dkv_sb; p.dkv_ss = dkv_ss; p.dkv_sh = dkv_sh;
  p.Sq = Sq; p.Sk = Sk; p.d = d; p.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)launch_flash_bwd(is_bf16, true, p, B, nh, s);
}
