// K10 and K14 in bf16 on Hopper's asynchronous path: the streaming and the
// full-row flash-attention forwards on warpgroup products (wgmma) fed by TMA
// through shared-memory rings, one design with two softmax epilogues.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_fwd_kernel
// (:136, launched by _stream_fwd_impl at :190; K10) and ::_kernel (:47,
// launched by _fused_full at :93; K14) where the call is bf16, d % 8 == 0
// up to 256, and every view allows a tensor map (16-byte bases, strides in
// multiples of 8 elements, no zero stride over an extent past 1:
// `_fwd_library` in ops/flash_attention.py). fp32 stays on
// csrc/flash_attention.cu, csrc/full_attention.cu and their d256 files;
// every other head dim or view on csrc/attention_any.cu.
//
// What each computes, in its TPU kernel's rounding (products accumulate in
// fp32; the exponentials are exp2 of the scores times scale log2(e)):
//   K10: the online softmax over 64-key tiles; the unnormalised
//     e = exp(s - m_new) rounded to bf16 as the A operand of O += P V, the
//     row sum over the fp32 e; o = acc / l at the end and the natural-log
//     lse = m + ln l, (B * heads, S_q) in fp32.
//   K14 (S_k <= 1024, no lse): p = e / sum(e) normalised in fp32 before it
//     is rounded to bf16. Where a row's scores fit the registers beside O
//     one pass forms them all, the row statistics and then P V: four 64 x 64
//     fp32 tiles (128 registers a thread, S_k <= 256) where a consumer holds
//     up to 96 columns of O (d <= 96), three (S_k <= 192) where it holds 128
//     (d 128, and d 256's half), since four spilled there. Past that two
//     passes over K, the first for the row maximum and sum, the second for
//     P V (K streamed twice, V once). It does not take K10's online form,
//     which would round another value.
//
// Bound on an H100: 4 S_q S_k d operations per (batch, head) against
// (2 S_q + 2 S_k) d elements moved. At S 3600 or 4096 the tensor cores
// bound K10; at the model's K14 shapes (49 queries over 196 keys) the
// bytes bound it. So every product runs on wgmma, its operands from shared
// memory (both for S = Q K^T, K-major) or registers (P, the A of P V, with
// V MN-major: the transpose bit), TMA streams the tiles while the products
// run, and blocks are persistent: each walks its share of the work items
// with the rings flowing from one item into the next, so the loads of the
// next item are in flight while this one's last products and stores run.
//
// Design (the building blocks and fragment layouts in hopper.cuh). A block
// has two consumer warpgroups and a producer warpgroup, whose registers
// setmaxnreg hands to the consumers. Per item stream ("group") the
// producer's warps hold one TMA thread for Q and K and one for V: Q comes
// into one of two slots (the next item's Q lands while this one's is in
// use), K and V through two-stage rings of 64-key tiles, each slot and
// stage with a full and an empty mbarrier. K and V have rings and threads
// of their own, so K14's one pass can take every K tile before the first V
// tile is used. Instances at d padded to 64, 96, 128 and 256; a head dim
// between them reads its last 64-column atom zero-filled past d, which
// adds nothing to any product, and the epilogue writes only the d columns
// of the contiguous (B, S_q, heads, d) output. Three layouts:
//   rows  (d <= 128, S_q > 64): an item is 128 queries of one (batch,
//         head); each consumer takes 64 rows, both read one ring.
//   pairs (d <= 128, S_q <= 64): each consumer runs its own stream of
//         (batch, head) items of up to 64 queries, with its own Q slots and
//         rings, so no warpgroup idles on short query rows (K14 at 49
//         queries, the mask decoder's 7 or 16).
//   cols  (d 256): an item is 64 queries; both consumers form the same
//         scores and each keeps half of O's columns (64 x 128 fp32, one
//         m64n128 product a k-step, 64 registers, where a whole row of O
//         would leave no room for K14's score tiles), and the work spreads
//         over twice the blocks of 128-row items (K10 at (2, 4096, 1, 256):
//         128 items for 132 SMs, not 64; K14 at (2, 1024, 1, 256): 32, not
//         16) at a quarter more work a block (the scores are half the
//         products and run twice).
// Each tile is issued, waited on and consumed before the next is issued
// (S_j, softmax_j, P_j V_j): products left in flight across tiles made
// ptxas serialize the wgmma in K11's passes (csrc/flash_attention_bwd_sm90.cu).
// Ragged edges: TMA reads zeros past S_k and S_q, and a zero key scores 0,
// not -inf, so every score of a key past S_k is set to -inf before the row
// maximum; a query past S_q is computed on zero rows and never stored, o
// and lse alike. No atomics: each output row belongs to one item, and a
// repeated call gives the same bits. Each entry point returns the CUDA
// error of its launch.

#include "common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kRow = 128;          // bytes of one swizzled tile row: 64 bf16
constexpr int kSmemLimit = 232448;
// Registers a thread holds after setmaxnreg (384 threads start at 168): the
// consumers keep O, K14's one-pass score tiles and P's fragments; the
// producer only issues loads (at 24 its two roles are separate functions:
// one with branches between them spilled a register).
constexpr int kConsumerRegs = 240, kProducerRegs = 24;

enum Layout { kRowsLayout = 0, kPairsLayout = 1, kColsLayout = 2 };

template <int D, int L> struct Shape {
  static constexpr int A = (D + 63) / 64;                // 64-column atoms of a tile
  static constexpr int NG = L == kPairsLayout ? 2 : 1;   // item streams of a block
  static constexpr int CPG = 2 / NG;                     // consumers of a stream
  static constexpr int QROWS = L == kRowsLayout ? 128 : 64;   // queries of an item
  static constexpr int NO = L == kColsLayout ? D / 2 : D;     // O columns a consumer holds
  // K14's key tiles in one pass: four 64 x 64 fp32 score tiles beside O of
  // up to 96 columns, three beside 128 (four spilled there)
  static constexpr int ONE_PASS = NO <= 96 ? 4 : 3;
  static constexpr int Q_REGION = QROWS * kRow, T_REGION = 64 * kRow;
  static constexpr int Q_BYTES = 2 * A * Q_REGION;       // [slot][atom]
  static constexpr int RING = 2 * A * T_REGION;          // [stage][atom]
  static constexpr int GROUP = Q_BYTES + 2 * RING;       // Q slots, K ring, V ring
  static constexpr int NBAR = 12;                        // q, k, v: full[2], empty[2]
  static constexpr int BAR_OFF = NG * GROUP;
  static constexpr int SMEM = BAR_OFF + NG * NBAR * 8 + 1024;   // + alignment slack
  static_assert(SMEM <= kSmemLimit, "shared memory");
  static_assert(NO == 64 || NO == 96 || NO == 128, "wgmma width");
};

// The mbarriers of one stream: full and empty, each two deep.
struct Bars {
  uint32_t base;
  __device__ uint32_t q_full(int s) const { return base + 8 * s; }
  __device__ uint32_t q_empty(int s) const { return base + 16 + 8 * s; }
  __device__ uint32_t full(bool v, int s) const { return base + (v ? 64 : 32) + 8 * s; }
  __device__ uint32_t empty(bool v, int s) const { return base + (v ? 80 : 48) + 8 * s; }
};

// The row (0, 1: r and r + 8) of accumulator element i (hopper.cuh).
__device__ __forceinline__ int half_of(int i) { return (i >> 1) & 1; }

// The scores of keys key0 .. key0 + 63 with those past Sk at -inf (only
// the last tile has any). The scale is applied later, inside exp2:
// exp2(s scale log2(e) - m), with m the row maximum in those units, since
// the maximum of the raw scores is the maximum of the scaled ones.
__device__ __forceinline__ void mask_keys(float* s, int key0, int Sk, int t4) {
  if (key0 + 64 <= Sk) return;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (key0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= Sk) s[i] = -INFINITY;
}

// This thread's two rows' maxima over a 64 x 64 tile, in log2 units (times
// sl2), raised to at least m.
__device__ __forceinline__ void tile_max(const float* s, float sl2, const float* m, float* mx) {
  float r[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) r[half_of(i)] = fmaxf(r[half_of(i)], s[i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) mx[hh] = fmaxf(m[hh], r[hh] * sl2);
}

// Each row's maximum over the four lanes that share it.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct Params {
  CUtensorMap q, k, v;
  bf16* o;        // contiguous (B, Sq, heads, d)
  float* lse;     // (B * heads, Sq), natural log; K10 only
  int Sq, Sk, nh, d;
  int nqt;        // items of one (batch, head): query tiles of QROWS
  int items;      // B * heads * nqt
  float scale_log2;
};

// S = Q K^T over the next K tile of the ring (n counts its tiles), Q's 64
// rows at q_rows (atoms q_region apart); the stage goes back once read.
template <int D>
__device__ __forceinline__ void qk_tile(float* s, const Bars& bars, int& n, uint32_t q_rows,
                                        uint32_t q_region, uint32_t ring) {
  constexpr int A = (D + 63) / 64;
  const int st = n & 1;
  mbar_wait(bars.full(false, st), (n >> 1) & 1);
  wg_fence();
  scores<D>(s, q_rows, q_region, ring + st * A * 64 * kRow, 64 * kRow);
  wg_commit();
  wg_wait<0>();
  fence_regs<32>(s);
  mbar_arrive(bars.empty(false, st));
  ++n;
}

// O (64 x NO) += P V over the next V tile of the ring, P's bf16 A fragments
// in pa; `cols` the offset of this consumer's columns of V.
template <int A, int NO>
__device__ __forceinline__ void pv_tile(float* o, uint32_t (*pa)[4], const Bars& bars, int& n,
                                        uint32_t ring, uint32_t cols) {
  const int st = n & 1;
  mbar_wait(bars.full(true, st), (n >> 1) & 1);
  fence_regs<16>(&pa[0][0]);
  fence_regs<NO / 2>(o);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<NO>(o, pa[kk], ring + st * A * 64 * kRow + cols + kk * 16 * kRow, 64 * kRow);
  wg_commit();
  wg_wait<0>();
  fence_regs<NO / 2>(o);
  fence_regs<16>(&pa[0][0]);
  mbar_arrive(bars.empty(true, st));
  ++n;
}

// The producer's TMA thread of stream g: Q into its two slots and K
// through its ring (Q_AND_K; K14's two passes stream K twice), or V
// through its ring.
template <int D, int L, bool FULL, bool Q_AND_K>
__device__ __forceinline__ void produce(const Params& p, uint32_t gb, const Bars& bars, int g) {
  using S = Shape<D, L>;
  constexpr int A = S::A;
  const int nkt = (p.Sk + 63) / 64;
  const int tiles = Q_AND_K && FULL && nkt > S::ONE_PASS ? 2 * nkt : nkt;
  const uint32_t ring = gb + S::Q_BYTES + (Q_AND_K ? 0 : S::RING);
  int n = 0, it = 0;
  for (int item = blockIdx.x * S::NG + g; item < p.items; item += gridDim.x * S::NG, ++it) {
    const int bh = item / p.nqt, b = bh / p.nh, h = bh - b * p.nh;
    if (Q_AND_K) {
      const int qs = it & 1;
      const uint32_t full = bars.q_full(qs), slot = gb + qs * A * S::Q_REGION;
      mbar_wait(bars.q_empty(qs), ((it >> 1) & 1) ^ 1);
      mbar_arrive_tx(full, A * S::Q_REGION);
      for (int a = 0; a < A; ++a)
        tma_load_4d(slot + a * S::Q_REGION, &p.q, full, 64 * a, h,
                    (item - bh * p.nqt) * S::QROWS, b);
    }
    for (int t = 0; t < tiles; ++t, ++n) {
      const int s = n & 1, kt = t < nkt ? t : t - nkt;
      const uint32_t full = bars.full(!Q_AND_K, s), st = ring + s * A * S::T_REGION;
      mbar_wait(bars.empty(!Q_AND_K, s), ((n >> 1) & 1) ^ 1);
      mbar_arrive_tx(full, A * S::T_REGION);
      for (int a = 0; a < A; ++a)
        tma_load_4d(st + a * S::T_REGION, Q_AND_K ? &p.k : &p.v, full, 64 * a, h, kt * 64, b);
    }
  }
}

template <int D, int L, bool FULL>
__global__ void __launch_bounds__(384, 1) fwd_sm90_kernel(const __grid_constant__ Params p) {
  using S = Shape<D, L>;
  constexpr int A = S::A, NO = S::NO, NG = S::NG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const int wg = warpgroup();
  const int nkt = (p.Sk + 63) / 64;
  if (threadIdx.x == 0) {
    for (int g = 0; g < NG; ++g) {
      const uint32_t b = base + S::BAR_OFF + g * S::NBAR * 8;
      for (int i = 0; i < S::NBAR; ++i)   // full barriers: the TMA thread's arrival
        mbar_init(b + 8 * i, (i / 2) % 2 ? 128 * S::CPG : 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer: per stream g, warp 2g issues Q and K, warp 2g + 1 V
    regs_dealloc<kProducerRegs>();
    const int w = (threadIdx.x - 256) / 32, g = w / 2;
    if (g >= NG || threadIdx.x % 32) return;
    const Bars bars{base + S::BAR_OFF + g * S::NBAR * 8};
    if (w % 2) produce<D, L, FULL, false>(p, base + g * S::GROUP, bars, g);
    else produce<D, L, FULL, true>(p, base + g * S::GROUP, bars, g);
    return;
  }

  // consumer wg: its stream g, its 64 rows (rw) and O columns c0 .. c0 + NO
  regs_alloc<kConsumerRegs>();
  const int g = L == kPairsLayout ? wg : 0;
  const int rw = L == kRowsLayout ? wg : 0, c0 = L == kColsLayout ? wg * NO : 0;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t4 = lane % 4;
  const uint32_t gb = base + g * S::GROUP;
  const Bars bars{base + S::BAR_OFF + g * S::NBAR * 8};
  const uint32_t k_ring = gb + S::Q_BYTES, v_ring = k_ring + S::RING;
  const uint32_t cols = (c0 / 64) * S::T_REGION;   // this consumer's columns of V
  const float sl2 = p.scale_log2;
  int kn = 0, vn = 0, it = 0;
  for (int item = blockIdx.x * NG + g; item < p.items; item += gridDim.x * NG, ++it) {
    const int bh = item / p.nqt, b = bh / p.nh, h = bh - b * p.nh;
    const int q0 = (item - bh * p.nqt) * S::QROWS + rw * 64;
    const int qs = it & 1;
    const uint32_t q_rows = gb + qs * A * S::Q_REGION + rw * 64 * kRow;
    mbar_wait(bars.q_full(qs), (it >> 1) & 1);

    float o[NO / 2];
    zero<NO / 2>(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, mul[2] = {1.f, 1.f};
    uint32_t pa[4][4];   // P's bf16 A fragments of one tile
    if constexpr (!FULL) {
      // K10: the online softmax, tile by tile
      for (int kt = 0; kt < nkt; ++kt) {
        float s[32];
        qk_tile<D>(s, bars, kn, q_rows, S::Q_REGION, k_ring);
        if (kt == nkt - 1) mbar_arrive(bars.q_empty(qs));
        mask_keys(s, kt * 64, p.Sk, t4);
        float mx[2], alpha[2];
        tile_max(s, sl2, m, mx);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = quad_max(mx[hh]);   // finite: tile kt holds key 64 kt
          alpha[hh] = exp2f(m[hh] - mx[hh]);
          m[hh] = mx[hh];
          l[hh] *= alpha[hh];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = exp2f(fmaf(s[i], sl2, -m[half_of(i)]));
          l[half_of(i)] += s[i];
        }
#pragma unroll
        for (int i = 0; i < NO / 2; ++i) o[i] *= alpha[half_of(i)];
        to_a_frags<4>(s, pa);
        pv_tile<A, NO>(o, pa, bars, vn, v_ring, cols);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        l[hh] = quad_sum(l[hh]);
        mul[hh] = 1.f / l[hh];
      }
    } else if (nkt <= S::ONE_PASS) {
      // K14, one pass: every score tile in registers, then the row
      // statistics, then tile by tile p = e / sum(e) rounded into P V
      float s[S::ONE_PASS][32];
#pragma unroll
      for (int t = 0; t < S::ONE_PASS; ++t)
        if (t < nkt) qk_tile<D>(s[t], bars, kn, q_rows, S::Q_REGION, k_ring);
      mbar_arrive(bars.q_empty(qs));
#pragma unroll
      for (int t = 0; t < S::ONE_PASS; ++t)
        if (t < nkt) {
          mask_keys(s[t], t * 64, p.Sk, t4);
          tile_max(s[t], sl2, m, m);
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) m[hh] = quad_max(m[hh]);
#pragma unroll
      for (int t = 0; t < S::ONE_PASS; ++t)
        if (t < nkt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            s[t][i] = exp2f(fmaf(s[t][i], sl2, -m[half_of(i)]));
            l[half_of(i)] += s[t][i];
          }
        }
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / quad_sum(l[hh]);
#pragma unroll
      for (int t = 0; t < S::ONE_PASS; ++t)
        if (t < nkt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) s[t][i] *= inv[half_of(i)];
          to_a_frags<4>(s[t], pa);
          pv_tile<A, NO>(o, pa, bars, vn, v_ring, cols);
        }
    } else {
      // K14, two passes: the row maximum and sum (rescaled as the maximum
      // moves), then the scores again, p = e / sum(e) rounded, P V
      for (int kt = 0; kt < nkt; ++kt) {
        float s[32];
        qk_tile<D>(s, bars, kn, q_rows, S::Q_REGION, k_ring);
        mask_keys(s, kt * 64, p.Sk, t4);
        float mx[2];
        tile_max(s, sl2, m, mx);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = quad_max(mx[hh]);
          l[hh] *= exp2f(m[hh] - mx[hh]);
          m[hh] = mx[hh];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) l[half_of(i)] += exp2f(fmaf(s[i], sl2, -m[half_of(i)]));
      }
      float inv[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) inv[hh] = 1.f / quad_sum(l[hh]);
      for (int kt = 0; kt < nkt; ++kt) {
        float s[32];
        qk_tile<D>(s, bars, kn, q_rows, S::Q_REGION, k_ring);
        if (kt == nkt - 1) mbar_arrive(bars.q_empty(qs));
        mask_keys(s, kt * 64, p.Sk, t4);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = exp2f(fmaf(s[i], sl2, -m[half_of(i)])) * inv[half_of(i)];
        to_a_frags<4>(s, pa);
        pv_tile<A, NO>(o, pa, bars, vn, v_ring, cols);
      }
    }

    bf16* out = p.o + ((long long)b * p.Sq * p.nh + h) * p.d;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = q0 + frag_row(warp, lane, hh);
      if (r >= p.Sq) continue;
      store_rows<NO>(out, (long long)p.nh * p.d, o, hh, r, c0, p.d, t4, mul[hh]);
      if (!FULL && c0 == 0 && t4 == 0)
        p.lse[(long long)bh * p.Sq + r] = (m[hh] + log2f(l[hh])) * kLn2;
    }
  }
}

// ------------------------------------------------------------ launchers

// The layout of a call: cols at d 256, pairs for up to 64 queries, rows.
int layout_of(int d, int Sq) {
  return padded_head_dim(d) == 256 ? kColsLayout : Sq <= 64 ? kPairsLayout : kRowsLayout;
}

template <int D> int smem_at(bool rows) {
  return rows ? Shape<D, kRowsLayout>::SMEM : Shape<D, kPairsLayout>::SMEM;
}

int smem_of(int d, int Sq) {
  const bool rows = layout_of(d, Sq) == kRowsLayout;
  switch (padded_head_dim(d)) {
    case 64: return smem_at<64>(rows);
    case 96: return smem_at<96>(rows);
    case 128: return smem_at<128>(rows);
    default: return Shape<256, kColsLayout>::SMEM;
  }
}

struct Call {
  const void *q, *k, *v;
  int B;
  long long qs[3], kvs[3];
};

template <int D, int L, bool FULL>
cudaError_t launch(Params& p, const Call& c, cudaStream_t stream) {
  using S = Shape<D, L>;
  long long sq[3] = {c.qs[0], c.qs[1], c.qs[2]}, skv[3] = {c.kvs[0], c.kvs[1], c.kvs[2]};
  map_strides(sq, c.B, p.nh, p.d, p.Sq);
  map_strides(skv, c.B, p.nh, p.d, p.Sk);
  if (!tensor_map_bshd(&p.q, c.q, c.B, p.Sq, p.nh, p.d, sq[0], sq[1], sq[2], S::QROWS)
      || !tensor_map_bshd(&p.k, c.k, c.B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], 64)
      || !tensor_map_bshd(&p.v, c.v, c.B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], 64))
    return cudaErrorInvalidValue;
  p.nqt = (p.Sq + S::QROWS - 1) / S::QROWS;
  const long long items = (long long)c.B * p.nh * p.nqt;
  if (items > (1LL << 30)) return cudaErrorInvalidValue;
  p.items = (int)items;
  const long long blocks = (items + S::NG - 1) / S::NG;
  const int grid = (int)(blocks < sm_count() ? blocks : sm_count());
  auto kernel = fwd_sm90_kernel<D, L, FULL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       S::SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 384, S::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <bool FULL>
cudaError_t launch_any(Params& p, const Call& c, cudaStream_t stream) {
  const bool rows = layout_of(p.d, p.Sq) == kRowsLayout;
  switch (padded_head_dim(p.d)) {
    case 64: return rows ? launch<64, kRowsLayout, FULL>(p, c, stream)
                         : launch<64, kPairsLayout, FULL>(p, c, stream);
    case 96: return rows ? launch<96, kRowsLayout, FULL>(p, c, stream)
                         : launch<96, kPairsLayout, FULL>(p, c, stream);
    case 128: return rows ? launch<128, kRowsLayout, FULL>(p, c, stream)
                          : launch<128, kPairsLayout, FULL>(p, c, stream);
    default: return launch<256, kColsLayout, FULL>(p, c, stream);
  }
}

// Whether a view's strides over its extents past 1 are all positive (a
// zero stride, an expanded tensor, cannot be a tensor map).
bool no_zero_stride(const long long* st, int B, int S, int nh) {
  return (B == 1 || st[0] > 0) && (S == 1 || st[1] > 0) && (nh == 1 || st[2] > 0);
}

int run(bool full, int is_bf16, const void* q, const void* k, const void* v, void* o,
        float* lse, int B, int Sq, int Sk, int nh, int d, const long long* qs,
        const long long* kvs, float scale, void* stream) {
  if (!is_bf16 || d < 8 || d > 256 || B < 1 || nh < 1 || Sq < 1 || Sk < 1
      || (full && Sk > 1024) || !no_zero_stride(qs, B, Sq, nh)
      || !no_zero_stride(kvs, B, Sk, nh)
      || !views_vec16(d, {qs[0], qs[1], qs[2], kvs[0], kvs[1], kvs[2], (long long)nh * d},
                      {q, k, v, o}))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.Sq = Sq; p.Sk = Sk; p.nh = nh; p.d = d;
  p.scale_log2 = scale * kLog2e;
  const Call c = {q, k, v, B, {qs[0], qs[1], qs[2]}, {kvs[0], kvs[1], kvs[2]}};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return (int)(full ? launch_any<true>(p, c, s) : launch_any<false>(p, c, s));
}

}  // namespace

// K10: o (B, Sq, heads, d) contiguous and the lse; the arguments of
// k10_flash_attention (csrc/flash_attention.cu), bf16 only.
extern "C" int k10_flash_attention_sm90(
    int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse, int B,
    int Sq, int Sk, int nh, int d, long long q_sb, long long q_ss, long long q_sh,
    long long kv_sb, long long kv_ss, long long kv_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh};
  return run(false, is_bf16, q, k, v, o, lse, B, Sq, Sk, nh, d, qs, kvs, scale, stream);
}

// K14: o (B, Sq, heads, d) contiguous, at most 1024 keys; the arguments of
// k14_full_attention (csrc/full_attention.cu), bf16 only.
extern "C" int k14_full_attention_sm90(
    int is_bf16, const void* q, const void* k, const void* v, void* o, int B, int Sq,
    int Sk, int nh, int d, long long q_sb, long long q_ss, long long q_sh, long long kv_sb,
    long long kv_ss, long long kv_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh};
  return run(true, is_bf16, q, k, v, o, nullptr, B, Sq, Sk, nh, d, qs, kvs, scale, stream);
}

// The dynamic shared memory, in bytes, of the instance a call at head dim
// d over Sq queries runs on (K10 and K14 size the block alike).
extern "C" int flash_attention_fwd_sm90_smem(int d, int sq) { return smem_of(d, sq); }
