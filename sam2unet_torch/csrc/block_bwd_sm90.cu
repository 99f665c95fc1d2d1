// K3 and K7's dx-only unmasked mode in bf16 on Hopper's asynchronous path:
// the trainable adapter's backward as one streaming pass whose products run
// on warpgroup MMAs (wgmma) fed by TMA, and the window block's backward with
// every product on wgmma and the query side of its attention in one pass;
// K5 and K9 in bf16 on windows of 4 or 8: their projections on the same
// GEMM and one small-window attention pass over the grid's windows.
//
// Replaces sam2unet_tpu/ops/pallas/fused_mlp.py::_adapter_bwd_kernel (:461,
// launched by _adapter_bwd at :551; K3) and
// sam2unet_tpu/ops/pallas/fused_attention_block.py::_bwd_kernel (:399,
// launched by _fused_window_block_bwd_impl at :669; K7) in its dx-only
// unmasked mode, where the call is bf16 and the widths (K3: C % 8 == 0,
// hidden 32; K7: c and the head dim multiples of 8, the head dim up to 128)
// are what TMA tensor maps address (`_adapter_bwd_library` in
// ops/fused_mlp.py, `_window_bwd_library` in ops/fused_attention_block.py).
// fp32 and every other width stay on csrc/fused_mlp_bwd.cu,
// csrc/fused_attention_block_bwd.cu and what they call (csrc/gemm_any.cu,
// csrc/attention_any_bwd*.cu); K7's masked and weight-gradient modes and K13
// keep their sources.
//
// Also replaces fused_attention_block.py::_strip_bwd_kernel (:814, launched
// by _fused_strips_bwd_impl at :1082; K5) and
// sam2unet_tpu/ops/pallas/fused_transition.py::_transition_bwd_kernel
// (:313, launched by _transition_bwd_impl at :483; K9) where the call is
// bf16 on windows of 4 or 8 with widths and head dims multiples of 8, the
// head dim up to 128 (`_strips_bwd_library`, and `_transition_bwd_library`
// in ops/fused_transition.py); fp32 and the rest keep
// csrc/fused_attention_block_bwd.cu and csrc/fused_transition_bwd.cu. Bound
// on an H100: the bytes of the pipeline's launches (each a row pass or a
// projection at c <= 576; the attention of a 64-key window is ~8 S c
// operations a token), 23 c bytes x 2 a token for K5, (10 cin + 17 cout) x 2
// a full-resolution token for K9. Launches: the LN pass (gemm.cuh's, four
// lanes a row at c <= 192); QKV [and K9's shortcut] on the GEMM (kOut); dO
// = gy W_proj (kDz); the small-window pass (design notes at
// k5_k9_window_attn_bwd_kernel); [K9: the shortcut's unpool
// (csrc/unpool2x2.cuh)]; dx_n = dqkv W_qkv (kDz) [K9: + dshort W_short, the
// first product as the second's residual, each rounded]; the LN backward.
// The grid's windows are addressed by the pass alone (a row's token from
// its tile, window and position), so the row passes and the GEMMs take the
// (B H W, c) rows in grid order.
//
// K3: dx, dW1, db1, dW2, db2 of x -> GELU(x W1^T + b1) -> GELU(h W2^T + b2)
// [-> + x], hidden 32. Bound on an H100: the bytes of x, gy and dx (its
// products are 12 C 32 operations a row against 6 C bytes, 64 an byte, far
// below the ridge). One launch streams the rows; a second sums the blocks'
// fp32 weight-gradient partials in a fixed order, so a repeated call gives
// the same bits. A persistent block per SM (at most one per 64-row tile):
// two consumer warpgroups and a producer warp, whose first lane keeps TMA
// loads of 64 x 64 chunks of x and gy in flight through a ring of slots
// (a full and an empty mbarrier each), in the order the consumers read
// them. W1 (32 x C) and W2 (C x 32) stay in shared memory for the block's
// life. The warpgroups share each 64-row tile and split its 64-column
// chunks (c % 2), as K1's adapter kernel does (csrc/mlp_sm90.cu); both wait
// on and release every slot in order, so neither falls a phase behind the
// ring. Per tile:
//   sweep 0: y1 = x W1^T over each warpgroup's chunks (m64n32, both
//     K-major), the two halves added through shared memory in one order by
//     both; h = GELU(y1 + b1) rounded to bf16: the register A of y2, and
//     staged in shared memory beside a column of ones as the B of dW2;
//   sweep 1, per 64-column chunk c of C: y2 = h W2_c^T (m64n64, register
//     A, W2 K-major in 64-byte-swizzled rows), dy2 = gy gelu'(y2 + b2)
//     rounded to bf16 (the register A of dh, and staged), dh += dy2 W2_c
//     (m64n32, the same W2 rows MN-major: the transpose bit), and the
//     chunk's dW2 and db2 as one product, dy2^T [h | 1] (m64n40, dy2
//     MN-major as A: the A transpose bit), so db2 comes out of the tensor
//     cores as a ninth column group; the warpgroups' dh added as y1's;
//   dy1 = round(dh) gelu'(y1 + b1), rounded to bf16 (register A of dx and
//     staged); db1 sums in registers;
//   sweep 2, per chunk: dx = dy1 W1_c (m64n64, W1 MN-major) [+ gy], written
//     over gy's slot and stored by TMA; dW1^T_c = x_c^T dy1 (m64n32, x's
//     slot MN-major as A).
// No intermediate leaves the SM; x and gy are read twice by TMA, the
// second time from L2 (a tile of both at C 768 is 196 KB, all of shared
// memory), and dx is written once. The weight-gradient partials live in
// shared memory where they fit beside a ring of `kMinRing` slots (C up to
// 384, 18 KB a 64-column chunk), each chunk's owned by the warpgroup that
// forms it, written out once a block; past that in the block's own region
// of the fp32 partial buffer, read, added and written per tile (the wide
// widths' row counts are small: at most 225 tiles at C 768, 31 at 1152, so
// most blocks hold one tile). Plan per width (64-row tiles, 64-column
// chunks, 8 KB a ring slot; `k3_plan`):
//   C 96 / 144 / 192 / 288 / 384: partials in shared memory, ring 16 / 14 /
//     14 / 8 / 5 slots (209-225 KB a block);
//   C 576 / 768 / 1152: partials in device memory (L2), ring 15 / 12 / 6
//     (221 KB); past C 1408 not even two slots fit.
// Registers: 288 threads a block (no setmaxnreg: the producer is one warp),
// so ptxas may give a thread up to 224 (the 384-thread blocks of
// csrc/mlp_sm90.cu hold 168). The largest live set is sweep 1's (y1, h's
// fragments, dh, y2 and dy2's fragments, dW2's accumulator); gy and b2 come
// in half a chunk at a time, and the partial sums are read after the
// products, where in flight beside them they spilled.
//
// K7 (dx-only, unmasked, no pad key): dx of x + proj(attention(LN(x)
// W_qkv^T + b)) for windows (nW, S, c), recomputed from x. Bound on an
// H100: the products (QKV, dO, dx_n: 8 c^2 operations a row, twice for
// QKV's recompute) and the attention's (forward again and backward, ~7 * 4
// S c a row) bound it from c 288 up. Seven launches, every product on
// wgmma fed by TMA:
//   1. the LN pass (gemm.cuh), as before;
//   2. QKV = LN(x) W_qkv^T + b on csrc/gemm_sm90.cuh's GEMM (kOut, K-major
//      B, the bias in the epilogue, rounded);
//   3. dO = gy W_proj on the same GEMM (kDz: W_proj MN-major), rounded as
//      the plain version rounds it;
//   4. the query side (k7_qside_sm90_kernel), one block per (window, head,
//      128 queries), two consumer warpgroups of 64 queries and a producer
//      warpgroup: Q and dO of the head come in once by TMA, K and V into
//      four stages, once where the window's keys fit them (S up to 256),
//      else twice through them as a ring. Loop 1 is the forward again with the
//      online softmax (O and the row statistics stay in registers); D =
//      rowsum(dO o O), O rounded to bf16 as a stored O would be, from dO in
//      shared memory; loop 2 forms S, dP, dS = P (dP - D) and dQ += dS K as
//      K11's dq pass does. It writes dq into dqkv and lse and D for the next
//      pass: O is never written and there is no separate D pass;
//   5. K11's dk/dv pass (csrc/flash_attention_bwd_sm90.cuh) over the qkv
//      buffer viewed as (nW, S, heads, d), with that lse and D;
//   6. dx_n = dqkv W_qkv on the GEMM (kDz, W_qkv MN-major);
//   7. the LN backward with the residual (gemm_bwd.cuh), as before.
// Head dims between the instances (64, 96, 128) read their last 64-column
// atom zero-filled past d through 4-D tensor maps, so no box reads the next
// head's columns (d 72 on instance 96); a window's ragged last tile (S 196,
// 49, 484) reads zero rows past S, its keys masked to -inf and its queries
// never stored. No atomics anywhere: each output belongs to one block.

#include <limits.h>

#include "flash_attention_bwd_sm90.cuh"
#include "gemm_bwd.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"
#include "unpool2x2.cuh"

using namespace hopper;

namespace {

using sm90::dgelu_fast;
using sm90::gelu_fast;
using sm90::ldg_pair;
using sm90::lds32;
using sm90::staged;
using sm90::sts32;
using sm90::unpack_bf16;

// ------------------------------------------------------------------- K3

constexpr int kSmemLimit = 232448;
constexpr int kAtom = 64 * 128;     // 64 rows by 64 columns, 128-byte swizzled: x, gy, dy2
constexpr int kW1Atom = 32 * 128;   // 32 rows of W1 by 64 columns
constexpr int kW2Chunk = 64 * 64;   // 64 rows of W2 by its 32 columns, 64-byte swizzled
constexpr int kHalf = 64 * 64;      // 64 rows by 32 columns, 64-byte swizzled: h, ones, dy1
constexpr int kMaxRing = 16;
constexpr int kMinRing = 4;         // slots the shared-memory partials leave beside them
constexpr int kK3Fixed = 2 * kAtom + 3 * kHalf;   // two dy2, h, ones, dy1
constexpr int kK3Bars = 8 * (1 + 2 * kMaxRing);
// a chunk's partial sums, fp32 in the accumulators' layout, [element][thread]:
// dW2 | db2 (m64n40, 20 a thread), then dW1^T (m64n32, 16)
constexpr int kPartFloats = 36 * 128;
constexpr int kK3Threads = 288;   // two consumer warpgroups and a producer warp

// K3's shared memory at width C: the ring's slots and whether the partials
// stay in shared memory; 0 bytes where not even two slots fit.
struct K3Plan {
  int smem, ring, smem_part;
};
inline K3Plan k3_plan(int C) {
  const int A = (C + 63) / 64;
  const int room = kSmemLimit - 1024 - kK3Bars - kK3Fixed - A * (kW1Atom + kW2Chunk);
  const int part = A * kPartFloats * 4;
  K3Plan p;
  p.smem_part = room - part >= kMinRing * kAtom;
  const int fit = (room - (p.smem_part ? part : 0)) / kAtom;
  p.ring = fit < kMaxRing ? fit : kMaxRing;
  p.smem = p.ring < 2 ? 0 : kSmemLimit - room + (p.smem_part ? part : 0) + p.ring * kAtom;
  return p;
}

struct K3Args {
  CUtensorMap x, gy, w1, w2, dx;
  const bf16 *b1, *b2;
  float* part;   // (gridDim.x, A kPartFloats + 32): each block's sums, db1 last
  int C, atoms, mt, ring, residual;
};

// Shared memory from the 1024-aligned base: W1's atoms, W2's chunks, the
// ring, each warpgroup's dy2, h, ones, dy1, [the partials,] the barriers: weights,
// full[kMaxRing], empty[kMaxRing].
struct K3Smem {
  uint32_t w1, w2, ring, dy2, h, ones, dy1, part, bars;
  __device__ uint32_t weights() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 + 8 * (kMaxRing + s); }
};

template <bool SMEM_PART>
__device__ __forceinline__ K3Smem k3_smem(uint32_t base, const K3Args& p) {
  K3Smem m;
  m.w1 = base;
  m.w2 = m.w1 + p.atoms * kW1Atom;
  m.ring = m.w2 + p.atoms * kW2Chunk;
  m.dy2 = m.ring + p.ring * kAtom;
  m.h = m.dy2 + 2 * kAtom;
  m.ones = m.h + kHalf;
  m.dy1 = m.ones + kHalf;
  m.part = m.dy1 + kHalf;
  m.bars = m.part + (SMEM_PART ? p.atoms * kPartFloats * 4 : 0);
  return m;
}

// The byte of element pair (row, 8 j + 2 t4) of a 64-row, 32-column tile in
// 64-byte-swizzled rows (the 16-byte chunk j of row r at j ^ ((r / 2) % 4)).
__device__ __forceinline__ uint32_t half_at(uint32_t buf, int row, int j, int t4) {
  return buf + row * 64 + ((j ^ ((row >> 1) & 3)) << 4) + 4 * t4;
}

// An MN-major operand of 64-byte-swizzled rows, 32 columns of m or n a row
// (`lead` bytes to the next 32), 8 rows 512 bytes apart; a 16-deep k-step
// moves the start by 1024 bytes.
__device__ __forceinline__ uint64_t desc_mn64(uint32_t addr, uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16)
         | ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// d (64 x 32, fp32) (+)= a (64 x 16, bf16 pairs in registers) b (16 x 32,
// through a descriptor, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n32k16_mn(float* d, const uint32_t* a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d (64 x 32, fp32) (+)= a b, both through descriptors and MN-major (both
// transpose bits): a the transpose of a 64-row tile of the rows.
__device__ __forceinline__ void wgmma_ss_m64n32k16_tt(float* d, uint64_t a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 40, fp32) (+)= a b, as above.
__device__ __forceinline__ void wgmma_ss_m64n40k16_tt(float* d, uint64_t a, uint64_t b,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19}"
      ", %20, %21, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(accumulate));
}

// N floats of this thread's share of a partial at `at` (element i at
// at + 4 (i 128 + tid)): shared memory (SMEM) or the block's device region.
template <int N, bool SMEM>
__device__ __forceinline__ void part_load(float* v, uint32_t s_at, const float* g_at, int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (SMEM) v[i] = __uint_as_float(lds32(s_at + 4 * (i * 128 + tid)));
    else v[i] = g_at[i * 128 + tid];
  }
}
template <int N, bool SMEM>
__device__ __forceinline__ void part_store(const float* v, uint32_t s_at, float* g_at, int tid) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (SMEM) sts32(s_at + 4 * (i * 128 + tid), __float_as_uint(v[i]));
    else g_at[i * 128 + tid] = v[i];
  }
}

// The producer lane: the weights once, then per tile x's chunks, gy's, and
// x's and gy's again chunk by chunk, each into the ring once its slot is
// free.
__device__ __forceinline__ void k3_produce(const K3Args& p, const K3Smem& m) {
  const int A = p.atoms;
  mbar_arrive_tx(m.weights(), A * (kW1Atom + kW2Chunk));
  for (int a = 0; a < A; ++a) {
    tma_load_2d(m.w1 + a * kW1Atom, &p.w1, m.weights(), 64 * a, 0);
    tma_load_2d(m.w2 + a * kW2Chunk, &p.w2, m.weights(), 0, 64 * a);
  }
  int n = 0;
  for (int tile = blockIdx.x; tile < p.mt; tile += gridDim.x)
    for (int k = 0; k < 4 * A; ++k, ++n) {
      const bool gy = k < 2 * A ? k >= A : ((k - 2 * A) & 1);
      const int c = k < 2 * A ? k % A : (k - 2 * A) >> 1;
      const int s = n % p.ring;
      mbar_wait(m.empty(s), ((n / p.ring) & 1) ^ 1);
      mbar_arrive_tx(m.full(s), kAtom);
      tma_load_2d(m.ring + s * kAtom, gy ? &p.gy : &p.x, m.full(s), 64 * c, 64 * tile);
    }
}

// This warpgroup's part of a 64 x 32 fp32 sum (16 a thread), added to the
// other's through shared memory (`mine`, `theirs`: each warpgroup's 8 KB),
// so both hold the same bits; the caller syncs the two before `mine` is
// written again.
__device__ __forceinline__ void exchange16(float* v, uint32_t mine, uint32_t theirs, int tid) {
#pragma unroll
  for (int i = 0; i < 16; ++i) sts32(mine + 4 * (i * 128 + tid), __float_as_uint(v[i]));
  named_sync(1, 256);
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] += __uint_as_float(lds32(theirs + 4 * (i * 128 + tid)));
}

template <bool SMEM_PART>
__global__ void __launch_bounds__(kK3Threads, 1) k3_adapter_bwd_sm90_kernel(
    const __grid_constant__ K3Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const K3Smem m = k3_smem<SMEM_PART>(smem_base(smem_raw), p);
  const int A = p.atoms, R = p.ring;
  if (threadIdx.x == 0) {
    mbar_init(m.weights(), 1);
    for (int s = 0; s < kMaxRing; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), 256);   // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    if (threadIdx.x == 256) k3_produce(p, m);
    return;
  }

  // consumer warpgroup wg: the chunks c with c % 2 == wg of every sweep;
  // both wait on every slot in order and release it, so neither falls a
  // phase behind the ring
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, warp = tid / 32, t4 = lane % 4;
  const int row0 = frag_row(warp, lane, 0);
  const bool elected = tid == 0;
  const uint32_t dy2 = m.dy2 + wg * kAtom, other = m.dy2 + (1 - wg) * kAtom;
  float* gpart = p.part + (long long)blockIdx.x * (A * kPartFloats + 32);
  // the ones: column 0 of the 64 rows 1.0 (logical chunk 0 of row r sits at
  // physical chunk (r / 2) % 4); the partials zeroed where they stay here
  for (int w = threadIdx.x; w < kHalf / 4; w += 256) {
    const int r = w / 16, chunk = (w % 16) / 4;
    sts32(m.ones + 4 * w, chunk == ((r >> 1) & 3) && w % 4 == 0 ? 0x3f80u : 0u);
  }
  if (SMEM_PART)
    for (int w = threadIdx.x; w < A * kPartFloats; w += 256) sts32(m.part + 4 * w, 0u);
  fence_proxy_async();
  named_sync(1, 256);
  float b1v[8], db1[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    b1v[q] = to_f(p.b1[8 * (q / 2) + 2 * t4 + (q & 1)]);
    db1[q] = 0.f;
  }
  mbar_wait(m.weights(), 0);

  int n = 0;
  bool first = true;
  for (int tile = blockIdx.x; tile < p.mt; tile += gridDim.x, first = false) {
    // ---- sweep 0: y1 = x W1^T over C, each warpgroup over its chunks
    float y1[16];
    bool any = false;
    for (int c = 0; c < A; ++c, ++n) {
      const int s = n % R;
      mbar_wait(m.full(s), (n / R) & 1);
      if (c % 2 == wg) {
        const uint32_t slot = m.ring + s * kAtom;
        fence_regs<16>(y1);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<32, 0>(y1, desc_k(slot + 32 * kk), desc_k(m.w1 + c * kW1Atom + 32 * kk),
                          any || kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs<16>(y1);
        any = true;
      }
      mbar_arrive(m.empty(s));
    }
    if (!any) zero<16>(y1);
    exchange16(y1, dy2, other, tid);
    // h = GELU(y1 + b1), rounded: the register A of y2; staged as dW2's B
    uint32_t ha[2][4];
    {
      float h[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        y1[i] += b1v[2 * (i / 4) + (i & 1)];
        h[i] = gelu_fast(y1[i]);
      }
      to_a_frags<2>(h, ha);
    }
    if (wg == 0)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sts32(half_at(m.h, row0 + 8 * (e & 1), 2 * kk + (e >> 1), t4), ha[kk][e]);
    fence_proxy_async();
    named_sync(1, 256);   // h staged, and both have read the other's y1

    // ---- sweep 1: y2, dy2, dh, dW2 | db2, chunk by chunk
    float dh[16];
    any = false;
    for (int c = 0; c < A; ++c, ++n) {
      const int s = n % R;
      mbar_wait(m.full(s), (n / R) & 1);
      if (c % 2 != wg) {
        mbar_arrive(m.empty(s));
        continue;
      }
      const uint32_t slot = m.ring + s * kAtom;
      float y2[32];
      fence_regs<32>(y2);
      fence_regs<8>(&ha[0][0]);
      wg_fence();
      wgmma_rs_m64n64k16_t<0>(y2, ha[0], desc_k64(m.w2 + c * kW2Chunk), 0);
      wgmma_rs_m64n64k16_t<0>(y2, ha[1], desc_k64(m.w2 + c * kW2Chunk + 32), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(y2);
      fence_regs<8>(&ha[0][0]);
      // dy2 = gy gelu'(y2 + b2), half a chunk at a time: b2 and gy first,
      // then the arithmetic
#pragma unroll
      for (int j0 = 0; j0 < 8; j0 += 4) {
        float2 b2[4];
        uint32_t g[4][2];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = 64 * c + 8 * (j0 + jj) + 2 * t4;
          b2[jj] = col < p.C ? unpack_bf16(ldg_pair(p.b2 + col)) : make_float2(0.f, 0.f);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            g[jj][hh] = lds32(staged(slot, row0 + 8 * hh, j0 + jj, t4));
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * (j0 + jj) + 2 * hh;
            const float2 gv = unpack_bf16(g[jj][hh]);
            y2[i] = gv.x * dgelu_fast(y2[i] + b2[jj].x);
            y2[i + 1] = gv.y * dgelu_fast(y2[i + 1] + b2[jj].y);
          }
      }
      mbar_arrive(m.empty(s));   // this thread's reads of gy are done
      uint32_t da[4][4];
      to_a_frags<4>(y2, da);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          sts32(staged(dy2, row0 + 8 * hh, jj, t4), da[jj / 2][2 * (jj % 2) + hh]);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      float dw2[20];
      fence_regs<16>(dh);
      fence_regs<16>(&da[0][0]);
      fence_regs<20>(dw2);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_m64n32k16_mn(dh, da[kk], desc_mn64(m.w2 + c * kW2Chunk + 1024 * kk, 0),
                              any || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n40k16_tt(dw2, desc_mn(dy2 + 2048 * kk, kAtom),
                              desc_mn64(m.h + 1024 * kk, kHalf), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs<16>(dh);
      fence_regs<16>(&da[0][0]);
      fence_regs<20>(dw2);
      any = true;
      // this chunk's dW2 | db2 sums so far, added
      const uint32_t s_at = m.part + 4 * c * kPartFloats;
      float* g_at = gpart + c * kPartFloats;
      if (SMEM_PART || !first) {
        float prev[20];
        part_load<20, SMEM_PART>(prev, s_at, g_at, tid);
#pragma unroll
        for (int i = 0; i < 20; ++i) dw2[i] += prev[i];
      }
      part_store<20, SMEM_PART>(dw2, s_at, g_at, tid);
    }
    if (!any) zero<16>(dh);
    exchange16(dh, dy2, other, tid);

    // dy1 = round(dh) gelu'(y1 + b1) (y1 holds + b1): db1's sums, the
    // register A of dx (rounded) and dW1's B
    uint32_t dya[2][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dh[i] = round_to<bf16>(dh[i]) * dgelu_fast(y1[i]);
      db1[2 * (i / 4) + (i & 1)] += dh[i];
    }
    to_a_frags<2>(dh, dya);
    if (wg == 0)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sts32(half_at(m.dy1, row0 + 8 * (e & 1), 2 * kk + (e >> 1), t4), dya[kk][e]);
    fence_proxy_async();
    named_sync(1, 256);   // dy1 staged, and both have read the other's dh

    // ---- sweep 2: dx and dW1^T, chunk by chunk (x's slot, then gy's)
    for (int c = 0; c < A; ++c, n += 2) {
      const int sx = n % R, sg = (n + 1) % R;
      mbar_wait(m.full(sx), (n / R) & 1);
      mbar_wait(m.full(sg), ((n + 1) / R) & 1);
      if (c % 2 != wg) {
        mbar_arrive(m.empty(sx));
        mbar_arrive(m.empty(sg));
        continue;
      }
      const uint32_t xslot = m.ring + sx * kAtom, gslot = m.ring + sg * kAtom;
      float dw1[16], dx[32];
      fence_regs<32>(dx);
      fence_regs<16>(dw1);
      fence_regs<8>(&dya[0][0]);
      wg_fence();
      wgmma_rs_m64n64k16_t<1>(dx, dya[0], desc_mn(m.w1 + c * kW1Atom, kAtom), 0);
      wgmma_rs_m64n64k16_t<1>(dx, dya[1], desc_mn(m.w1 + c * kW1Atom + 2048, kAtom), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_m64n32k16_tt(dw1, desc_mn(xslot + 2048 * kk, kAtom),
                              desc_mn64(m.dy1 + 1024 * kk, 0), kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(dx);
      fence_regs<16>(dw1);
      fence_regs<8>(&dya[0][0]);
      mbar_arrive(m.empty(sx));
      // dx = round(dy1 W1) [+ gy], rounded, over gy's place in its slot
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 4 * jj + 2 * hh;
          const uint32_t at = staged(gslot, row0 + 8 * hh, jj, t4);
          float v0 = dx[i], v1 = dx[i + 1];
          if (p.residual) {
            const float2 gv = unpack_bf16(lds32(at));
            v0 = round_to<bf16>(v0) + gv.x;
            v1 = round_to<bf16>(v1) + gv.y;
          }
          sts32(at, pack_bf16(v0, v1));
        }
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (elected) {   // the slot goes back once the store has read it
        tma_store_2d(&p.dx, gslot, 64 * c, 64 * tile);
        bulk_commit();
        bulk_wait_read<0>();
      }
      mbar_arrive(m.empty(sg));
      const uint32_t s_at = m.part + 4 * (c * kPartFloats + 20 * 128);
      float* g_at = gpart + c * kPartFloats + 20 * 128;
      if (SMEM_PART || !first) {
        float prev[16];
        part_load<16, SMEM_PART>(prev, s_at, g_at, tid);
#pragma unroll
        for (int i = 0; i < 16; ++i) dw1[i] += prev[i];
      }
      part_store<16, SMEM_PART>(dw1, s_at, g_at, tid);
    }
  }

  // the block's partials out once; db1 (both warpgroups hold the same
  // sums: the first's) over the lanes of a row group, then the warps in
  // order (through dy2's staging, free now)
  named_sync(1, 256);
  if (SMEM_PART)
    for (int w = threadIdx.x; w < A * kPartFloats; w += 256)
      gpart[w] = __uint_as_float(lds32(m.part + 4 * w));
  if (wg == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      db1[q] += __shfl_xor_sync(0xffffffffu, db1[q], 4);
      db1[q] += __shfl_xor_sync(0xffffffffu, db1[q], 8);
      db1[q] += __shfl_xor_sync(0xffffffffu, db1[q], 16);
    }
    if (lane < 4)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        sts32(m.dy2 + 4 * (32 * warp + 8 * (q / 2) + 2 * lane + (q & 1)),
              __float_as_uint(db1[q]));
    named_sync(2, 128);
    if (tid < 32) {
      float v = 0.f;
      for (int w = 0; w < 4; ++w) v += __uint_as_float(lds32(m.dy2 + 4 * (32 * w + tid)));
      gpart[A * kPartFloats + tid] = v;
    }
  }
  if (elected) bulk_wait<0>();
}

// The blocks' partials summed in block order, each element by one thread,
// into dW1 (32, C), db1, dW2 (C, 32) and db2, fp32.
__global__ void __launch_bounds__(256) k3_reduce_kernel(const float* __restrict__ part, int blocks,
                                                        int A, int C, float* dw1, float* db1,
                                                        float* dw2, float* db2) {
  const int per = A * kPartFloats + 32;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= per) return;
  float s = 0.f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += part[(long long)b * per + e];
  if (e >= A * kPartFloats) {
    db1[e - A * kPartFloats] = s;
    return;
  }
  const int c = e / kPartFloats, r = e % kPartFloats;
  int i = r / 128;
  const int t = r % 128, lane = t % 32;
  const bool w2 = i < 20;
  if (!w2) i -= 20;
  const int row = 64 * c + frag_row(t / 32, lane, (i >> 1) & 1);
  const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
  if (row >= C) return;
  if (!w2) dw1[col * C + row] = s;   // the product is dW1's transpose
  else if (col < 32) dw2[row * 32 + col] = s;
  else if (col == 32) db2[row] = s;
}


// ------------------------------------------------------------------- K7

constexpr float kLn2 = 0.6931471805599453f;

struct QsideParams {
  CUtensorMap q, k, v, dout;
  float* lse;   // (nW * heads, S), natural log
  float* D;     // (nW * heads, S)
  bf16* dq;
  long long o_sb, o_ss, o_sh;   // element strides of dq
  int S, nh, d;
  float scale, scale_log2;
};

// Each row's maximum or sum over the four lanes that share it.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The query side of K7's attention backward at head dim D (d padded up to
// it, 64-128): K11's dq-pass block shape (k11::Shape<D>: 128 queries, Q and
// dO resident) with the forward in front of its loop, and K and V in four
// stages: loaded once and read by both loops where the window's keys fit
// them (S up to 256: 128 KB at D 96 or 128), else streamed twice through
// them as a ring.
constexpr int kQStages = 4;
template <int D> struct QShape {
  using S = k11::Shape<D>;
  static constexpr int STAGE = 2 * S::A * S::T_REGION;         // K and V of 64 keys
  static constexpr int RING_OFF = 2 * S::A * S::RES_REGION;    // after Q and dO
  static constexpr int BAR_OFF = RING_OFF + kQStages * STAGE;  // res, full[4], empty[4]
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kQStages) + 1024;
  static_assert(SMEM <= k11::kSmemLimit, "shared memory");
};

template <int D>
__global__ void __launch_bounds__(384, 1) k7_qside_sm90_kernel(const __grid_constant__ QsideParams p) {
  using S = k11::Shape<D>;
  using Q = QShape<D>;
  static_assert(!S::SPLIT, "head dims up to 128");
  constexpr int A = S::A, NO = S::NO, kRow = k11::kRow;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t ring = base + Q::RING_OFF;
  const uint32_t bar_res = base + Q::BAR_OFF, bar_full = bar_res + 8,
                 bar_empty = bar_full + 8 * kQStages;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * S::ROWS;
  const int nkt = (p.S + 63) / 64;
  const bool resident = nkt <= kQStages;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer: Q and dO once, then K and V once or twice
    regs_dealloc<k11::kDqProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_tx(bar_res, 2 * A * S::RES_REGION);
      for (int a = 0; a < A; ++a) {
        tma_load_4d(base + a * S::RES_REGION, &p.q, bar_res, 64 * a, h, q0, b);
        tma_load_4d(base + (A + a) * S::RES_REGION, &p.dout, bar_res, 64 * a, h, q0, b);
      }
      for (int n = 0; n < (resident ? nkt : 2 * nkt); ++n) {
        const int s = n % kQStages, kt = n < nkt ? n : n - nkt;
        if (!resident) mbar_wait(bar_empty + 8 * s, ((n / kQStages) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s, st = ring + s * Q::STAGE;
        mbar_arrive_tx(full, Q::STAGE);
        for (int a = 0; a < A; ++a) {
          tma_load_4d(st + a * S::T_REGION, &p.k, full, 64 * a, h, kt * 64, b);
          tma_load_4d(st + (A + a) * S::T_REGION, &p.v, full, 64 * a, h, kt * 64, b);
        }
      }
    }
    return;
  }

  // consumer: 64 query rows
  regs_alloc<k11::kDqConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t4 = lane % 4;
  const long long bh = (long long)b * p.nh + h;
  const float sl2 = p.scale_log2;
  const uint32_t q_rows = base + wg * 64 * kRow, do_rows = q_rows + A * S::RES_REGION;
  mbar_wait(bar_res, 0);

  // loop 1: the forward again, the online softmax over 64-key tiles
  float lse2[2], dd[2];
  {
    float o[NO / 2];
    zero<NO / 2>(o);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % kQStages;
      mbar_wait(bar_full + 8 * s, (kt / kQStages) & 1);
      const uint32_t kt_s = ring + s * Q::STAGE, vt_s = kt_s + A * S::T_REGION;
      float sc[32];
      wg_fence();
      scores<D>(sc, q_rows, S::RES_REGION, kt_s, S::T_REGION);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(sc);
      const int key0 = kt * 64;
      if (key0 + 64 > p.S) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (key0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= p.S) sc[i] = -INFINITY;
      }
      float mx[2] = {m[0], m[1]}, alpha[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i] * sl2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = quad_max(mx[hh]);   // finite: tile kt holds key 64 kt
        alpha[hh] = exp2f(m[hh] - mx[hh]);
        m[hh] = mx[hh];
        l[hh] *= alpha[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], sl2, -m[(i >> 1) & 1]));
        l[(i >> 1) & 1] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < NO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[4][4];
      to_a_frags<4>(sc, pa);
      fence_regs<16>(&pa[0][0]);
      fence_regs<NO / 2>(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_rs<NO>(o, pa[kk], vt_s + kk * 16 * kRow, S::T_REGION);
      wg_commit();
      wg_wait<0>();
      fence_regs<NO / 2>(o);
      fence_regs<16>(&pa[0][0]);
      if (!resident) mbar_arrive(bar_empty + 8 * s);
    }
    // lse in log2 units and D = rowsum(dO o round(O)), dO from its rows here
    float inv[2], ds[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] = quad_sum(l[hh]);
      inv[hh] = 1.f / l[hh];
      lse2[hh] = m[hh] + log2f(l[hh]);
    }
#pragma unroll
    for (int j = 0; j < NO / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = 4 * j + 2 * hh, r = frag_row(warp, lane, hh);
        const uint32_t at = do_rows + (j / 8) * S::RES_REGION + r * kRow
                            + (((j % 8) ^ (r & 7)) << 4) + 4 * t4;
        const float2 g = unpack_bf16(lds32(at));
        ds[hh] += g.x * round_to<bf16>(o[i] * inv[hh]) + g.y * round_to<bf16>(o[i + 1] * inv[hh]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      dd[hh] = quad_sum(ds[hh]);
      const int r = q0 + wg * 64 + frag_row(warp, lane, hh);
      if (t4 == 0 && r < p.S) {
        p.lse[bh * p.S + r] = lse2[hh] * kLn2;
        p.D[bh * p.S + r] = dd[hh];
      }
    }
  }

  // loop 2: K11's dq pass, P from the row statistics above
  float dq[NO / 2];
  zero<NO / 2>(dq);
  for (int kt = 0; kt < nkt; ++kt) {
    const int n = resident ? kt : nkt + kt, s = n % kQStages;
    mbar_wait(bar_full + 8 * s, (n / kQStages) & 1);
    const uint32_t kt_s = ring + s * Q::STAGE, vt_s = kt_s + A * S::T_REGION;
    float sc[32], dp[32];
    wg_fence();
    scores<D>(sc, q_rows, S::RES_REGION, kt_s, S::T_REGION);
    scores<D>(dp, do_rows, S::RES_REGION, vt_s, S::T_REGION);
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(sc);
    fence_regs<32>(dp);
    const int key0 = kt * 64;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const bool valid = key0 + 8 * (i / 4) + 2 * t4 + (i & 1) < p.S;
      const float pr = valid ? exp2f(fmaf(sc[i], sl2, -lse2[hh])) : 0.f;
      sc[i] = pr * (dp[i] - dd[hh]);   // dS
    }
    uint32_t da[4][4];
    to_a_frags<4>(sc, da);
    fence_regs<16>(&da[0][0]);
    fence_regs<NO / 2>(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<NO>(dq, da[kk], kt_s + kk * 16 * kRow, S::T_REGION);
    wg_commit();
    wg_wait<0>();
    fence_regs<NO / 2>(dq);
    fence_regs<16>(&da[0][0]);
    if (!resident) mbar_arrive(bar_empty + 8 * s);
  }

  bf16* out = p.dq + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + wg * 64 + frag_row(warp, lane, hh);
    if (r < p.S) store_rows<NO>(out, p.o_ss, dq, hh, r, 0, p.d, t4, p.scale);
  }
}

// ---------------------------------------------------------------- K5, K9

// The small-window attention pass of K5's and K9's bf16 route: windows of
// WIN x WIN tokens (8 or 4) of a (B, H, W, c) grid, K9's with the 2x2
// q-pool. A tile is 64 keys: one window at WIN 8, four windows of one strip
// at WIN 4 (K9: their 16 or 4 x 4 pooled queries). Per tile, for one head:
// S = Q K^T scale, P = softmax(S) exact over the window's keys, O = P V (only
// for D = rowsum(dO o round(O)), O rounded as a stored O would be), dP = dO
// V^T, dS = P (dP - D), dQ = dS K scale; then, from the tile's lse and D
// through shared memory, S^T, P^T, dV = P^T dO, dP^T, dS^T and dK = dS^T Q
// scale, each a 16-row product of one warp on mma.sync. No o, lse or D
// buffer and no atomics: each output row belongs to one warp, and a
// repeated call gives the same bits.
template <int WIN, bool QPOOL, int DP> struct SwShape {
  static constexpr int S = WIN * WIN;             // keys of a window
  static constexpr int G = 64 / S;                // windows of a tile
  static constexpr int SQ = QPOOL ? S / 4 : S;    // queries of a window
  static constexpr int QROWS = G * SQ;            // query rows of a tile: 64 or 16
  static constexpr int LDS = DP + 8;              // elements a shared-memory row (ldmatrix
                                                  // rows 16 bytes apart mod 128: no conflict)
  // a ring slot: K, V and Q (K9: the raw q) 64 rows each, then dO's rows
  static constexpr int SLOT = (3 * 64 + QROWS) * LDS;
  static constexpr int QP = 2 * SLOT;             // K9's pooled Q (16 rows)
  static constexpr int STATS = QP + (QPOOL ? 16 * LDS : 0);   // lse (log2) and D, 64 each
  static constexpr int SMEM = STATS * 2 + 2 * 64 * 4;
  // phase Q: 16 queries of a warp against NK keys (a window's); phase K: 16
  // keys against NQ queries. K9 at WIN 4 holds four windows' 16 pooled
  // queries in one 16-row tile: warp w takes window w's keys against all
  // 16 and keeps its window's four rows (MASK), and in phase K the same
  // window's keys against the 16 queries, masked to its four
  static constexpr int NK = WIN == 8 ? 64 : 16;
  static constexpr int NQ = QPOOL ? 16 : (WIN == 8 ? 64 : 16);
  static constexpr bool MASK = QPOOL && WIN == 4;
  static constexpr int QITEMS = MASK ? G : QROWS / 16;
  static_assert(S % 16 == 0 && 64 % S == 0, "windows of 16 or 64 tokens");
};
constexpr int kSwThreads = 128;

struct SwParams {
  const bf16* qkv;    // rows of `ld` elements: a token's q, k, v at 0, C, 2C
  const bf16* dout;   // rows of C elements over (B, H, W), or (B, H/2, W/2) with the q-pool
  bf16* dqkv;         // rows of `ldo` elements: dq, dk, dv at 0, C, 2C
  long long ld, ldo;
  int items;   // tiles x heads
  int H, W, C, nh, d, wins_h, wins_w, tiles_w;
  float scale, scale_log2;
};

// A tile: batch entry, window row, its first window along W, head.
struct SwTile {
  long long b;
  int wy, gx0, h;
};
// (32-bit: a 64-bit division is a call, whose saved registers ptxas
// counted as spills)
__device__ __forceinline__ SwTile sw_tile(const SwParams& p, int item, int G) {
  SwTile t;
  t.h = item % p.nh;
  int r = item / p.nh;
  t.gx0 = (r % p.tiles_w) * G;
  r /= p.tiles_w;
  t.wy = r % p.wins_h;
  t.b = r / p.wins_h;
  return t;
}

// The token of key row r (window r / S of the tile, its token r % S in
// row-major order), and whether that window lies inside the grid (a strip's
// last tile at WIN 4 may hold fewer than four).
template <int WIN>
__device__ __forceinline__ long long sw_token(const SwParams& p, const SwTile& t, int r,
                                              bool& valid) {
  constexpr int S = WIN * WIN;
  const int gi = r / S, tt = r % S;
  valid = t.gx0 + gi < p.wins_w;
  return (t.b * p.H + t.wy * WIN + tt / WIN) * p.W + (long long)(t.gx0 + gi) * WIN + tt % WIN;
}
// K9: the pooled token of pooled query row q over (B, H/2, W/2).
template <int WIN>
__device__ __forceinline__ long long sw_pooled(const SwParams& p, const SwTile& t, int q,
                                               bool& valid) {
  constexpr int HW = WIN / 2, SQ = HW * HW;
  const int gi = q / SQ, pt = q % SQ;
  valid = t.gx0 + gi < p.wins_w;
  return (t.b * (p.H / 2) + t.wy * HW + pt / HW) * (p.W / 2) + (long long)(t.gx0 + gi) * HW
         + pt % HW;
}
// K9: the key row of position k (row-major) of pooled query q's 2x2 cell.
template <int WIN>
__device__ __forceinline__ int sw_cell_row(int q, int k) {
  constexpr int HW = WIN / 2, SQ = HW * HW;
  const int gi = q / SQ, pt = q % SQ;
  return gi * WIN * WIN + (2 * (pt / HW) + (k >> 1)) * WIN + 2 * (pt % HW) + (k & 1);
}

// One tile's K, V, Q (raw) and dO rows of head t.h into a ring slot, 16
// bytes a copy (cp.async): eight lanes a row, each the chunks c8 and c8 + 8
// of its d / 8 (d <= 128), a row's token computed once for its K, V and Q;
// rows of windows past the grid read as zeros.
template <int WIN, bool QPOOL, int DP>
__device__ __forceinline__ void sw_load(const SwParams& p, int item, bf16* slot) {
  using Sh = SwShape<WIN, QPOOL, DP>;
  constexpr int LDS = Sh::LDS;
  const SwTile t = sw_tile(p, item, Sh::G);
  const int ch = p.d / 8, c8 = threadIdx.x & 7;
  const long long hoff = (long long)t.h * p.d;
  for (int r = threadIdx.x >> 3; r < 64; r += kSwThreads / 8) {
    bool valid;
    const long long tok = sw_token<WIN>(p, t, r, valid);
    const bf16* src = valid ? p.qkv + tok * p.ld + hoff : p.qkv;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c8 + 8 * cc;
      if (c < ch) {
        cp_async16(slot + r * LDS + 8 * c, valid ? src + p.C + 8 * c : src, valid);   // K
        cp_async16(slot + (64 + r) * LDS + 8 * c, valid ? src + 2 * p.C + 8 * c : src,
                   valid);                                                             // V
        cp_async16(slot + (128 + r) * LDS + 8 * c, valid ? src + 8 * c : src, valid);  // Q
      }
    }
  }
  for (int r = threadIdx.x >> 3; r < Sh::QROWS; r += kSwThreads / 8) {
    bool valid;
    const long long tok = QPOOL ? sw_pooled<WIN>(p, t, r, valid) : sw_token<WIN>(p, t, r, valid);
    const bf16* src = valid ? p.dout + tok * p.C + hoff : p.dout;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int c = c8 + 8 * cc;
      if (c < ch) cp_async16(slot + (192 + r) * LDS + 8 * c, valid ? src + 8 * c : src, valid);
    }
  }
}

// s (16 x 8 NT, accumulator layout) = A (16 rows) B (8 NT rows)^T over DP
// columns, rows LDS apart (csrc/attention_bwd_tiles.cuh's fragments).
template <int NT, int DP>
__device__ __forceinline__ void sw_dot(float (*s)[4], const bf16* A, const bf16* B, int lane) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    unsigned af[4];
    ldmatrix_x4(af, A + (lane & 15) * LDS + kd * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < NT / 2; ++jj) {
      unsigned r[4];
      ldmatrix_x4(r, B + (jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kd * 16
                         + ((lane >> 3) & 1) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_16816(s[2 * jj], af, b0);
      mma_16816(s[2 * jj + 1], af, b1);
    }
  }
}

// acc (16 x DP) += p (16 x 8 NT, accumulator layout, rounded to bf16 as the
// product's operand) B (8 NT rows of DP columns).
template <int NT, int DP>
__device__ __forceinline__ void sw_pv(float (*acc)[4], const float (*p)[4], const bf16* B,
                                      int lane) {
  constexpr int LDS = DP + 8;
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const unsigned a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int fp = 0; fp < DP / 16; ++fp) {
      unsigned r[4];
      ldmatrix_x4_trans(r, B + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + fp * 16
                               + (lane >> 4) * 8);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      mma_16816(acc[2 * fp], a, b0);
      mma_16816(acc[2 * fp + 1], a, b1);
    }
  }
}

template <int N> __device__ __forceinline__ void zero4(float (*a)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[j][e] = 0.f;
}

// Rows g and g + 8 (hh) of a 16 x DP accumulator times `mul` into the bf16
// rows of tokens tok[hh] at column `col0` (the columns below d).
template <int DP>
__device__ __forceinline__ void sw_store(const SwParams& p, const float (*acc)[4],
                                         const long long* tok, const bool* valid, long long col0,
                                         float mul, int t4) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!valid[hh]) continue;
    bf16* out = p.dqkv + tok[hh] * p.ldo + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      if (8 * j >= p.d) break;
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * hh] * mul, acc[j][2 * hh + 1] * mul);
    }
  }
}

// The larger of each bf16 of b and a, a's where they tie.
__device__ __forceinline__ uint32_t max_bf16x2(uint32_t a, uint32_t b) {
  const float2 x = unpack_bf16(a), y = unpack_bf16(b);
  return (y.x > x.x ? b & 0xffffu : a & 0xffffu) | (y.y > x.y ? b & 0xffff0000u : a & 0xffff0000u);
}

// Phase Q, item `item` (this warp): 16 query rows against their window's
// keys; writes dq, and the rows' lse (log2 units) and D for phase K.
template <int WIN, bool QPOOL, int DP>
__device__ __forceinline__ void sw_query_side(const SwParams& p, const SwTile& t,
                                              const bf16* slot, const bf16* Q, int item,
                                              float* lse2s, float* ds, int lane) {
  using Sh = SwShape<WIN, QPOOL, DP>;
  constexpr int LDS = Sh::LDS, NT = Sh::NK / 8, NF = DP / 8;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = QPOOL ? 0 : item * 16, k0 = Sh::NK == 64 ? 0 : item * 16;
  // K9 at WIN 4: rows g and g + 8 are live where their window is the item's;
  // a dead row's scores read as zeros and its P as zero, so it stays finite
  bool rlive[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) rlive[hh] = !Sh::MASK || (g + 8 * hh) / Sh::SQ == item;
  const bf16* K = slot + k0 * LDS;
  const bf16* V = slot + (64 + k0) * LDS;
  const bf16* dO = slot + (192 + q0) * LDS;
  float s[NT][4];
  sw_dot<NT, DP>(s, Q + q0 * LDS, K, lane);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, lse2[2], dd[2];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = s[j][e] * p.scale_log2;
      if (!rlive[e >> 1]) v = 0.f;
      s[j][e] = v;
      m[e >> 1] = fmaxf(m[e >> 1], v);
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) m[hh] = quad_max(m[hh]);   // finite: a query's own keys
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] = quad_sum(l[hh]);
    lse2[hh] = m[hh] + log2f(l[hh]);
  }
  // P = exp2(s - lse2), as phase K forms it (no division: its slow path is
  // a call)
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = rlive[e >> 1] ? exp2f(s[j][e] - lse2[e >> 1]) : 0.f;
  {
    // O = P V, for D = rowsum(dO o round(O)) only
    float o[NF][4];
    zero4<NF>(o);
    sw_pv<NT, DP>(o, s, V, lane);
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 gv = unpack_bf16(
            *reinterpret_cast<const uint32_t*>(dO + (g + 8 * hh) * LDS + 8 * j + 2 * t4));
        sum[hh] += gv.x * round_to<bf16>(o[j][2 * hh]) + gv.y * round_to<bf16>(o[j][2 * hh + 1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dd[hh] = quad_sum(sum[hh]);
  }
  {
    float dp[NT][4];
    sw_dot<NT, DP>(dp, dO, V, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= dp[j][e] - dd[e >> 1];   // dS
  }
  float dq[NF][4];
  zero4<NF>(dq);
  sw_pv<NT, DP>(dq, s, K, lane);
  if (t4 == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (!rlive[hh]) continue;
      lse2s[q0 + g + 8 * hh] = lse2[hh];
      ds[q0 + g + 8 * hh] = dd[hh];
    }
  const long long col0 = (long long)t.h * p.d;
  if constexpr (!QPOOL) {
    long long tok[2];
    bool valid[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) tok[hh] = sw_token<WIN>(p, t, q0 + g + 8 * hh, valid[hh]);
    sw_store<DP>(p, dq, tok, valid, col0, p.scale, t4);
  } else {
    // each pooled gradient to its cell's first maximum (row-major), zero at
    // the other three positions, from the raw q still in the slot; a cell's
    // rows and tokens from its first (arrays of the four went to the stack)
    const bf16* raw = slot + 128 * LDS;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + g + 8 * hh;
      bool valid;
      sw_pooled<WIN>(p, t, q, valid);
      if (!valid || !rlive[hh]) continue;
      const int r0 = sw_cell_row<WIN>(q, 0);
      const long long tok0 = sw_token<WIN>(p, t, r0, valid);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        if (8 * j >= p.d) break;
        const int col = 8 * j + 2 * t4;
        float2 mx = unpack_bf16(*reinterpret_cast<const uint32_t*>(raw + r0 * LDS + col));
        int a0 = 0, a1 = 0;
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const float2 c = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              raw + (r0 + (k >> 1) * WIN + (k & 1)) * LDS + col));
          if (c.x > mx.x) {
            mx.x = c.x;
            a0 = k;
          }
          if (c.y > mx.y) {
            mx.y = c.y;
            a1 = k;
          }
        }
        const float v0 = dq[j][2 * hh] * p.scale, v1 = dq[j][2 * hh + 1] * p.scale;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<uint32_t*>(
              p.dqkv + (tok0 + (k >> 1) * p.W + (k & 1)) * p.ldo + col0 + col) =
              pack_bf16(k == a0 ? v0 : 0.f, k == a1 ? v1 : 0.f);
      }
    }
  }
}

// Phase K, item `item` (this warp): 16 key rows against their window's
// queries, P^T from the queries' lse; writes dv and dk.
template <int WIN, bool QPOOL, int DP>
__device__ __forceinline__ void sw_key_side(const SwParams& p, const SwTile& t, const bf16* slot,
                                            const bf16* Q, int item, const float* lse2s,
                                            const float* ds, int lane) {
  using Sh = SwShape<WIN, QPOOL, DP>;
  constexpr int LDS = Sh::LDS, NT = Sh::NQ / 8, NF = DP / 8;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = item * 16, qb = (QPOOL || Sh::NQ == 64) ? 0 : item * 16;
  const bf16* K = slot + k0 * LDS;
  const bf16* V = slot + (64 + k0) * LDS;
  const bf16* dO = slot + (192 + qb) * LDS;
  const bf16* Qa = Q + qb * LDS;
  float st[NT][4];   // S^T, then P^T, then dS^T: rows keys, columns queries
  sw_dot<NT, DP>(st, K, Qa, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = qb + 8 * j + 2 * t4 + (e & 1);
      const bool live = !Sh::MASK || q / Sh::SQ == item;   // K9 at WIN 4: item = window
      st[j][e] = live ? exp2f(fmaf(st[j][e], p.scale_log2, -lse2s[q])) : 0.f;
    }
  long long tok[2];
  bool valid[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) tok[hh] = sw_token<WIN>(p, t, k0 + g + 8 * hh, valid[hh]);
  const long long col0 = (long long)t.h * p.d;
  {
    float dv[NF][4];
    zero4<NF>(dv);
    sw_pv<NT, DP>(dv, st, dO, lane);
    sw_store<DP>(p, dv, tok, valid, col0 + 2LL * p.C, 1.f, t4);
  }
  {
    float dpt[NT][4];
    sw_dot<NT, DP>(dpt, V, dO, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] *= dpt[j][e] - ds[qb + 8 * j + 2 * t4 + (e & 1)];
  }
  float dk[NF][4];
  zero4<NF>(dk);
  sw_pv<NT, DP>(dk, st, Qa, lane);
  sw_store<DP>(p, dk, tok, valid, col0 + p.C, p.scale, t4);
}

// A persistent block walks the (tile, head) items; each item's loads go
// into one of two ring slots while the item before is computed. Four warps:
// phase Q (four items, or K9's one at window 8), a barrier, phase K (four
// items). Two blocks a SM (their slots fill shared memory up to head dim
// 96): the bound lets ptxas give a thread up to 255 registers, where
// __launch_bounds__(128) alone held the head-dim-128 instance to 168 and it
// spilled.
template <int WIN, bool QPOOL, int DP>
__global__ void __launch_bounds__(kSwThreads, 2) k5_k9_window_attn_bwd_kernel(
    const __grid_constant__ SwParams p) {
  using Sh = SwShape<WIN, QPOOL, DP>;
  constexpr int LDS = Sh::LDS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  float* lse2s = reinterpret_cast<float*>(sm + Sh::STATS);
  float* ds = lse2s + 64;
  bf16* qp = sm + Sh::QP;
  // every column past d reads zero from here on: the loads write only the
  // first d
  for (int i = threadIdx.x; i < Sh::STATS / 8; i += kSwThreads)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, ch = p.d / 8;
  int item = blockIdx.x;
  if (item < p.items) sw_load<WIN, QPOOL, DP>(p, item, sm);
  cp_async_commit();
  for (int n = 0; item < p.items; item += gridDim.x, ++n) {
    const bf16* slot = sm + (n & 1) * Sh::SLOT;
    if (item + gridDim.x < p.items)
      sw_load<WIN, QPOOL, DP>(p, item + gridDim.x, sm + ((n + 1) & 1) * Sh::SLOT);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const SwTile t = sw_tile(p, item, Sh::G);
    const bf16* Q = slot + 128 * LDS;
    if constexpr (QPOOL) {
      // the 2x2 max of each cell of the raw q, 16 bytes at a time
      for (int i = threadIdx.x; i < Sh::QROWS * ch; i += kSwThreads) {
        const int q = i / ch, c8 = i - q * ch;
        uint4 v = *reinterpret_cast<const uint4*>(Q + sw_cell_row<WIN>(q, 0) * LDS + 8 * c8);
#pragma unroll
        for (int k = 1; k < 4; ++k) {
          const uint4 u = *reinterpret_cast<const uint4*>(Q + sw_cell_row<WIN>(q, k) * LDS + 8 * c8);
          v.x = max_bf16x2(v.x, u.x);
          v.y = max_bf16x2(v.y, u.y);
          v.z = max_bf16x2(v.z, u.z);
          v.w = max_bf16x2(v.w, u.w);
        }
        *reinterpret_cast<uint4*>(qp + q * LDS + 8 * c8) = v;
      }
      __syncthreads();
      Q = qp;
    }
    if (warp < Sh::QITEMS) sw_query_side<WIN, QPOOL, DP>(p, t, slot, Q, warp, lse2s, ds, lane);
    __syncthreads();
    sw_key_side<WIN, QPOOL, DP>(p, t, slot, Q, warp, lse2s, ds, lane);
    __syncthreads();   // the slot is refilled by the next item's prefetch
  }
  cp_async_wait<0>();
}

// The padded head dim of an instance: d up to 80 (hiera_l's 72), 96
// (hiera_s's) or 128. (An instance of 64 spilled at window 4 with the
// q-pool; the smaller head dims take 80's.)
inline int sw_head_dim(int d) { return d <= 80 ? 80 : d <= 96 ? 96 : 128; }

template <int WIN, bool QPOOL, int DP>
cudaError_t sw_launch(const SwParams& p, cudaStream_t s) {
  using Sh = SwShape<WIN, QPOOL, DP>;
  auto kernel = k5_k9_window_attn_bwd_kernel<WIN, QPOOL, DP>;
  static bool raised[64] = {};
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), Sh::SMEM, raised);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSwThreads, Sh::SMEM);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int cap = per_sm * sm_count();
  kernel<<<p.items < cap ? p.items : cap, kSwThreads, Sh::SMEM, s>>>(p);
  return cudaGetLastError();
}

template <int WIN, bool QPOOL>
cudaError_t sw_dispatch(const SwParams& p, cudaStream_t s) {
  switch (sw_head_dim(p.d)) {
    case 80: return sw_launch<WIN, QPOOL, 80>(p, s);
    case 96: return sw_launch<WIN, QPOOL, 96>(p, s);
    default: return sw_launch<WIN, QPOOL, 128>(p, s);
  }
}

// The small-window pass over the (B, H, W) grid's windows of `window` (4 or
// 8) tokens a side: qkv rows `ld` apart, dO rows C apart (K9: over the
// pooled grid), dqkv rows `ldo` apart.
cudaError_t window_attention_bwd(const void* qkv, const void* dout, void* dqkv, long long ld,
                                 long long ldo, int B, int H, int W, int C, int nh, int window,
                                 bool qpool, cudaStream_t s) {
  SwParams p = {};
  p.qkv = static_cast<const bf16*>(qkv);
  p.dout = static_cast<const bf16*>(dout);
  p.dqkv = static_cast<bf16*>(dqkv);
  p.ld = ld;
  p.ldo = ldo;
  p.H = H;
  p.W = W;
  p.C = C;
  p.nh = nh;
  p.d = C / nh;
  p.wins_h = H / window;
  p.wins_w = W / window;
  const int G = 64 / (window * window);
  p.tiles_w = (p.wins_w + G - 1) / G;
  const long long items = (long long)B * p.wins_h * p.tiles_w * nh;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  p.items = (int)items;
  p.scale = 1.f / sqrtf((float)p.d);
  p.scale_log2 = p.scale * 1.4426950408889634f;
  if (window == 8) return qpool ? sw_dispatch<8, true>(p, s) : sw_dispatch<8, false>(p, s);
  return qpool ? sw_dispatch<4, true>(p, s) : sw_dispatch<4, false>(p, s);
}

// ------------------------------------------------------------ launchers

cudaError_t k3_launch(const void* x, const void* gy, const void* w1, const void* b1,
                      const void* w2, const void* b2, float* part, void* dx, float* dw1,
                      float* db1, float* dw2, float* db2, long long M, int C, int residual,
                      int blocks, cudaStream_t stream) {
  const K3Plan plan = k3_plan(C);
  K3Args p = {};
  if (!plan.smem || !tensor_map_2d(&p.x, x, C, M, C, 64, 64)
      || !tensor_map_2d(&p.gy, gy, C, M, C, 64, 64) || !tensor_map_2d(&p.dx, dx, C, M, C, 64, 64)
      || !tensor_map_2d(&p.w1, w1, C, 32, C, 64, 32) || !tensor_map_2d(&p.w2, w2, 32, C, 32, 32, 64))
    return cudaErrorInvalidValue;
  const long long mt = (M + 63) / 64;
  if (mt > INT_MAX || blocks > mt) return cudaErrorInvalidValue;
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.part = part;
  p.C = C;
  p.atoms = (C + 63) / 64;
  p.mt = (int)mt;
  p.ring = plan.ring;
  p.residual = residual;
  auto kernel = plan.smem_part ? k3_adapter_bwd_sm90_kernel<true> : k3_adapter_bwd_sm90_kernel<false>;
  static bool raised[2][64] = {};
  // every width's plan fits under the card's most, which each instance takes once
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), kSmemLimit,
                                  raised[plan.smem_part]);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kK3Threads, plan.smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int per = p.atoms * kPartFloats + 32;
  k3_reduce_kernel<<<(per + 255) / 256, 256, 0, stream>>>(part, blocks, p.atoms, C, dw1, db1, dw2,
                                                          db2);
  return cudaGetLastError();
}

// The query side and the dk/dv pass over the (nW, S, heads, d) views of qkv
// (q, k, v at channel offsets 0, c, 2c, token stride 3c), dO (token stride
// c) and dqkv (as qkv), at head dim instance D.
template <int D>
cudaError_t attention_bwd(const void* qkv, const void* dout, float* lse, float* Dv, void* dqkv,
                          int nW, int S, int c, int nh, cudaStream_t stream) {
  using Sh = k11::Shape<D>;
  const int d = c / nh;
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  long long st[3] = {(long long)S * 3 * c, 3LL * c, d}, sd[3] = {(long long)S * c, c, d};
  map_strides(st, nW, nh, d, S);
  map_strides(sd, nW, nh, d, S);
  const float scale = 1.f / sqrtf((float)d);
  QsideParams qp = {};
  k11::Params kp = {};
  if (!tensor_map_bshd(&qp.q, q, nW, S, nh, d, st[0], st[1], st[2], Sh::ROWS)
      || !tensor_map_bshd(&qp.dout, dout, nW, S, nh, d, sd[0], sd[1], sd[2], Sh::ROWS)
      || !tensor_map_bshd(&qp.k, q + c, nW, S, nh, d, st[0], st[1], st[2], 64)
      || !tensor_map_bshd(&qp.v, q + 2 * c, nW, S, nh, d, st[0], st[1], st[2], 64)
      || !tensor_map_bshd(&kp.q, q, nW, S, nh, d, st[0], st[1], st[2], 64)
      || !tensor_map_bshd(&kp.dout, dout, nW, S, nh, d, sd[0], sd[1], sd[2], 64)
      || !tensor_map_bshd(&kp.k, q + c, nW, S, nh, d, st[0], st[1], st[2], Sh::ROWS)
      || !tensor_map_bshd(&kp.v, q + 2 * c, nW, S, nh, d, st[0], st[1], st[2], Sh::ROWS))
    return cudaErrorInvalidValue;
  qp.lse = lse;
  qp.D = Dv;
  qp.dq = dq;
  qp.o_sb = (long long)S * 3 * c;
  qp.o_ss = 3LL * c;
  qp.o_sh = d;
  qp.S = S;
  qp.nh = nh;
  qp.d = d;
  qp.scale = scale;
  qp.scale_log2 = scale * 1.4426950408889634f;
  kp.lse = lse;
  kp.D = Dv;
  kp.dk = dq + c;
  kp.dv = dq + 2 * c;
  kp.o_sb = qp.o_sb;
  kp.o_ss = qp.o_ss;
  kp.o_sh = qp.o_sh;
  kp.Sq = kp.Sk = S;
  kp.nh = nh;
  kp.d = d;
  kp.scale = scale;
  kp.scale_log2 = qp.scale_log2;
  const dim3 grid((S + Sh::ROWS - 1) / Sh::ROWS, nh, nW);
  static bool raised[2][64] = {};
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(k7_qside_sm90_kernel<D>),
                                  QShape<D>::SMEM, raised[0]);
  if (e != cudaSuccess) return e;
  k7_qside_sm90_kernel<D><<<grid, 384, QShape<D>::SMEM, stream>>>(qp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = smem_limit_once(reinterpret_cast<const void*>(k11::k11_dkv_sm90_kernel<D>), Sh::SMEM,
                      raised[1]);
  if (e != cudaSuccess) return e;
  k11::k11_dkv_sm90_kernel<D><<<grid, 384, Sh::SMEM, stream>>>(kp);
  return cudaGetLastError();
}

}  // namespace

// K3: dx (M, C), and dW1 (32, C), db1, dW2 (C, 32), db2 in fp32, of the
// adapter (hidden 32) for a cotangent gy; bf16 only. `part` holds `blocks`
// blocks' partial sums (A kPartFloats + 32 floats each, A = C / 64 rounded
// up), the grid of the streaming pass: at most one block per SM and per
// 64-row tile.
extern "C" int k3_adapter_bwd_sm90(int is_bf16, const void* x, const void* gy, const void* w1,
                                   const void* b1, const void* w2, const void* b2, float* part,
                                   void* dx, float* dw1, float* db1, float* dw2, float* db2,
                                   long long M, int C, int Hd, int residual, int blocks,
                                   void* stream) {
  if (!is_bf16 || M < 1 || C < 8 || Hd != 32 || blocks < 1
      || !views_vec16(C, {}, {x, gy, w1, w2, dx}))
    return (int)cudaErrorInvalidValue;
  return (int)k3_launch(x, gy, w1, b1, w2, b2, part, dx, dw1, db1, dw2, db2, M, C, residual,
                        blocks, reinterpret_cast<cudaStream_t>(stream));
}

// K3's plan at width C: the shared-memory bytes of a block (0 where C is
// past what the kernel takes), its ring's slots and whether the partials
// stay in shared memory, into plan[0..2].
extern "C" int k3_adapter_bwd_sm90_plan(int C, int* plan) {
  const K3Plan p = k3_plan(C);
  plan[0] = p.smem;
  plan[1] = p.ring;
  plan[2] = p.smem_part;
  return 0;
}

// K7: dx (nW, S, c) of the window block, dx-only and unmasked; the
// arguments of k7_window_block_bwd (csrc/fused_attention_block_bwd.cu)
// without O, bf16 only, head dims multiples of 8 up to 128.
extern "C" int k7_window_block_bwd_sm90(int is_bf16, const void* x, const void* gy,
                                        const void* w_qkv, const void* b_qkv, const void* ln_w,
                                        const void* ln_b, const void* w_proj, void* xn, void* qkv,
                                        float* lse, void* dout, float* D, void* dqkv, void* dxn,
                                        void* dx, int nW, int S, int c, int nh, int residual,
                                        void* stream) {
  if (!is_bf16 || nW < 1 || nW > 65535 || S < 1 || nh < 1 || nh > 65535 || c % nh
      || (c / nh) > 128
      || !views_vec16(c / nh, {c}, {x, gy, w_qkv, w_proj, xn, qkv, dout, dqkv, dxn, dx}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)nW * S;
  cudaError_t e = launch_ln_dt(1, x, ln_w, ln_b, xn, M, c, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kOut>(xn, w_qkv, b_qkv, nullptr, qkv, M, 3 * c, c, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(gy, w_proj, nullptr, nullptr, dout, M, c, c, s);
  if (e != cudaSuccess) return (int)e;
  switch (padded_head_dim(c / nh)) {
    case 64: e = attention_bwd<64>(qkv, dout, lse, D, dqkv, nW, S, c, nh, s); break;
    case 96: e = attention_bwd<96>(qkv, dout, lse, D, dqkv, nW, S, c, nh, s); break;
    default: e = attention_bwd<128>(qkv, dout, lse, D, dqkv, nW, S, c, nh, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(dqkv, w_qkv, nullptr, nullptr, dxn, M, c, 3 * c, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(1, x, ln_w, dxn, residual ? gy : nullptr, dx, M, c, s);
}

// The dynamic shared memory, in bytes, of K7's query-side block (dk_dv 0)
// or its dk/dv block (K11's block shape) at head dim d.
extern "C" int k7_window_block_bwd_sm90_smem(int d, int dk_dv) {
  switch (padded_head_dim(d)) {
    case 64: return dk_dv ? k11::Shape<64>::SMEM : QShape<64>::SMEM;
    case 96: return dk_dv ? k11::Shape<96>::SMEM : QShape<96>::SMEM;
    default: return dk_dv ? k11::Shape<128>::SMEM : QShape<128>::SMEM;
  }
}

// K5: dx (B, H, W, c) of the strip block on a grid `window` (4 or 8)
// divides; the arguments of k5_window_block_strips_bwd
// (csrc/fused_attention_block_bwd.cu) without O, lse and D, bf16 only,
// head dims multiples of 8 up to 128.
extern "C" int k5_window_block_strips_bwd_sm90(int is_bf16, const void* x, const void* gy,
                                               const void* w_qkv, const void* b_qkv,
                                               const void* ln_w, const void* ln_b,
                                               const void* w_proj, void* xn, void* qkv,
                                               void* dout, void* dqkv, void* dxn, void* dx, int B,
                                               int H, int W, int c, int nh, int window,
                                               int residual, void* stream) {
  if (!is_bf16 || B < 1 || H < 1 || W < 1 || nh < 1 || c % nh || (c / nh) > 128
      || (window != 4 && window != 8) || H % window || W % window
      || !views_vec16(c / nh, {c}, {x, gy, w_qkv, w_proj, xn, qkv, dout, dqkv, dxn, dx}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W;
  cudaError_t e = launch_ln_dt(1, x, ln_w, ln_b, xn, M, c, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kOut>(xn, w_qkv, b_qkv, nullptr, qkv, M, 3 * c, c, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(gy, w_proj, nullptr, nullptr, dout, M, c, c, s);
  if (e != cudaSuccess) return (int)e;
  e = window_attention_bwd(qkv, dout, dqkv, 3LL * c, 3LL * c, B, H, W, c, nh, window, false, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(dqkv, w_qkv, nullptr, nullptr, dxn, M, c, 3 * c, s);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(1, x, ln_w, dxn, residual ? gy : nullptr, dx, M, c, s);
}

// K9: dx (B, H, W, cin) of the q-pool transition on a grid an even
// `window` (4 or 8) divides; the arguments of k9_transition_bwd
// (csrc/fused_transition_bwd.cu) without O, lse and D, bf16 only, cin, cout
// and the head dim multiples of 8, the head dim up to 128. dcat is (B H W,
// 4 cout): dq, dk, dv, dshort; xn holds the second branch's sum at the end.
extern "C" int k9_transition_bwd_sm90(int is_bf16, const void* x, const void* gy,
                                      const void* w_qkv, const void* b_qkv, const void* ln_w,
                                      const void* ln_b, const void* w_proj, const void* w_short,
                                      const void* b_short, void* xn, void* qkv, void* shortcut,
                                      void* dout, void* dcat, void* dxn, void* dx, int B, int H,
                                      int W, int cin, int cout, int nh, int window,
                                      void* stream) {
  if (!is_bf16 || B < 1 || H < 1 || W < 1 || nh < 1 || cout % nh || (cout / nh) > 128
      || (window != 4 && window != 8) || H % window || W % window
      || !views_vec16(cout / nh, {cin, cout},
                      {x, gy, w_qkv, w_proj, w_short, xn, qkv, shortcut, dout, dcat, dxn, dx}))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long M = (long long)B * H * W, M2 = M / 4;
  cudaError_t e = launch_ln_dt(1, x, ln_w, ln_b, xn, M, cin, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kOut>(xn, w_qkv, b_qkv, nullptr, qkv, M, 3 * cout, cin, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kOut>(xn, w_short, b_short, nullptr, shortcut, M, cout, cin, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(gy, w_proj, nullptr, nullptr, dout, M2, cout, cout, s);
  if (e != cudaSuccess) return (int)e;
  e = window_attention_bwd(qkv, dout, dcat, 3LL * cout, 4LL * cout, B, H, W, cout, nh, window,
                           true, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_unpool2x2<bf16>(shortcut, gy, dcat, B, H, W, cout, s);
  if (e != cudaSuccess) return (int)e;
  // dLN(x) = round(dqkv W_qkv) + round(dshort W_short): the second product's
  // epilogue adds the first after rounding its own
  e = sm90::gemm<sm90::kDz>(dcat, w_qkv, nullptr, nullptr, dxn, M, cin, 3 * cout, s, 4LL * cout);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<sm90::kDz>(static_cast<const bf16*>(dcat) + 3LL * cout, w_short, nullptr, dxn,
                            xn, M, cin, cout, s, 4LL * cout);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ln_bwd_dt(1, x, ln_w, xn, nullptr, dx, M, cin, s);
}

// The dynamic shared memory, in bytes, of K5's (qpool 0) or K9's small-window
// pass at window 4 or 8 and head dim d.
extern "C" int k5_k9_window_attn_smem(int window, int qpool, int d) {
  const int dp = sw_head_dim(d);
#define SW_SMEM(WIN, QP)                                            \
  (dp == 80 ? SwShape<WIN, QP, 80>::SMEM : dp == 96 ? SwShape<WIN, QP, 96>::SMEM \
            : SwShape<WIN, QP, 128>::SMEM)
  if (window == 8) return qpool ? SW_SMEM(8, true) : SW_SMEM(8, false);
  return qpool ? SW_SMEM(4, true) : SW_SMEM(4, false);
#undef SW_SMEM
}
