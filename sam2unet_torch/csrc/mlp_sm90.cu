// K2 and K1 in bf16 on Hopper's asynchronous path: the frozen MLP's dx and
// the fused MLP's forward on one persistent, warp-specialised GEMM main loop
// whose products run on warpgroup MMAs (wgmma) fed by TMA, and the adapter
// (hidden 32) in one streaming pass.
//
// Replaces sam2unet_tpu/ops/pallas/fused_mlp.py::_mlp_bwd_dx_kernel (:356,
// launched by _mlp_bwd_dx at :432; K2, all four modes) and ::_kernel (:26,
// launched by _fused_mlp_vjp at :135; K1, every mode) where the call is bf16
// and C, hidden and Cout are multiples of 8 on 16-byte aligned bases, what a
// TMA tensor map addresses (`_mlp_library` in ops/fused_mlp.py). fp32 stays
// on csrc/fused_mlp.cu and csrc/fused_mlp_bwd.cu (the CUDA-core GEMM of
// gemm.cuh), every other width there and on csrc/gemm_any.cu.
//
// What each computes, in the plain versions' rounding (products accumulate
// in fp32; GELU's erf to 1.5e-7, `gelu_q`, where the plain versions' erff
// is exact to an ulp: the outputs are rounded to bf16, 4e-3):
//   K1: [xn = LN(x) in bf16, the LN pass of gemm.cuh], h = round(GELU(xn
//     W1^T + b1)), o = h W2^T + b2, [GELU], [round, + x], round.
//   K2: [xn], and in one tile pre = xn W1^T + b1 beside gy W2, dh =
//     round((gy W2) gelu'(pre)): the fp32 pre-activation never leaves the
//     registers; dz = dh W1, rounded (without LN plus gy where there is a
//     residual: dx itself); with LN dx = LN's backward of dz [+ gy] (the
//     pass of gemm_bwd.cuh).
//
// Bound on an H100: at hidden 4C the two products of K1 do 16 C^2
// operations a row against 4 C bytes moved (x in, o out), K2's three 24 C^2
// against 6 C bytes: 4 C operations a byte, past the ridge (~295) from C 96
// up, so the tensor cores bound both. The adapter (hidden 32) does 32
// operations a byte: its bytes bound it.
//
// The main loop (mlp_gemm_sm90_kernel in csrc/gemm_sm90.cuh, one template
// instance per product kind and column tile). A persistent block per SM
// (at most as many as tiles) walks 128 x BN output tiles, column tiles fastest (the row tile
// of A stays in L2 across them). One producer thread keeps TMA loads of
// 64-deep k-steps of A (128 rows) and B in flight through a ring of 4-8
// stages with full and empty mbarriers; two consumer warpgroups run m64 x BN
// wgmma (setmaxnreg gives them 232 registers; ptxas holds every thread to
// the launch bound's 168), one k-step's group in flight while the next is
// issued, each stage going back as soon as its group has completed. The
// epilogue writes the tile's whole 64-column atoms into a 128-byte-swizzled
// staging buffer, which a TMA store takes out while the next tile's products
// run (threads' own 4-byte stores ran at a third of the card's write rate),
// and loads its bias and residual pairs ahead of the arithmetic. The two
// consumers share each tile, 64 rows each. BN: the widest of 192, 144 and
// 96 (K1's second product 144 and 96, K2's dual tile 128 and 96) that leaves
// the fewest columns idle, narrowed where that fills more SMs (the window
// groups' short row counts); the main path's widths (hiera_s 96-768,
// hiera_l 144-1152, hidden 4C, all multiples of 48) leave none. K past the tensor's end reads
// as zeros (C 96 is 1.5 k-steps); rows past M and columns past N are never
// stored. The torch weight W (N, K) is a K-major B for A W^T; gy W2 and dh
// W1 read the same weights MN-major (the transpose bit), so no weight is
// copied. Kinds: kGelu (K1's first product: + b1, GELU, round), kOut (K1's
// second: + b2, [round + x], round), kDual (K2's two accumulators over C and
// over Cout, one epilogue), kDz (dh W1 [round + gy]). GELU on K1's output
// (gelu_out) runs only in the adapter kernel: `_mlp_library` sends its other
// calls to csrc/fused_mlp.cu.
//
// The adapter (mlp_adapter_sm90_kernel, no LN, hidden 32, Cout = C): W1 and
// W2 stay in shared memory for the block's life (W2 where it fits beside an
// x tile: up to C 768; at C 1152 its 64-row chunks stream through a two-deep
// ring). Each 64-row tile of x comes in once by TMA into a ring of slots;
// both consumer warpgroups form h = GELU(x W1^T + b1) (m64n32 wgmma), round
// it to bf16 as the plain version does and keep it in registers as the A
// fragments of the second product, which each warpgroup runs over its half
// of the 64-column chunks of C (m64n64, W2 K-major in 64-byte-swizzled
// rows). The epilogue reads the residual from the tile in shared memory,
// writes the output over it and stores the chunk by TMA: x is read once and
// the output written once.

#include <limits.h>

#include "gemm_bwd.cuh"
#include "gemm_sm90.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

// the GEMM main loop and its helpers (csrc/gemm_sm90.cuh)
using sm90::gelu_fast;
using sm90::kDual;
using sm90::kDz;
using sm90::kGelu;
using sm90::kOut;
using sm90::lds32;
using sm90::ldg_pair;
using sm90::staged;
using sm90::sts32;
using sm90::unpack_bf16;

constexpr int kSmemLimit = 232448;
constexpr int kAtom = 64 * 128;    // a 64-row, 64-column swizzled region

// ---------------------------------------------------------------- adapter

constexpr int kMaxSlots = 4;
constexpr int kW1Atom = 32 * 128;   // 32 rows of W1 by 64 columns
constexpr int kW2Chunk = 64 * 64;   // 64 rows of W2 by its 32 columns

struct AdapterArgs {
  CUtensorMap x, w1, w2, out;
  const bf16 *b1, *b2;
  int C, atoms;         // atoms: 64-column chunks of C
  int mt, slots;        // 64-row tiles, x slots in the ring
  int residual, gelu_out;
};

// Shared memory: W1, W2 (whole, or a two-chunk ring), the x slots, then the
// barriers: weights, slot full[kMaxSlots], slot empty[kMaxSlots], W2 chunk
// full[2], W2 chunk empty[2].
struct AdapterSmem {
  uint32_t w1, w2, slot0, slot_bytes, bars;
  __device__ uint32_t weights() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 + 8 * (kMaxSlots + s); }
  __device__ uint32_t w2_full(int i) const { return bars + 8 + 8 * (2 * kMaxSlots + i); }
  __device__ uint32_t w2_empty(int i) const { return bars + 8 + 8 * (2 * kMaxSlots + 2 + i); }
};
constexpr int kAdapterBars = 8 * (1 + 2 * kMaxSlots + 4);

template <bool W2_RES>
__device__ __forceinline__ AdapterSmem adapter_smem(uint32_t base, const AdapterArgs& p) {
  AdapterSmem m;
  m.w1 = base;
  m.w2 = m.w1 + p.atoms * kW1Atom;
  m.slot0 = m.w2 + (W2_RES ? p.atoms : 2) * kW2Chunk;
  m.slot_bytes = p.atoms * kAtom;
  m.bars = m.slot0 + p.slots * m.slot_bytes;
  return m;
}

template <bool W2_RES>
__device__ __forceinline__ void adapter_produce(const AdapterArgs& p, const AdapterSmem& m) {
  const int A = p.atoms;
  mbar_arrive_tx(m.weights(), A * kW1Atom + (W2_RES ? A * kW2Chunk : 0));
  for (int a = 0; a < A; ++a) tma_load_2d(m.w1 + a * kW1Atom, &p.w1, m.weights(), 64 * a, 0);
  if (W2_RES)
    for (int c = 0; c < A; ++c) tma_load_2d(m.w2 + c * kW2Chunk, &p.w2, m.weights(), 0, 64 * c);
  int j = 0;
  for (int tile = blockIdx.x; tile < p.mt; tile += gridDim.x, ++j) {
    const int s = j % p.slots;
    const uint32_t slot = m.slot0 + s * m.slot_bytes;
    mbar_wait(m.empty(s), ((j / p.slots) & 1) ^ 1);
    mbar_arrive_tx(m.full(s), A * kAtom);
    for (int a = 0; a < A; ++a) tma_load_2d(slot + a * kAtom, &p.x, m.full(s), 64 * a, 64 * tile);
    if (!W2_RES)
      for (int c = 0; c < A; ++c) {
        const int nc = j * A + c, st = nc & 1;
        mbar_wait(m.w2_empty(st), ((nc >> 1) & 1) ^ 1);
        mbar_arrive_tx(m.w2_full(st), kW2Chunk);
        tma_load_2d(m.w2 + st * kW2Chunk, &p.w2, m.w2_full(st), 0, 64 * c);
      }
  }
}

// Chunk c (64 columns) of the adapter's output from y, over x's place in
// the tile at `at` (its 64-byte swizzled rows): + b2, [GELU], [round + x],
// round. GUARD stores only the columns below C; a chunk wholly inside runs
// without a branch.
template <bool GUARD, bool GELU_OUT, bool RES>
__device__ __forceinline__ void adapter_rows(const AdapterArgs& p, const float* y, uint32_t at,
                                             int c, int warp, int lane) {
  const int t4 = lane % 4, row0 = frag_row(warp, lane, 0);
  // the bias and the residual first, then the arithmetic (as the GEMM's)
  float2 b[8];
  uint32_t r[8][2];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 64 * c + 8 * jj + 2 * t4;
    if (GUARD && col >= p.C) break;
    b[jj] = unpack_bf16(ldg_pair(p.b2 + col));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (RES) r[jj][hh] = lds32(staged(at, row0 + 8 * hh, jj, t4));
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 64 * c + 8 * jj + 2 * t4;
    if (GUARD && col >= p.C) break;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = 4 * jj + 2 * hh;
      float v0 = y[i] + b[jj].x, v1 = y[i + 1] + b[jj].y;
      if (GELU_OUT) {
        v0 = gelu_fast(v0);
        v1 = gelu_fast(v1);
      }
      if (RES) {
        const float2 x = unpack_bf16(r[jj][hh]);
        v0 = round_to<bf16>(v0) + x.x;
        v1 = round_to<bf16>(v1) + x.y;
      }
      sts32(staged(at, row0 + 8 * hh, jj, t4), pack_bf16(v0, v1));
    }
  }
}

template <bool GUARD>
__device__ __forceinline__ void adapter_chunk(const AdapterArgs& p, const float* y, uint32_t at,
                                              int c, int warp, int lane) {
  if (p.gelu_out) {
    if (p.residual) adapter_rows<GUARD, true, true>(p, y, at, c, warp, lane);
    else adapter_rows<GUARD, true, false>(p, y, at, c, warp, lane);
  } else {
    if (p.residual) adapter_rows<GUARD, false, true>(p, y, at, c, warp, lane);
    else adapter_rows<GUARD, false, false>(p, y, at, c, warp, lane);
  }
}

template <bool W2_RES>
__global__ void __launch_bounds__(384, 1) mlp_adapter_sm90_kernel(const __grid_constant__ AdapterArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const AdapterSmem m = adapter_smem<W2_RES>(smem_base(smem_raw), p);
  if (threadIdx.x == 0) {
    mbar_init(m.weights(), 1);
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), 2);         // one thread of each consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(m.w2_full(i), 1);
      mbar_init(m.w2_empty(i), 128);    // the warpgroup that read the chunk
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = warpgroup();
  if (wg == 2) {
    if (threadIdx.x == 256) adapter_produce<W2_RES>(p, m);
    return;
  }

  const int A = p.atoms;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t4 = lane % 4;
  const bool elected = threadIdx.x % 128 == 0;
  mbar_wait(m.weights(), 0);
  int j = 0;
  for (int tile = blockIdx.x; tile < p.mt; tile += gridDim.x, ++j) {
    const int s = j % p.slots;
    const uint32_t slot = m.slot0 + s * m.slot_bytes;
    mbar_wait(m.full(s), (j / p.slots) & 1);

    // h = x W1^T over C (both warpgroups form it), then GELU(h + b1)
    // rounded to bf16 as the A fragments of the second product
    // (a fence, the atom's four k-steps and a commit in each iteration of
    // this runtime-count loop: where the loop held the wgmma alone, with one
    // fence before it and the commit after it, ptxas injected a
    // warpgroup.arrive at the loop's wgmma and at that commit, C7519)
    float h[16];
    zero<16>(h);
    for (int a = 0; a < A; ++a) {
      fence_regs<16>(h);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<32, 0>(h, desc_k(slot + a * kAtom + kk * 32), desc_k(m.w1 + a * kW1Atom + kk * 32),
                        1);
      wg_commit();
    }
    wg_wait<0>();
    fence_regs<16>(h);
#pragma unroll
    for (int i = 0; i < 16; ++i) h[i] = gelu_fast(h[i] + to_f(p.b1[8 * (i / 4) + 2 * t4 + (i & 1)]));
    uint32_t ha[2][4];
    to_a_frags<2>(h, ha);
    named_sync(1, 256);   // both warpgroups have read the tile: it may be overwritten

    for (int c = wg; c < A; c += 2) {
      const int nc = j * A + c;
      uint32_t w2 = m.w2 + c * kW2Chunk;
      if (!W2_RES) {
        w2 = m.w2 + (nc & 1) * kW2Chunk;
        mbar_wait(m.w2_full(nc & 1), (nc >> 1) & 1);
      }
      float y[32];
      zero<32>(y);
      fence_regs<32>(y);
      fence_regs<8>(&ha[0][0]);
      wg_fence();
      wgmma_rs_m64n64k16_t<0>(y, ha[0], desc_k64(w2), 0);
      wgmma_rs_m64n64k16_t<0>(y, ha[1], desc_k64(w2 + 32), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(y);
      fence_regs<8>(&ha[0][0]);
      if (!W2_RES) mbar_arrive(m.w2_empty(nc & 1));

      const uint32_t at = slot + c * kAtom;
      if (64 * c + 64 <= p.C) adapter_chunk<false>(p, y, at, c, warp, lane);
      else adapter_chunk<true>(p, y, at, c, warp, lane);
      fence_proxy_async();
      named_sync(2 + wg, 128);
      if (elected) {
        tma_store_2d(&p.out, at, 64 * c, 64 * tile);
        bulk_commit();
      }
    }
    // the slot goes back once this warpgroup's stores have read it
    if (elected) {
      bulk_wait_read<0>();
      mbar_arrive(m.empty(s));
    }
  }
  if (elected) bulk_wait<0>();
}

// dh (M x Hd) = round((gy W2) gelu'(A W1^T + b1)): A (M x C), W1 (Hd x C)
// K-major, gy (M x Cout), W2 (Cout x Hd) MN-major.
cudaError_t dual(const void* A, const void* W1, const void* b1, const void* gy, const void* W2,
                 void* dh, long long M, int C, int Hd, int Cout, cudaStream_t stream) {
  const int bn = sm90::pick_bn(M, Hd, {128, 96});
  sm90::GemmArgs p = {};
  if (!tensor_map_2d(&p.a, A, C, M, C, 64, sm90::kBM) || !tensor_map_2d(&p.b, W1, C, Hd, C, 64, bn)
      || !tensor_map_2d(&p.a2, gy, Cout, M, Cout, 64, sm90::kBM)
      || !tensor_map_2d(&p.b2, W2, Hd, Cout, Hd, 64, 64)
      || !tensor_map_2d(&p.o, dh, Hd, M, Hd, 64, 64))
    return cudaErrorInvalidValue;
  p.bias = static_cast<const bf16*>(b1);
  p.out = static_cast<bf16*>(dh);
  p.M = M;
  p.N = Hd;
  p.nk1 = (C + 63) / 64;
  p.nk2 = (Cout + 63) / 64;
  return bn == 128 ? sm90::launch_gemm<128, kDual>(p, stream) : sm90::launch_gemm<96, kDual>(p, stream);
}

// The adapter kernel's shared memory at width C, and whether W2 stays whole
// in it (else it streams); 0 where not even one x slot fits.
int adapter_plan(int C, bool* w2_res, int* slots) {
  const int A = (C + 63) / 64, w1 = A * kW1Atom, slot = A * kAtom;
  const int room = kSmemLimit - 1024 - kAdapterBars - w1;
  *w2_res = room - A * kW2Chunk >= slot;
  const int fit = (room - (*w2_res ? A * kW2Chunk : 2 * kW2Chunk)) / slot;
  *slots = fit < kMaxSlots ? fit : kMaxSlots;
  if (*slots < 1) return 0;
  return kSmemLimit - room + (*w2_res ? A * kW2Chunk : 2 * kW2Chunk) + *slots * slot;
}

cudaError_t adapter(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* out, long long M, int C, int residual, int gelu_out, int smem,
                    bool w2_res, int slots, cudaStream_t stream) {
  AdapterArgs p = {};
  if (!tensor_map_2d(&p.x, x, C, M, C, 64, 64) || !tensor_map_2d(&p.out, out, C, M, C, 64, 64)
      || !tensor_map_2d(&p.w1, w1, C, 32, C, 64, 32) || !tensor_map_2d(&p.w2, w2, 32, C, 32, 32, 64))
    return cudaErrorInvalidValue;
  const long long mt = (M + 63) / 64;
  if (mt > INT_MAX) return cudaErrorInvalidValue;
  p.b1 = static_cast<const bf16*>(b1);
  p.b2 = static_cast<const bf16*>(b2);
  p.C = C;
  p.atoms = (C + 63) / 64;
  p.mt = (int)mt;
  p.slots = slots;
  p.residual = residual;
  p.gelu_out = gelu_out;
  const int grid = p.mt < sm_count() ? p.mt : sm_count();
  // every width's plan fits under the card's most, which each instance
  // takes once
  auto kernel = w2_res ? mlp_adapter_sm90_kernel<true> : mlp_adapter_sm90_kernel<false>;
  static bool raised[2][64] = {};
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), kSmemLimit,
                                  raised[w2_res]);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 384, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// K1: out (M, Cout) of [LN ->] x W1^T + b1 -> GELU -> W2^T + b2 [-> GELU]
// [-> + x]; the arguments of k1_fused_mlp (csrc/fused_mlp.cu), bf16 only.
// The adapter form (no LN, hidden 32, Cout = C) runs the streaming kernel
// where its tiles fit shared memory; everything else the LN pass and two
// products, the hidden (M, Hd) through `hidden`. GELU on the output runs in
// the adapter kernel only: a gelu_out call it does not take is refused.
extern "C" int k1_fused_mlp_sm90(int is_bf16, const void* x, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* ln_w,
                                 const void* ln_b, void* xn, void* hidden, void* out,
                                 long long M, int C, int Hd, int Cout, int residual,
                                 int gelu_out, void* stream) {
  if (!is_bf16 || M < 0 || C < 8 || Hd < 8 || Cout < 8 || (residual && Cout != C)
      || !views_vec16(C, {Hd, Cout}, {x, w1, w2, out, hidden, xn}))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  bool w2_res = false;
  int slots = 0;
  const int smem = !ln_w && Hd == 32 && Cout == C ? adapter_plan(C, &w2_res, &slots) : 0;
  if (smem)
    return (int)adapter(x, w1, b1, w2, b2, out, M, C, residual, gelu_out, smem, w2_res, slots, s);
  if (gelu_out) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (ln_w) {
    e = launch_ln_dt(1, x, ln_w, ln_b, xn, M, C, s);
    if (e != cudaSuccess) return (int)e;
  }
  e = sm90::gemm<kGelu>(ln_w ? xn : x, w1, b1, nullptr, hidden, M, Hd, C, s);
  if (e != cudaSuccess) return (int)e;
  const void* res = residual ? x : nullptr;
  return (int)sm90::gemm<kOut>(hidden, w2, b2, res, out, M, Cout, Hd, s);
}

// K2: dx (M, C) of [x +] MLP([LN](x)) for the frozen MLP; the arguments of
// k2_mlp_bwd_dx (csrc/fused_mlp_bwd.cu) without its fp32 pre-activation
// buffer, bf16 only: the LN pass, the dual tile (dh), dh W1 (dz, or dx
// without LN), the LN backward pass.
extern "C" int k2_mlp_bwd_dx_sm90(int is_bf16, const void* x, const void* gy, const void* w1,
                                  const void* b1, const void* w2, const void* ln_w,
                                  const void* ln_b, void* xn, void* dh, void* dz, void* dx,
                                  long long M, int C, int Hd, int Cout, int residual,
                                  void* stream) {
  if (!is_bf16 || M < 0 || C < 8 || Hd < 8 || Cout < 8 || (residual && Cout != C)
      || !views_vec16(C, {Hd, Cout}, {x, gy, w1, w2, xn, dh, dz, dx}))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (ln_w) {
    e = launch_ln_dt(1, x, ln_w, ln_b, xn, M, C, s);
    if (e != cudaSuccess) return (int)e;
  }
  e = dual(ln_w ? xn : x, w1, b1, gy, w2, dh, M, C, Hd, Cout, s);
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<kDz>(dh, w1, nullptr, !ln_w && residual ? gy : nullptr, ln_w ? dz : dx, M, C, Hd, s);
  if (e != cudaSuccess || !ln_w) return (int)e;
  return (int)launch_ln_bwd_dt(1, x, ln_w, dz, residual ? gy : nullptr, dx, M, C, s);
}
