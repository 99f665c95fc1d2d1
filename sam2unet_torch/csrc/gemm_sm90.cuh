// The persistent, warp-specialised bf16 GEMM main loop of Hopper's
// asynchronous path: products on warpgroup MMAs (wgmma) fed by TMA, the
// output staged and stored by TMA, in four epilogue kinds. Header-only, so
// that each library instantiates only the kinds and column tiles it calls:
// csrc/mlp_sm90.cu (K1 and K2, every kind) and csrc/block_bwd_sm90.cu (K5's,
// K7's and K9's projections: kOut for QKV [and K9's shortcut] plus its bias,
// kDz for dO = gy W_proj and dx_n = dqkv W_qkv [+ dshort W_short]). The
// design notes are csrc/mlp_sm90.cu's; also here the GELU and its
// derivative from one exponential and the swizzled shared-memory words the
// epilogues read and write.
#pragma once

#include <limits.h>

#include "common.cuh"
#include "hopper.cuh"

// Internal linkage (the unnamed namespace): each library that includes this
// header keeps its own kernels and its own once-per-device flags of
// `launch_gemm`. As vague-linkage symbols, a function-local static is
// unique across the process's libraries, so a library's launch would skip
// raising its own kernel's shared-memory limit once another library had
// raised its copy's (the launch then fails with cudaErrorInvalidValue).
namespace sm90 {
namespace {

using namespace hopper;

constexpr int kSmemLimit = 232448;
// Registers a thread holds after setmaxnreg (384 threads start at 168).
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

// GELU(v) = v Phi(v) and its derivative Phi(v) + v phi(v) from one
// exponential: erf(z) = 1 - q, q = poly(t) exp(-z^2), t = 1 / (1 + p z),
// z = |v| / sqrt(2) (Abramowitz and Stegun 7.1.26, |error| <= 1.5e-7, about
// an fp32 ulp of 1; exp(-z^2) is phi's own exponential): two MUFU
// operations and seven FMAs, where erff takes some twenty instructions and
// the epilogues of the GEMM spend their time in it.
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float gelu_q(float v, float* e) {
  const float z = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.0f, fmaf(0.3275911f, z, 1.0f));
  *e = ex2_approx(-1.4426950408889634f * z * z);
  float q = fmaf(1.061405429f, t, -1.453152027f);
  q = fmaf(q, t, 1.421413741f);
  q = fmaf(q, t, -0.284496736f);
  q = fmaf(q, t, 0.254829592f);
  return q * t * *e;
}
// 2 Phi(v) = 1 + erf(v / sqrt(2)) = 2 - q for v >= 0, q below.
__device__ __forceinline__ float gelu_fast(float v) {
  float e;
  const float q = gelu_q(v, &e);
  return 0.5f * v * (v >= 0.f ? 2.f - q : q);
}
__device__ __forceinline__ float dgelu_fast(float v) {
  float e;
  const float q = gelu_q(v, &e);
  return 0.5f * (v >= 0.f ? 2.f - q : q) + 0.3989422804014327f * v * e;
}

// A bf16 pair as floats (low half first).
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
// A pair of a tensor this kernel only reads.
__device__ __forceinline__ uint32_t ldg_pair(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

constexpr int kBM = 128;           // rows of a GEMM tile
constexpr int kAtom = 64 * 128;    // a 64-row, 64-column swizzled region
constexpr int kMaxStages = 8;

enum Kind { kGelu = 0, kOut = 1, kDual = 2, kDz = 3 };

template <int BN, int KIND> struct Tile {
  static constexpr int NA = (BN + 63) / 64;     // atoms of an MN-major B tile
  static constexpr int A_BYTES = kBM * 128;     // 128 rows x 64 k
  static constexpr int B_K = BN * 128;          // K-major: BN rows x 64 k
  static constexpr int B_MN = NA * kAtom;       // MN-major: 64 k-rows x NA atoms
  static constexpr int B_BYTES =
      KIND == kDual ? (B_K > B_MN ? B_K : B_MN) : KIND == kDz ? B_MN : B_K;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  // the output's staging: each consumer's 64 rows of the tile's whole
  // 64-column atoms, which go out by TMA (the BN % 64 columns past them,
  // at BN 96 and 144, by the threads' own stores)
  static constexpr int OUT_ATOMS = BN / 64;
  static constexpr int OUT_WG = OUT_ATOMS * kAtom;
  static constexpr int FIT = (kSmemLimit - 1024 - 16 * kMaxStages - 2 * OUT_WG) / STAGE;
  static constexpr int STAGES = FIT < kMaxStages ? FIT : kMaxStages;
  static constexpr int OUT_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = OUT_OFF + 2 * OUT_WG;   // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;   // + alignment slack
  static_assert(STAGES >= 4 && SMEM <= kSmemLimit, "ring depth");
};

struct GemmArgs {
  CUtensorMap a, b;     // A (M x K); B: W (N x K) K-major, or (K x N) MN-major
  CUtensorMap a2, b2;   // kDual's second product: gy (M x Cout), W2 (Cout x N)
  CUtensorMap o;        // the output (M x N), 64 x 64 boxes
  const bf16* bias;     // (N): kGelu, kOut; kDual: b1 of the pre-activation
  const bf16* res;      // (M x N) added after rounding (kOut, kDz), or null
  bf16* out;            // (M x N), contiguous
  long long M;
  int N;
  int nk1, nk2;         // 64-deep k-steps of the first and the second product
  int nt, tiles;        // column tiles, all tiles
};

// The producer's thread: every stage of every tile of this block, in the
// consumers' order, each into the ring once its last reader has released it.
template <int BN, int KIND>
__device__ __forceinline__ void produce(const GemmArgs& p, uint32_t base) {
  using T = Tile<BN, KIND>;
  const uint32_t bars = base + T::BAR_OFF;
  int n = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int m0 = (tile / p.nt) * kBM, n0 = (tile % p.nt) * BN;
    for (int kt = 0; kt < p.nk1 + p.nk2; ++kt, ++n) {
      const int s = n % T::STAGES;
      const bool second = kt >= p.nk1;
      const bool mn = KIND == kDz || (KIND == kDual && second);
      const int k0 = 64 * (second ? kt - p.nk1 : kt);
      const uint32_t full = bars + 8 * s, a = base + s * T::STAGE, b = a + T::A_BYTES;
      mbar_wait(bars + 8 * (T::STAGES + s), ((n / T::STAGES) & 1) ^ 1);
      mbar_arrive_tx(full, T::A_BYTES + (mn ? T::B_MN : T::B_K));
      tma_load_2d(a, second ? &p.a2 : &p.a, full, k0, m0);
      if (mn) {
        const CUtensorMap* map = second ? &p.b2 : &p.b;
        for (int j = 0; j < T::NA; ++j) tma_load_2d(b + j * kAtom, map, full, n0 + 64 * j, k0);
      } else {
        tma_load_2d(b, &p.b, full, k0, n0);
      }
    }
  }
}

// The nk stages of one product into acc (64 rows at `rows` of each A tile),
// B K-major (TB 0) or MN-major (TB 1). One k-step's group stays in flight
// while the next is issued; the stage before goes back once its group has
// completed (`pending`: a stage of this tile awaits that). n counts the
// block's stages.
template <int BN, int KIND, int TB>
__device__ __forceinline__ void product(float* acc, int nk, int& n, uint32_t base,
                                        uint32_t rows, bool& pending) {
  using T = Tile<BN, KIND>;
  const uint32_t bars = base + T::BAR_OFF;
  for (int kt = 0; kt < nk; ++kt, ++n) {
    const int s = n % T::STAGES;
    const uint32_t a = base + s * T::STAGE + rows, b = base + s * T::STAGE + T::A_BYTES;
    mbar_wait(bars + 8 * s, (n / T::STAGES) & 1);
    fence_regs<BN / 2>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // the first k-step overwrites acc
      wgmma_ss<BN, TB>(acc, desc_k(a + 32 * kk),
                       TB ? desc_mn(b + 2048 * kk, kAtom) : desc_k(b + 32 * kk),
                       kt > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();
    fence_regs<BN / 2>(acc);
    if (pending) mbar_arrive(bars + 8 * (T::STAGES + (n + T::STAGES - 1) % T::STAGES));
    pending = true;
  }
}

// Shared-memory words; the callers order them against the TMA proxy with
// fence_proxy_async and the named barriers.
__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// The byte of element pair (row, 8 j + 2 t4) of 64-column atoms of 64
// 128-byte-swizzled rows: what a TMA store of 64 x 64 boxes reads.
__device__ __forceinline__ uint32_t staged(uint32_t buf, int row, int j, int t4) {
  return buf + (j / 8) * kAtom + row * 128 + (((j % 8) ^ (row & 7)) << 4) + 4 * t4;
}

// This warpgroup's 64 rows of a tile's epilogue, epi(acc) (kDual: with the
// pre-activation `pre`), columns n0 .. n0 + BN of rows m0 .. m0 + 63: the
// whole 64-column atoms into the staging buffer `buf` (a TMA store takes
// them out), the columns past them straight to memory. One atom at a time,
// its bias and residual pairs are loaded before any arithmetic, so that
// their latencies overlap (loads behind each store ran one at a time).
// GUARD skips what lies past M or N; a tile wholly inside runs without a
// branch.
template <int BN, int KIND, bool GUARD, bool RES>
__device__ __forceinline__ void epi_rows(const GemmArgs& p, const float* acc, const float* pre,
                                         long long m0, int n0, uint32_t buf, int warp,
                                         int lane) {
  const int t4 = lane % 4, row0 = frag_row(warp, lane, 0);
  const bool rows_in[2] = {!GUARD || m0 + row0 < p.M, !GUARD || m0 + row0 + 8 < p.M};
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += 8) {
    float2 b[8];
    uint32_t r[8][2];
#pragma unroll
    for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
      const int c = n0 + 8 * (j0 + jj) + 2 * t4;
      const bool in = !GUARD || c < p.N;
      if (KIND != kDz) b[jj] = in ? unpack_bf16(ldg_pair(p.bias + c)) : make_float2(0.f, 0.f);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (RES) r[jj][hh] = in && rows_in[hh] ? ldg_pair(p.res + (m0 + row0 + 8 * hh) * p.N + c) : 0u;
    }
#pragma unroll
    for (int jj = 0; jj < 8 && j0 + jj < BN / 8; ++jj) {
      const int j = j0 + jj, c = n0 + 8 * j + 2 * t4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (GUARD && (!rows_in[hh] || c >= p.N)) continue;   // N % 8 == 0: pairs all in or out
        const int i = 4 * j + 2 * hh, row = row0 + 8 * hh;
        float v0 = acc[i], v1 = acc[i + 1];
        if constexpr (KIND == kGelu || KIND == kOut) {
          v0 += b[jj].x;
          v1 += b[jj].y;
          if (KIND == kGelu) {
            v0 = gelu_fast(v0);
            v1 = gelu_fast(v1);
          }
        } else if constexpr (KIND == kDual) {
          v0 *= dgelu_fast(pre[i] + b[jj].x);
          v1 *= dgelu_fast(pre[i + 1] + b[jj].y);
        }
        if constexpr (RES) {
          const float2 x = unpack_bf16(r[jj][hh]);
          v0 = round_to<bf16>(v0) + x.x;
          v1 = round_to<bf16>(v1) + x.y;
        }
        if (j < 8 * Tile<BN, KIND>::OUT_ATOMS) sts32(staged(buf, row, j, t4), pack_bf16(v0, v1));
        else store2(p.out + (m0 + row) * p.N + c, v0, v1);
      }
    }
  }
}

// `epi_rows` with the call's residual (kOut's, kDz's) as a
// template argument; kGelu and kDual have none (a residual variant compiled
// beside theirs made ptxas spill the 192-wide and dual tiles).
template <int BN, int KIND, bool GUARD>
__device__ __forceinline__ void epi_tile(const GemmArgs& p, const float* acc, const float* pre,
                                         long long m0, int n0, uint32_t buf, int warp, int lane) {
  if (KIND != kGelu && KIND != kDual && p.res)
    epi_rows<BN, KIND, GUARD, KIND != kGelu && KIND != kDual>(p, acc, pre, m0, n0, buf, warp,
                                                              lane);
  else
    epi_rows<BN, KIND, GUARD, false>(p, acc, pre, m0, n0, buf, warp, lane);
}

template <int BN, int KIND>
__global__ void __launch_bounds__(384, 1) mlp_gemm_sm90_kernel(const __grid_constant__ GemmArgs p) {
  using T = Tile<BN, KIND>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t bars = base + T::BAR_OFF;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);                   // full: the producer's arrival
      mbar_init(bars + 8 * (T::STAGES + s), 256);   // empty: every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = warpgroup();
  if (wg == 2) {
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == 256) produce<BN, KIND>(p, base);
    return;
  }

  regs_alloc<kConsumerRegs>();
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const bool elected = threadIdx.x % 128 == 0;
  const uint32_t rows = wg * 64 * 128, buf = base + T::OUT_OFF + wg * T::OUT_WG;
  int n = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    // no other instruction writes an accumulator: one written while a
    // product is in flight makes ptxas serialize the wgmma (C7515)
    float acc[BN / 2];
    float pre[KIND == kDual ? BN / 2 : 1];   // kDual: xn W1^T, beside acc = gy W2
    bool pending = false;
    if constexpr (KIND == kDual) {
      product<BN, KIND, 0>(pre, p.nk1, n, base, rows, pending);
      product<BN, KIND, 1>(acc, p.nk2, n, base, rows, pending);
    } else {
      product<BN, KIND, KIND == kDz>(acc, p.nk1, n, base, rows, pending);
    }
    wg_wait<0>();
    fence_regs<BN / 2>(acc);
    if constexpr (KIND == kDual) fence_regs<BN / 2>(pre);
    mbar_arrive(bars + 8 * (T::STAGES + (n + T::STAGES - 1) % T::STAGES));

    // the epilogue: this warpgroup's staging is free once the store of its
    // last tile has read it; the tile's atoms go out by TMA while the next
    // tile's products run
    const long long m0 = (long long)(tile / p.nt) * kBM + wg * 64;
    const int n0 = (tile % p.nt) * BN;
    if (elected) bulk_wait_read<0>();
    named_sync(2 + wg, 128);
    if (m0 + 64 <= p.M && n0 + BN <= p.N) epi_tile<BN, KIND, false>(p, acc, pre, m0, n0, buf, warp, lane);
    else epi_tile<BN, KIND, true>(p, acc, pre, m0, n0, buf, warp, lane);
    fence_proxy_async();
    named_sync(2 + wg, 128);
    if (elected && m0 < p.M) {
      for (int a = 0; a < T::OUT_ATOMS; ++a)
        if (n0 + 64 * a < p.N) tma_store_2d(&p.o, buf + a * kAtom, n0 + 64 * a, (int)m0);
      bulk_commit();
    }
  }
  if (elected) bulk_wait<0>();
}

// The widest column tile of `cands` (widest first) that leaves the fewest of
// N's columns idle, narrowed where that puts more SMs to work.
inline int pick_bn(long long M, int N, std::initializer_list<int> cands) {
  const long long mt = (M + kBM - 1) / kBM;
  int best = 0;
  long long best_waste = 0, best_fill = 0;
  for (int bn : cands) {
    const long long nt = (N + bn - 1) / bn, waste = nt * bn - N;
    const long long fill = mt * nt < sm_count() ? mt * nt : sm_count();
    if (!best || waste < best_waste || (waste == best_waste && fill > best_fill)) {
      best = bn;
      best_waste = waste;
      best_fill = fill;
    }
  }
  return best;
}

template <int BN, int KIND>
cudaError_t launch_gemm(GemmArgs& p, cudaStream_t stream) {
  using T = Tile<BN, KIND>;
  const long long mt = (p.M + kBM - 1) / kBM;
  p.nt = (p.N + BN - 1) / BN;
  if (mt * p.nt > INT_MAX) return cudaErrorInvalidValue;
  p.tiles = (int)(mt * p.nt);
  const int grid = p.tiles < sm_count() ? p.tiles : sm_count();
  auto kernel = mlp_gemm_sm90_kernel<BN, KIND>;
  static bool raised[64] = {};
  cudaError_t e = smem_limit_once(reinterpret_cast<const void*>(kernel), T::SMEM, raised);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 384, T::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// out (M x N) = epi(A (M x K) W^T), W (N x K) K-major (kGelu, kOut), or
// epi(A W) with W (K x N) MN-major (kDz); A's rows `lda` elements apart (0:
// K; K9's two products read column blocks of one gradient buffer). The
// residual's epilogue leaves K1's second product (kOut) no room for a
// 192-wide accumulator (it spilled).
template <int KIND>
cudaError_t gemm(const void* A, const void* W, const void* bias, const void* res, void* out,
                 long long M, int N, int K, cudaStream_t stream, long long lda = 0) {
  const int bn = KIND == kOut ? pick_bn(M, N, {144, 96}) : pick_bn(M, N, {192, 144, 96});
  GemmArgs p = {};
  const bool ok = tensor_map_2d(&p.a, A, K, M, lda ? lda : K, 64, kBM)
                  && (KIND == kDz ? tensor_map_2d(&p.b, W, N, K, N, 64, 64)
                                  : tensor_map_2d(&p.b, W, K, N, K, 64, bn))
                  && tensor_map_2d(&p.o, out, N, M, N, 64, 64);
  if (!ok) return cudaErrorInvalidValue;
  p.bias = static_cast<const bf16*>(bias);
  p.res = static_cast<const bf16*>(res);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.N = N;
  p.nk1 = (K + 63) / 64;
  if constexpr (KIND == kOut) {
    return bn == 144 ? launch_gemm<144, KIND>(p, stream) : launch_gemm<96, KIND>(p, stream);
  } else {
    switch (bn) {
      case 192: return launch_gemm<192, KIND>(p, stream);
      case 144: return launch_gemm<144, KIND>(p, stream);
      default: return launch_gemm<96, KIND>(p, stream);
    }
  }
}

}  // namespace
}  // namespace sm90
