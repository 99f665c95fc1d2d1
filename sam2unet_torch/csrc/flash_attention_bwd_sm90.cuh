// K11's dq and dk/dv passes in bf16 on Hopper's asynchronous path (the
// design notes are csrc/flash_attention_bwd_sm90.cu's): the block shape of
// each padded head dim, the arguments and both kernels. Header-only, so that
// csrc/block_bwd_sm90.cu instantiates the dk/dv pass over K7's window views
// beside its own query-side pass, which takes the same block shape.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace k11 {
namespace {   // internal linkage in each library (csrc/gemm_sm90.cuh says why)

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRow = 128;          // bytes of one swizzled tile row: 64 bf16
constexpr int kSmemLimit = 232448;
// Registers a thread holds after setmaxnreg (384 threads start at 168):
// the dq pass's consumers 232 and producer 40; the dk/dv pass's consumers
// keep dK, dV, S^T, dP^T and their bf16 fragments at once, so 240 and 24.
constexpr int kDqConsumerRegs = 232, kDqProducerRegs = 40;
constexpr int kDkvConsumerRegs = 240, kDkvProducerRegs = 24;

// Both passes at head dim D (d padded up to it): ROWS resident rows of two
// tensors (Q and dO, or K and V), a two-stage ring of 64-row tiles of the
// other two, and (dk/dv) each stage's 64 lse and D values.
template <int D> struct Shape {
  static constexpr int A = (D + 63) / 64;         // 64-column atoms of a tile
  static constexpr bool SPLIT = D > 128;          // warpgroups split the columns
  static constexpr int ROWS = SPLIT ? 64 : 128;
  static constexpr int NO = SPLIT ? D / 2 : D;    // output columns a warpgroup holds
  static constexpr int RES_REGION = ROWS * kRow, T_REGION = 64 * kRow;
  static constexpr int RING_OFF = 2 * A * RES_REGION;            // [stage][tensor][atom]
  static constexpr int ROW_OFF = RING_OFF + 4 * A * T_REGION;    // [stage][lse, D][64]
  static constexpr int BAR_OFF = ROW_OFF + 2 * 2 * 64 * 4;       // res, full[2], empty[2]
  static constexpr int SMEM = BAR_OFF + 40 + 1024;               // + alignment slack
  static_assert(SMEM <= kSmemLimit, "shared memory");
  static_assert(NO == 64 || NO == 96 || NO == 128, "wgmma width");
};

struct Params {
  CUtensorMap q, k, v, dout;
  const float* lse;   // (B * heads, Sq), natural log
  const float* D;     // (B * heads, Sq)
  bf16 *dq, *dk, *dv;
  long long o_sb, o_ss, o_sh;   // element strides of dq, or of dk and dv
  int Sq, Sk, nh, d;
  float scale, scale_log2;
};

template <int D>
__global__ void __launch_bounds__(384, 1) k11_dq_sm90_kernel(const __grid_constant__ Params p) {
  using S = Shape<D>;
  constexpr int A = S::A, NO = S::NO;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t ring = base + S::RING_OFF;
  const uint32_t bar_res = base + S::BAR_OFF, bar_full = bar_res + 8, bar_empty = bar_res + 24;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * S::ROWS;
  const int nkt = (p.Sk + 63) / 64;
  const int wg = warpgroup();
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer
    regs_dealloc<kDqProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_arrive_tx(bar_res, 2 * A * S::RES_REGION);
      for (int a = 0; a < A; ++a) {
        tma_load_4d(base + a * S::RES_REGION, &p.q, bar_res, 64 * a, h, q0, b);
        tma_load_4d(base + (A + a) * S::RES_REGION, &p.dout, bar_res, 64 * a, h, q0, b);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt & 1;
        mbar_wait(bar_empty + 8 * s, ((kt >> 1) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s, st = ring + s * 2 * A * S::T_REGION;
        mbar_arrive_tx(full, 2 * A * S::T_REGION);
        for (int a = 0; a < A; ++a) {
          tma_load_4d(st + a * S::T_REGION, &p.k, full, 64 * a, h, kt * 64, b);
          tma_load_4d(st + (A + a) * S::T_REGION, &p.v, full, 64 * a, h, kt * 64, b);
        }
      }
    }
    return;
  }

  // consumer: 64 query rows (rw) and output columns c0 .. c0 + NO
  regs_alloc<kDqConsumerRegs>();
  const int rw = S::SPLIT ? 0 : wg, c0 = S::SPLIT ? wg * NO : 0;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t4 = lane % 4;
  const long long bh = (long long)b * p.nh + h;
  float lse2[2], dd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + rw * 64 + frag_row(warp, lane, hh);
    lse2[hh] = r < p.Sq ? p.lse[bh * p.Sq + r] * kLog2e : 0.f;
    dd[hh] = r < p.Sq ? p.D[bh * p.Sq + r] : 0.f;
  }
  float dq[NO / 2];
  zero<NO / 2>(dq);
  const uint32_t q_rows = base + rw * 64 * kRow, do_rows = q_rows + A * S::RES_REGION;
  const uint32_t cols = (c0 / 64) * S::T_REGION;   // this warpgroup's columns of K
  mbar_wait(bar_res, 0);
  for (int kt = 0; kt < nkt; ++kt) {
    const int s = kt & 1;
    mbar_wait(bar_full + 8 * s, (kt >> 1) & 1);
    const uint32_t kt_s = ring + s * 2 * A * S::T_REGION, vt_s = kt_s + A * S::T_REGION;
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
      const bool valid = key0 + 8 * (i / 4) + 2 * t4 + (i & 1) < p.Sk;
      const float pr = valid ? exp2f(fmaf(sc[i], p.scale_log2, -lse2[hh])) : 0.f;
      sc[i] = pr * (dp[i] - dd[hh]);   // dS
    }
    uint32_t da[4][4];
    to_a_frags<4>(sc, da);
    fence_regs<16>(&da[0][0]);
    fence_regs<NO / 2>(dq);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<NO>(dq, da[kk], kt_s + cols + kk * 16 * kRow, S::T_REGION);
    wg_commit();
    wg_wait<0>();
    fence_regs<NO / 2>(dq);
    fence_regs<16>(&da[0][0]);
    mbar_arrive(bar_empty + 8 * s);
  }

  bf16* out = p.dq + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = q0 + rw * 64 + frag_row(warp, lane, hh);
    if (r < p.Sq) store_rows<NO>(out, p.o_ss, dq, hh, r, c0, p.d, t4, p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1) k11_dkv_sm90_kernel(const __grid_constant__ Params p) {
  using S = Shape<D>;
  constexpr int A = S::A, NO = S::NO;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_base(smem_raw);
  const uint32_t ring = base + S::RING_OFF;
  // the stages' lse log2(e) and D rows, through a generic pointer
  float* rows = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + S::ROW_OFF);
  const uint32_t bar_res = base + S::BAR_OFF, bar_full = bar_res + 8, bar_empty = bar_res + 24;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * S::ROWS;
  const int nqt = (p.Sq + 63) / 64;
  const int wg = warpgroup();
  const long long bh = (long long)b * p.nh + h;
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(bar_full + 8 * s, 33);   // the TMA thread's and 32 row writers'
      mbar_init(bar_empty + 8 * s, 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {   // producer: its first warp
    regs_dealloc<kDkvProducerRegs>();
    const int lane = threadIdx.x % 32;
    const float *lse_row = p.lse + bh * p.Sq, *d_row = p.D + bh * p.Sq;
    if (threadIdx.x - 256 < 32) {
      if (lane == 0) {
        mbar_arrive_tx(bar_res, 2 * A * S::RES_REGION);
        for (int a = 0; a < A; ++a) {
          tma_load_4d(base + a * S::RES_REGION, &p.k, bar_res, 64 * a, h, k0, b);
          tma_load_4d(base + (A + a) * S::RES_REGION, &p.v, bar_res, 64 * a, h, k0, b);
        }
      }
      for (int qt = 0; qt < nqt; ++qt) {
        const int s = qt & 1;
        mbar_wait(bar_empty + 8 * s, ((qt >> 1) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {
          const uint32_t st = ring + s * 2 * A * S::T_REGION;
          mbar_arrive_tx(full, 2 * A * S::T_REGION);
          for (int a = 0; a < A; ++a) {
            tma_load_4d(st + a * S::T_REGION, &p.q, full, 64 * a, h, qt * 64, b);
            tma_load_4d(st + (A + a) * S::T_REGION, &p.dout, full, 64 * a, h, qt * 64, b);
          }
        }
        for (int j = lane; j < 64; j += 32) {
          const int q = qt * 64 + j;
          // a query past S_q gets P = exp2(-inf) = 0
          rows[s * 128 + j] = q < p.Sq ? lse_row[q] * kLog2e : INFINITY;
          rows[s * 128 + 64 + j] = q < p.Sq ? d_row[q] : 0.f;
        }
        mbar_arrive(full);
      }
    }
    return;
  }

  // consumer: 64 key rows (rw) and output columns c0 .. c0 + NO
  regs_alloc<kDkvConsumerRegs>();
  const int rw = S::SPLIT ? 0 : wg, c0 = S::SPLIT ? wg * NO : 0;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4, t4 = lane % 4;
  float dk[NO / 2], dv[NO / 2];
  zero<NO / 2>(dk);
  zero<NO / 2>(dv);
  const uint32_t k_rows = base + rw * 64 * kRow, v_rows = k_rows + A * S::RES_REGION;
  const uint32_t cols = (c0 / 64) * S::T_REGION;   // this warpgroup's columns of Q, dO
  mbar_wait(bar_res, 0);
  for (int qt = 0; qt < nqt; ++qt) {
    const int s = qt & 1;
    mbar_wait(bar_full + 8 * s, (qt >> 1) & 1);
    const uint32_t qt_s = ring + s * 2 * A * S::T_REGION, dot_s = qt_s + A * S::T_REGION;
    float st[32], dpt[32];   // S^T and dP^T: rows keys, columns queries
    wg_fence();
    scores<D>(st, k_rows, S::RES_REGION, qt_s, S::T_REGION);
    scores<D>(dpt, v_rows, S::RES_REGION, dot_s, S::T_REGION);
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(st);
    fence_regs<32>(dpt);
    const float* lse2 = rows + s * 128;
    const float* dd = lse2 + 64;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      st[i] = exp2f(fmaf(st[i], p.scale_log2, -lse2[8 * (i / 4) + 2 * t4 + (i & 1)]));
    // dV += P^T dO on the tensor cores while dS^T forms
    uint32_t pa[4][4], da[4][4];
    to_a_frags<4>(st, pa);
    fence_regs<16>(&pa[0][0]);
    fence_regs<NO / 2>(dv);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<NO>(dv, pa[kk], dot_s + cols + kk * 16 * kRow, S::T_REGION);
    wg_commit();
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dpt[i] = st[i] * (dpt[i] - dd[8 * (i / 4) + 2 * t4 + (i & 1)]);   // dS^T
    to_a_frags<4>(dpt, da);
    fence_regs<16>(&da[0][0]);
    fence_regs<NO / 2>(dk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_rs<NO>(dk, da[kk], qt_s + cols + kk * 16 * kRow, S::T_REGION);
    wg_commit();
    wg_wait<0>();
    fence_regs<NO / 2>(dv);
    fence_regs<NO / 2>(dk);
    fence_regs<16>(&pa[0][0]);
    fence_regs<16>(&da[0][0]);
    mbar_arrive(bar_empty + 8 * s);
  }

  const long long off = b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = k0 + rw * 64 + frag_row(warp, lane, hh);
    if (r >= p.Sk) continue;
    store_rows<NO>(p.dk + off, p.o_ss, dk, hh, r, c0, p.d, t4, p.scale);
    store_rows<NO>(p.dv + off, p.o_ss, dv, hh, r, c0, p.d, t4, 1.f);
  }
}

}  // namespace
}  // namespace k11
