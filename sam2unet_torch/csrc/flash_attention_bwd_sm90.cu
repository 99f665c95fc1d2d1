// K11's dq and dk/dv passes in bf16 on Hopper's asynchronous path: warpgroup
// products (wgmma) fed by TMA through shared-memory rings.
//
// Replaces sam2unet_tpu/ops/pallas/flash_attention.py::_stream_bwd_dq_kernel
// (:219, launched by _stream_bwd_impl at :314) and ::_stream_bwd_dkv_kernel
// (:254, launched at :336) where the call is bf16, d % 8 == 0 up to 256, and
// every view allows a tensor map (16-byte bases, strides in multiples of 8
// elements: `_bwd_library` in ops/flash_attention.py). The delta pass and
// every other call stay in csrc/flash_attention_bwd.cu (fp32) and
// csrc/attention_any_bwd.cu (other head dims and views).
//
// Bound on an H100: the dq pass forms S, dP and dQ, 6 S_q S_k d operations
// per (batch, head), the dk/dv pass S^T, dP^T, dV and dK, 8 S_q S_k d,
// against ~5 S d and ~6 S d elements moved: at S 3600 or 4096 the tensor
// cores bound both. So the products run on wgmma, whose operands come
// from shared memory (both for the scores) or from registers (the rounded
// P^T and dS, straight from the accumulator of the product before), and
// TMA keeps the streamed tiles arriving while the products run.
//
// Design (the building blocks and fragment layouts in hopper.cuh). Each
// block has three warpgroups: two consumers of 64 rows each and a producer,
// whose first thread issues the TMA loads (resident rows once, then the
// streamed 64-row tiles through a two-stage ring, each stage with a full
// and an empty mbarrier) and whose registers setmaxnreg hands to the
// consumers. Instances at d padded to 64, 96, 128 and 256; a head dim
// between them reads its last 64-column atom zero-filled past d, which adds
// nothing to any product, and the epilogue writes only the d columns (the
// dqkv views are neighbouring channel blocks of one buffer).
//   dq: one block per (batch, head, 128 queries): Q and dO resident, K and
//     V streamed; S = Q K^T and dP = dO V^T with both operands K-major in
//     shared memory, P = exp2(S scale log2(e) - lse log2(e)) (keys past S_k
//     get P = 0), dS = P (dP - D) rounded to bf16 in registers as the A of
//     dQ += dS K (K MN-major); dQ scaled once at the end.
//   dk/dv: one block per (batch, head, 128 keys): K and V resident, Q, dO
//     and the rows' lse log2(e) and D streamed (the producer's first warp
//     writes those two rows into the stage beside the TMA loads; a query
//     past S_q gets lse +inf, so P = 0); S^T = K Q^T, P^T rounded to bf16
//     drives dV += P^T dO on the tensor cores while dP^T = V dO^T's result
//     forms dS^T = P^T (dP^T - D), which drives dK += dS^T Q.
//   At d 256 one warpgroup cannot hold two 64 x 256 fp32 accumulators, and
//   128 rows of two resident tensors would not fit shared memory beside the
//   ring: a block takes 64 rows, both warpgroups form the same scores (the
//   products over d are a third of the pass's work, done twice) and each
//   keeps half the output columns, so no partial sum crosses warpgroups and
//   each pass stays one launch.
// P and dS are rounded to bf16 as the operands of the next product, as the
// Pallas kernels round them; every product accumulates in fp32. No atomics:
// each output row belongs to one block, and a repeated call gives the same
// bits. Each entry point returns the CUDA error of its launch.

#include "common.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

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

// ------------------------------------------------------------ launchers

template <int D> int smem_bytes() { return Shape<D>::SMEM; }

int smem_of(int d) {
  switch (padded_head_dim(d)) {
    case 64: return smem_bytes<64>();
    case 96: return smem_bytes<96>();
    case 128: return smem_bytes<128>();
    default: return smem_bytes<256>();
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, 384, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_pass(bool dkv, Params& p, const void* q, const void* k, const void* v,
                        const void* dout, int B, const long long* qs, const long long* kvs,
                        const long long* dos, cudaStream_t stream) {
  using S = Shape<D>;
  long long sq[3] = {qs[0], qs[1], qs[2]}, skv[3] = {kvs[0], kvs[1], kvs[2]},
            sdo[3] = {dos[0], dos[1], dos[2]};
  map_strides(sq, B, p.nh, p.d, p.Sq);
  map_strides(sdo, B, p.nh, p.d, p.Sq);
  map_strides(skv, B, p.nh, p.d, p.Sk);
  const int q_rows = dkv ? 64 : S::ROWS, kv_rows = dkv ? S::ROWS : 64;
  if (!tensor_map_bshd(&p.q, q, B, p.Sq, p.nh, p.d, sq[0], sq[1], sq[2], q_rows)
      || !tensor_map_bshd(&p.dout, dout, B, p.Sq, p.nh, p.d, sdo[0], sdo[1], sdo[2], q_rows)
      || !tensor_map_bshd(&p.k, k, B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], kv_rows)
      || !tensor_map_bshd(&p.v, v, B, p.Sk, p.nh, p.d, skv[0], skv[1], skv[2], kv_rows))
    return cudaErrorInvalidValue;
  const dim3 grid(((dkv ? p.Sk : p.Sq) + S::ROWS - 1) / S::ROWS, p.nh, B);
  return dkv ? launch(k11_dkv_sm90_kernel<D>, grid, S::SMEM, stream, p)
             : launch(k11_dq_sm90_kernel<D>, grid, S::SMEM, stream, p);
}

int run_pass(bool dkv, int is_bf16, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* D, void* o0, void* o1, int B,
             int Sq, int Sk, int nh, int d, const long long* qs, const long long* kvs,
             const long long* dos, const long long* outs, float scale, void* stream) {
  if (!is_bf16 || d < 8 || d > 256 || B < 1 || B > 65535 || nh < 1 || nh > 65535 || Sq < 1
      || Sk < 1
      || !views_vec16(d, {qs[0], qs[1], qs[2], kvs[0], kvs[1], kvs[2], dos[0], dos[1], dos[2],
                          outs[0], outs[1], outs[2]},
                      {q, k, v, dout, o0, dkv ? o1 : o0}))
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.lse = lse;
  p.D = D;
  p.dq = static_cast<bf16*>(o0);
  p.dk = static_cast<bf16*>(o0);
  p.dv = static_cast<bf16*>(o1);
  p.o_sb = outs[0]; p.o_ss = outs[1]; p.o_sh = outs[2];
  p.Sq = Sq; p.Sk = Sk; p.nh = nh; p.d = d;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (padded_head_dim(d)) {
    case 64: return (int)launch_pass<64>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    case 96: return (int)launch_pass<96>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    case 128: return (int)launch_pass<128>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
    default: return (int)launch_pass<256>(dkv, p, q, k, v, dout, B, qs, kvs, dos, s);
  }
}

}  // namespace

// dq (B, Sq, heads, d), written through its strides; the arguments of
// k11_flash_attention_bwd_dq (csrc/flash_attention_bwd.cu), bf16 only.
extern "C" int k11_flash_attention_bwd_dq_sm90(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dq, int B, int Sq, int Sk, int nh, int d,
    long long q_sb, long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long do_sb, long long do_ss, long long do_sh, long long dq_sb,
    long long dq_ss, long long dq_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh},
                  dos[3] = {do_sb, do_ss, do_sh}, outs[3] = {dq_sb, dq_ss, dq_sh};
  return run_pass(false, is_bf16, q, k, v, dout, lse, D, dq, nullptr, B, Sq, Sk, nh, d, qs,
                  kvs, dos, outs, scale, stream);
}

// dk and dv (B, Sk, heads, d), both written through the same strides.
extern "C" int k11_flash_attention_bwd_dkv_sm90(
    int is_bf16, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* D, void* dk, void* dv, int B, int Sq, int Sk, int nh,
    int d, long long q_sb, long long q_ss, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long do_sb, long long do_ss, long long do_sh, long long dkv_sb,
    long long dkv_ss, long long dkv_sh, float scale, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh}, kvs[3] = {kv_sb, kv_ss, kv_sh},
                  dos[3] = {do_sb, do_ss, do_sh}, outs[3] = {dkv_sb, dkv_ss, dkv_sh};
  return run_pass(true, is_bf16, q, k, v, dout, lse, D, dk, dv, B, Sq, Sk, nh, d, qs, kvs,
                  dos, outs, scale, stream);
}

// The dynamic shared memory, in bytes, of the instance head dim d runs on
// (both passes size the block alike).
extern "C" int k11_flash_attention_bwd_sm90_smem(int d) { return smem_of(d); }
