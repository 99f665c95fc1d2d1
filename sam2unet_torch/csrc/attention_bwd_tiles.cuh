// The register-tile products of the attention backward passes and their
// shared-memory budget, shared by attention_bwd.cuh (K5, K7, K9: windows of
// a packed qkv buffer) and flash_attention_bwd.cu (K11: strided (B, S,
// heads, d) views). A warp holds 16 rows against a 64-row tile of the other
// operand; bf16 runs on mma.sync (fp32 accumulate), fp32 on CUDA-core dot
// products in the same register layout.
#pragma once

#include <type_traits>

#include "common.cuh"

constexpr int BWD_TILE = 64;   // rows of the streamed tile

// s (16 x 64, accumulator layout: s[j][e] is row g + 8(e/2), column
// 8j + q2 + e%2) = A (the warp's 16 rows) . B (64 rows), both rows of DP
// elements at stride LDS in shared memory.
template <typename T, int NDF>
__device__ __forceinline__ void tile_rows_dot(float s[8][4], const T* A,
                                              const T* B, int d, int lane) {
  constexpr int LDS = 16 * NDF + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
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
        float acc = 0.f;
        for (int ch = 0; ch < d; ++ch) acc = fmaf(to_f(ar[ch]), to_f(br[ch]), acc);
        s[j][e] = acc;
      }
  }
}

// acc (16 x DP) += p (16 x 64, accumulator layout; rounded to T as the
// product's operand) @ B (64 rows of DP at stride LDS). fp32 stages p
// through the warp's 16 x 64 scratch Pw.
template <typename T, int NDF>
__device__ __forceinline__ void tile_p_rows(float acc[2 * NDF][4],
                                            const float p[8][4], const T* B,
                                            float* Pw, int lane) {
  constexpr int LDS = 16 * NDF + 8;
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int kc = 0; kc < BWD_TILE / 16; ++kc) {
      const unsigned a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                             pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                             pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                             pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
      for (int fp = 0; fp < NDF; ++fp) {
        unsigned r[4];
        ldmatrix_x4_trans(r, B + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                                 + fp * 16 + (lane >> 4) * 8);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        mma_16816(acc[2 * fp], a, b0);
        mma_16816(acc[2 * fp + 1], a, b1);
      }
    }
  } else {
    const int g = lane >> 2, q2 = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Pw[(g + 8 * (e >> 1)) * BWD_TILE + j * 8 + q2 + (e & 1)] = p[j][e];
    __syncwarp();
#pragma unroll
    for (int f = 0; f < 2 * NDF; ++f)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* pr = Pw + (g + 8 * (e >> 1)) * BWD_TILE;
        const int col = f * 8 + q2 + (e & 1);
        float s = 0.f;
        for (int k = 0; k < BWD_TILE; ++k) s = fmaf(pr[k], to_f(B[k * LDS + col]), s);
        acc[f][e] += s;
      }
    __syncwarp();
  }
}

inline size_t attn_bwd_smem_bytes(int rows, int other_rows, int warps, int dp,
                                  size_t tsize) {
  size_t b = tsize * (dp + 8) * (size_t)(2 * rows + other_rows)
             + sizeof(float) * 2 * (size_t)(rows > BWD_TILE ? rows : BWD_TILE);
  if (tsize == sizeof(float)) b += sizeof(float) * warps * 16 * BWD_TILE;
  return b;
}
