// One 64 x 64 output tile of C = A · B, staged through shared memory in
// chunks of 16 along the contraction; the shared body of gram and hat_apply.
//
// A is (M, K) row-major with row stride lda. B is either the rows of a
// second (Nc, K) row-major matrix (kBRows = true, C = A·Bᵀ, the Gram
// product) or a (K, Nc) row-major matrix (kBRows = false, C = A·B, the hat
// application). 256 threads each own a 4 x 4 block of the tile at stride 16,
// so neighbouring threads read neighbouring shared-memory words. Rows,
// columns and the contraction range are masked here: callers never pad.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kTile = 64;
constexpr int kTileK = 16;

template <typename TIn, typename TAcc, bool kBRows>
__device__ __forceinline__ void tile_product(const TIn* __restrict__ a, long long lda,
                                             const TIn* __restrict__ b, long long ldb,
                                             int rows, int cols, int m0, int n0,
                                             int k_begin, int k_end, TAcc acc[4][4]) {
  __shared__ TAcc as[kTileK][kTile + 1];
  __shared__ TAcc bs[kTileK][kTile + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = TAcc(0);

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    // 64 x 16 tile of A: 16 consecutive threads read 16 consecutive values.
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * kThreads;
      const int r = e / kTileK, kk = e % kTileK;
      const int gr = m0 + r, gk = k0 + kk;
      as[kk][r] = (gr < rows && gk < k_end) ? to_acc(a[gr * lda + gk]) : TAcc(0);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int e = tid + l * kThreads;
      if (kBRows) {
        const int r = e / kTileK, kk = e % kTileK;
        const int gc = n0 + r, gk = k0 + kk;
        bs[kk][r] = (gc < cols && gk < k_end) ? to_acc(b[gc * ldb + gk]) : TAcc(0);
      } else {
        const int kk = e / kTile, c = e % kTile;
        const int gc = n0 + c, gk = k0 + kk;
        bs[kk][c] = (gc < cols && gk < k_end) ? to_acc(b[gk * ldb + gc]) : TAcc(0);
      }
    }
    __syncthreads();
    // Two-level sum: each chunk's 16 products are summed on their own and
    // then added to the running total, so a sum over P terms rounds along a
    // chain of P/16 + 16 additions instead of P.
    TAcc part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = TAcc(0);
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      TAcc av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] += av[i] * bv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
}

}  // namespace repro
