// Split-contraction partials of the upper tiles of G = X Xᵀ, for X (N, P)
// row-major; the first pass of both gram and pairdist.
//
// Block (bj, bi, s) computes the 64 x 64 tile (bi, bj) with bj >= bi over
// the s-th range of `chunk` contraction columns and writes it to
// ws[s] (N x N); lower tiles are never computed. A second pass of the
// caller's own sums the partials in a fixed order (so results do not depend
// on scheduling) and reads a lower entry from its mirrored upper one
// (upper_src), which makes the result exactly symmetric.
#pragma once

#include "tile.cuh"

namespace repro {

template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kThreads)
upper_gram_partial_kernel(const TIn* __restrict__ x, TAcc* __restrict__ ws, int n, int p,
                          int chunk) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj < bi) return;  // lower tiles are mirrored by the second pass
  const int s = blockIdx.z;
  const int k_begin = s * chunk;
  const int k_end = min(p, k_begin + chunk);
  TAcc acc[4][4];
  tile_product<TIn, TAcc, true>(x, p, x, p, n, n, bi * kTile, bj * kTile, k_begin, k_end, acc);
  TAcc* out = ws + static_cast<size_t>(s) * n * n;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = bi * kTile + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = bj * kTile + tx + 16 * j;
      if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = acc[i][j];
    }
  }
}

// Offset in one N x N partial of the computed entry that holds G_ij.
__device__ __forceinline__ size_t upper_src(int i, int j, int n) {
  return (i / kTile <= j / kTile) ? static_cast<size_t>(i) * n + j
                                  : static_cast<size_t>(j) * n + i;
}

// G at offset `src`: the partials summed over the splits in a fixed order.
template <typename TAcc>
__device__ __forceinline__ TAcc split_sum(const TAcc* __restrict__ ws, size_t src, size_t total,
                                          int splits) {
  TAcc sum = ws[src];
  for (int s = 1; s < splits; ++s) sum += ws[static_cast<size_t>(s) * total + src];
  return sum;
}

// Launch the first pass on `stream`; returns cudaGetLastError().
template <typename TIn, typename TAcc>
cudaError_t launch_upper_gram_partials(const void* x, void* ws, int n, int p, int splits,
                                       cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  const int chunk = ((p + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  dim3 grid(tiles, tiles, splits);
  upper_gram_partial_kernel<TIn, TAcc><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<TAcc*>(ws), n, p, chunk);
  return cudaGetLastError();
}

// Grid of a grid-stride pass over `total` entries (at most 4096 blocks).
inline int stride_blocks(size_t total) {
  const size_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < 4096 ? want : 4096);
}

}  // namespace repro
