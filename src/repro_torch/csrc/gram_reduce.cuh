// The upper-triangle Gram passes shared by gram and pairdist's many-pattern
// route: the tensor-core first pass by input type (upper_gram_tc.cuh for f32
// and bf16, upper_gram_dmma.cuh for f64), then one reduce pass templated on
// its epilogue: G itself for gram, the clamped squared distance for
// pairdist.
//
// The reduce reads every G_ij from the element upper triangle
// (upper_triangle_src): 3×TF32's big·small + small·big is not symmetric
// inside a diagonal tile, so mirroring whole upper tiles would leave G (and
// D) asymmetric there. Sums over the splits run in a fixed order, so the
// results are bitwise repeatable.
#pragma once

#include <type_traits>

#include "upper_gram_dmma.cuh"
#include "upper_gram_tc.cuh"

namespace repro {

// Offset in one N x N partial of the entry that holds G_ij: the upper
// triangle's own, the mirrored one below it. Every upper tile is computed,
// and the diagonal tiles' lower halves are not read, so G is exactly
// symmetric on every route.
__device__ __forceinline__ size_t upper_triangle_src(int i, int j, int n) {
  return i <= j ? static_cast<size_t>(i) * n + j : static_cast<size_t>(j) * n + i;
}

constexpr int kReduceTile = 32;   // the reduce pass: 32 x 32 entries of G, a thread each

// gram: the entry is G_ij itself.
struct GramOut {
  static constexpr bool kNorms = false;
};

// pairdist: D_ij = max((n_i + n_j) − 2·G_ij, 0), n_i = G_ii summed as G_ij
// is, so D_ii = 2n_i − 2n_i is exactly 0. A NaN passes the clamp.
struct DistanceOut {
  static constexpr bool kNorms = true;
  template <typename T>
  static __device__ __forceinline__ T apply(T g, T n_i, T n_j) {
    const T v = (n_i + n_j) - T(2) * g;
    return v < T(0) ? T(0) : v;
  }
};

// out_ij = G_ij, or Epi::apply(G_ij, G_ii, G_jj) where Epi::kNorms, with
// G_ij the partials at the
// upper-triangle entry of (i, j) summed over the splits in a fixed order.
// One block per pair of mirrored 32 x 32 tiles (ti <= tj): with kNorms, it
// first sums the diagonal entries of its row and column tiles into shared
// memory; its threads then read the upper tile's sources along rows of the
// workspace, write that tile, and write the mirrored tile below the diagonal
// through a shared-memory transpose, so each partial is read once (the
// diagonal twice). Launched as a programmatic dependent of the first pass:
// it waits here until that pass has finished and its stores are visible.
template <typename TAcc, typename Epi>
__global__ void __launch_bounds__(kReduceTile * kReduceTile)
gram_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ out, int n, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ TAcc t[kReduceTile][kReduceTile + 1];
  __shared__ TAcc norms[2][kReduceTile];   // G_ii of the row tile, then of the column tile
  const int tiles = (n + kReduceTile - 1) / kReduceTile;
  int ti = 0, u = blockIdx.x;   // upper tile pair u → (ti, tj), row by row
  while (u >= tiles - ti) {
    u -= tiles - ti;
    ++ti;
  }
  const int tj = ti + u;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t total = static_cast<size_t>(n) * n;
  if constexpr (Epi::kNorms) {
    if (ty < 2) {
      const int k = (ty == 0 ? ti : tj) * kReduceTile + tx;
      if (k < n) norms[ty][tx] = ordered_split_sum(ws, static_cast<size_t>(k) * n + k, total, splits);
    }
    __syncthreads();
  }
  const int i = ti * kReduceTile + ty, j = tj * kReduceTile + tx;
  if (i < n && j < n && i <= j) {
    const TAcc g = ordered_split_sum(ws, upper_triangle_src(i, j, n), total, splits);
    TAcc v = g;
    if constexpr (Epi::kNorms) v = Epi::apply(g, norms[0][ty], norms[1][tx]);
    out[static_cast<size_t>(i) * n + j] = v;
    t[ty][tx] = v;
  }
  __syncthreads();
  // entry (r, c) below the diagonal is entry (c, r), computed by thread (tx, ty)
  const int r = tj * kReduceTile + ty, c = ti * kReduceTile + tx;
  if (r < n && c < n && c < r) out[static_cast<size_t>(r) * n + c] = t[tx][ty];
}

// Both passes on `stream`: the upper tiles' split partials of X Xᵀ into ws
// (splits, n, n), then the reduce with epilogue Epi into out (n, n). splits:
// kernels/gram/gram.py (tc_gram_splits for f32 and bf16, dmma_gram_splits
// for f64). Returns the first CUDA error.
template <typename TIn, typename TAcc, typename Epi>
cudaError_t launch_gram_passes(const void* x, void* ws, void* out, int n, int p, int splits,
                               cudaStream_t stream) {
  cudaError_t err;
  if constexpr (std::is_same_v<TIn, double>)
    err = launch_upper_gram_dmma(x, ws, n, p, splits, stream);
  else
    err = launch_upper_gram_tc<TIn>(x, ws, n, p, splits, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kReduceTile - 1) / kReduceTile;
  return launch_dependent(gram_reduce_kernel<TAcc, Epi>, dim3(tiles * (tiles + 1) / 2),
                          dim3(kReduceTile, kReduceTile), stream, static_cast<const TAcc*>(ws),
                          static_cast<TAcc*>(out), n, splits);
}

}  // namespace repro
