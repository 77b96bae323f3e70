// Gram matrix G = X Xᵀ for X (N, P) row-major; the plan build's O(N²P) term.
//
// Replaces the TPU kernel gram_pallas (src/repro/kernels/gram/gram.py,
// body _gram_kernel), which walked the contraction as the innermost,
// sequential grid axis with the accumulator in VMEM.
//
// What bounds it here: operations. At the main size (N = 787, P = 76,000)
// the upper triangle is N(N+1)P = 4.7e10 FLOP (f32: 1.4e11 issued as three
// TF32 products) against 239 MB of X in f32, 478 MB in f64, far above the
// card's ridge. What the design does about it:
//   * f32 and bf16 run on the tensor cores (upper_gram_tc.cuh): f32 as
//     three TF32 products per k8 step from a big + small split of each value
//     (f32-grade; the card's TF32 rate is ~7x its f32 SIMT rate), bf16 as one
//     bf16 product; 128 x 128 output tiles, two warpgroups each;
//   * f64 runs on the FP64 tensor cores (upper_gram_dmma.cuh): mma.sync
//     m16n8k8 in f64 (DMMA, twice the f64 SIMT rate; f64 has no wgmma),
//     128 x 128 tiles of eight warps, products past the diagonal or N
//     skipped; f64 products and sums need no split. It runs well below the
//     DMMA peak: the staging (each chunk's cp.async copies and the
//     fragments' shared-memory reads) and the products share the SM and
//     overlap only in part (PERF.md);
//   * only the tiles with j >= i are computed; the reduce pass mirrors them,
//     which halves the operations (and makes G exactly symmetric);
//   * with N this small there are only 28 upper tiles for 132 SMs, so the
//     contraction is split into `splits` ranges run by separate blocks
//     (blockIdx.y), each writing a partial tile to a workspace; a second
//     kernel sums the partials in a fixed order, so results do not depend
//     on scheduling. It is a programmatic dependent launch: its blocks start
//     while the first pass ends and wait for it;
//   * ragged N and P are masked in the loader, so X is never padded or
//     copied on the card.
//
// Types: f32 and f64 accumulate in their own type; bf16 input accumulates
// and writes in f32 (the precision="bf16_gram" build).
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

// G_ij = the partials at the upper-triangle entry of (i, j), summed over the
// splits in a fixed order. One block per pair of mirrored 32 x 32 tiles of
// G (ti <= tj): its threads read the upper tile's sources along rows of the
// workspace, write G there, and write the mirrored tile below the diagonal
// through a shared-memory transpose, so each partial is read once.
// Launched as a programmatic dependent of the first pass: it waits here
// until that pass has finished and its stores are visible.
template <typename TAcc>
__global__ void __launch_bounds__(kReduceTile * kReduceTile)
gram_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ g, int n, int splits) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __shared__ TAcc t[kReduceTile][kReduceTile + 1];
  const int tiles = (n + kReduceTile - 1) / kReduceTile;
  int ti = 0, u = blockIdx.x;   // upper tile pair u → (ti, tj), row by row
  while (u >= tiles - ti) {
    u -= tiles - ti;
    ++ti;
  }
  const int tj = ti + u;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = ti * kReduceTile + ty, j = tj * kReduceTile + tx;
  if (i < n && j < n && i <= j) {
    const TAcc v = ordered_split_sum(ws, upper_triangle_src(i, j, n),
                                     static_cast<size_t>(n) * n, splits);
    g[static_cast<size_t>(i) * n + j] = v;
    t[ty][tx] = v;
  }
  __syncthreads();
  // entry (r, c) below the diagonal is G_cr, computed by thread (tx, ty)
  const int r = tj * kReduceTile + ty, c = ti * kReduceTile + tx;
  if (r < n && c < n && c < r) g[static_cast<size_t>(r) * n + c] = t[tx][ty];
}

template <typename TIn, typename TAcc>
int gram_launch(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  if (n <= 0 || p <= 0 || splits <= 0 || ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if constexpr (std::is_same_v<TIn, double>)
    err = launch_upper_gram_dmma(x, ws, n, p, splits, st);
  else
    err = launch_upper_gram_tc<TIn>(x, ws, n, p, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kReduceTile - 1) / kReduceTile;
  return static_cast<int>(launch_dependent(gram_reduce_kernel<TAcc>, dim3(tiles * (tiles + 1) / 2),
                                           dim3(kReduceTile, kReduceTile), st,
                                           static_cast<const TAcc*>(ws), static_cast<TAcc*>(g), n,
                                           splits));
}

}  // namespace repro

extern "C" {

// ws: (splits, n, n) workspace of the accumulator type; g: (n, n) output. splits: kernels/gram/gram.py
// (tc_gram_splits for f32 and bf16, dmma_gram_splits for f64).
int gram_f32(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<float, float>(x, ws, g, n, p, splits, stream);
}
int gram_f64(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<double, double>(x, ws, g, n, p, splits, stream);
}
int gram_bf16(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  return repro::gram_launch<__nv_bfloat16, float>(x, ws, g, n, p, splits, stream);
}

}  // extern "C"
