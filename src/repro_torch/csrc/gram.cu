// Gram matrix G = X Xᵀ for X (N, P) row-major; the plan build's O(N²P) term.
//
// Replaces the TPU kernel gram_pallas (src/repro/kernels/gram/gram.py,
// body _gram_kernel), which walked the contraction as the innermost,
// sequential grid axis with the accumulator in VMEM.
//
// What bounds it here: operations. At the main size (N = 787, P = 76,000,
// f32) the upper triangle is N(N+1)P = 4.7e10 FLOP (1.4e11 issued as three
// TF32 products) against 239 MB of X, far above the card's ridge. What the
// design does about it:
//   * f32 and bf16 run on the tensor cores (upper_gram_tc.cuh): f32 as
//     three TF32 products per k8 step from a big + small split of each value
//     (f32-grade; the card's TF32 rate is ~7x its f32 SIMT rate), bf16 as one
//     bf16 product; 128 x 128 output tiles, two warpgroups each;
//   * only the tiles with j >= i are computed; the reduce pass mirrors them,
//     which halves the operations (and makes G exactly symmetric);
//   * with N this small there are only 28 upper tiles for 132 SMs, so the
//     contraction is split into `splits` ranges run by separate blocks
//     (blockIdx.y), each writing a partial tile to a workspace; a second
//     kernel sums the partials in a fixed order, so results do not depend
//     on scheduling;
//   * ragged N and P are masked in the loader, so X is never padded or
//     copied on the card.
// f64 keeps the SIMT tile (upper_gram.cuh and tile.cuh, 64 x 64 tiles,
// shared with pairdist).
//
// Types: f32 and f64 accumulate in their own type; bf16 input accumulates
// and writes in f32 (the precision="bf16_gram" build).
#include "upper_gram.cuh"
#include "upper_gram_tc.cuh"

namespace repro {

// Offset in one N x N partial of the entry that holds G_ij: the upper
// triangle's own, the mirrored one below it. Every upper tile is computed,
// and the diagonal tiles' lower halves are not read, so G is exactly
// symmetric on both routes.
__device__ __forceinline__ size_t upper_triangle_src(int i, int j, int n) {
  return i <= j ? static_cast<size_t>(i) * n + j : static_cast<size_t>(j) * n + i;
}

template <typename TAcc>
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ g, int n, int splits) {
  const size_t total = static_cast<size_t>(n) * n;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
    g[idx] = split_sum(ws, upper_triangle_src(i, j, n), total, splits);
  }
}

// First pass by route: the tensor cores for f32 and bf16 input, the SIMT
// tile for f64.
template <typename TIn, typename TAcc>
cudaError_t gram_partials(const void* x, void* ws, int n, int p, int splits, cudaStream_t st) {
  if constexpr (std::is_same_v<TIn, double>)
    return launch_upper_gram_partials<TIn, TAcc>(x, ws, n, p, splits, st);
  else
    return launch_upper_gram_tc<TIn>(x, ws, n, p, splits, st);
}

template <typename TIn, typename TAcc>
int gram_launch(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  if (n <= 0 || p <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = gram_partials<TIn, TAcc>(x, ws, n, p, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(n) * n;
  gram_reduce_kernel<TAcc><<<stride_blocks(total), kThreads, 0, st>>>(
      static_cast<const TAcc*>(ws), static_cast<TAcc*>(g), n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// ws: (splits, n, n) workspace of the accumulator type; g: (n, n) output.
// splits: kernels/gram/gram.py (tc_gram_splits for f32 and bf16,
// gram_splits for f64).
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
