// Gram matrix G = X Xᵀ for X (N, P) row-major; the plan build's O(N²P) term.
//
// Replaces the TPU kernel gram_pallas (src/repro/kernels/gram/gram.py,
// body _gram_kernel), which walked the contraction as the innermost,
// sequential grid axis with the accumulator in VMEM.
//
// What bounds it here: operations. At the main size (N = 787, P = 76,000,
// f32) the product is 2N²P = 9.4e10 FLOP against 239 MB of X, about 390
// FLOP per byte, far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20). What the design does about it:
//   * only the tiles with j >= i are computed; the reduce pass mirrors them,
//     which halves the operations (and makes G exactly symmetric);
//   * with N this small there are only ~91 upper tiles for 132 SMs, so the
//     contraction is split into `splits` ranges run by separate blocks
//     (blockIdx.z), each writing a partial tile to a workspace; a second
//     kernel sums the partials in a fixed order, so results do not depend
//     on scheduling (the first pass is upper_gram.cuh, shared with pairdist);
//   * ragged N and P are masked in the tile loader, so X is never padded
//     or copied on the card.
// Tensor cores (bf16 wgmma) and TMA staging are later work; the f32 path
// keeps full f32 products (no TF32), summed in two levels (tile.cuh).
//
// Types: f32 and f64 accumulate in their own type; bf16 input accumulates
// and writes in f32 (the precision="bf16_gram" build).
#include "upper_gram.cuh"

namespace repro {

template <typename TAcc>
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(const TAcc* __restrict__ ws, TAcc* __restrict__ g, int n, int splits) {
  const size_t total = static_cast<size_t>(n) * n;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(idx / n), j = static_cast<int>(idx % n);
    g[idx] = split_sum(ws, upper_src(i, j, n), total, splits);
  }
}

template <typename TIn, typename TAcc>
int gram_launch(const void* x, void* ws, void* g, int n, int p, int splits, void* stream) {
  if (n <= 0 || p <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_upper_gram_partials<TIn, TAcc>(x, ws, n, p, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(n) * n;
  gram_reduce_kernel<TAcc><<<stride_blocks(total), kThreads, 0, st>>>(
      static_cast<const TAcc*>(ws), static_cast<TAcc*>(g), n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

extern "C" {

// ws: (splits, n, n) workspace of the accumulator type; g: (n, n) output.
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
